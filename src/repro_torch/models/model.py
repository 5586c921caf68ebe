"""Unified model API over every family (port of ``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params tree
    _forward(params, batch, cfg, ...)               -> (logits, cache or kv)
    _family_forward(params, batch, cfg, ...)        -> (logits, cache or kv, aux)
    prefill(params, batch, cfg, max_len)            -> (logits, contiguous cache)
    decode_step(params, tokens, cache, cfg)         -> (logits, cache)
    chunk_prefill_step(params, tokens, counts, cache, cfg) -> (logits, cache)
    init_cache(cfg, batch, max_len, per_slot=False) -> the family's cache
    init_paged_cache(cfg, ...)                      -> PagedKVCache
    input_specs(cfg, shape, per_host)               -> {name: TensorSpec}
    cross_entropy(logits, labels, mask)             -> mean next-token NLL
    loss_fn(params, batch, cfg)                     -> (loss, metrics)

Families: dense, moe and vlm (``models/transformer.py``), ssm
(``models/ssm_lm.py``), hybrid (``models/hybrid.py``) and encdec
(``models/encdec.py``). The modality frontends are stubs, as in the JAX
package: ``batch["patches"]`` (VLM) and ``batch["frames"]`` (encdec) carry
the precomputed embeddings. The paged cache, chunked prefill and per-slot
caches need a family with per-slot lengths (dense, moe, vlm) and raise for
the others, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import encdec, hybrid, ssm_lm, transformer

__all__ = ["FAMILIES", "KV_FAMILIES", "TensorSpec", "init_params", "prefill", "decode_step",
           "chunk_prefill_step", "init_cache", "init_paged_cache", "input_specs",
           "cross_entropy", "loss_fn"]

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
KV_FAMILIES = ("dense", "moe", "vlm")   # caches with per-slot lengths


def _require_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (families: {FAMILIES})")


def _require_paged(cfg, what: str):
    _require_family(cfg)
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"{what} needs a KV-cache family, got {cfg.family!r}")


def init_params(cfg, seed: int = 0, device=None) -> dict:
    """Random parameters from a numpy seed, on the card unless ``device``
    says otherwise."""
    _require_family(cfg)
    init = {"ssm": ssm_lm.init_ssm_lm, "hybrid": hybrid.init_hybrid,
            "encdec": encdec.init_encdec}.get(cfg.family, transformer.init_lm)
    return init(cfg, seed, resolve_device(device))


def _family_forward(params, batch: dict, cfg, cache=None, position_offset=0,
                    collect_kv=False, drops=None, rows=None):
    """The JAX package's ``_forward``: (logits, new cache or stacked KV
    heads, aux loss). Without a cache the encdec family's second value is
    its encoder output, the others' None unless ``collect_kv`` (the
    transformer families' prefill heads). ``drops`` (a
    ``moe.DropCounter``) counts the pairs the MoE capacity dropped; ``rows``
    (a data-parallel train step's ``BatchShard``) are the transformer
    families' rows of the global batch."""
    _require_family(cfg)
    tokens = batch["tokens"]
    if cfg.family in KV_FAMILIES:
        return transformer.forward(params, tokens, cfg, prefix_embeds=batch.get("patches"),
                                   cache=cache, position_offset=position_offset,
                                   collect_kv=collect_kv, drops=drops, rows=rows)
    if cfg.family == "ssm":
        return ssm_lm.forward(params, tokens, cfg, cache=cache, position_offset=position_offset)
    if cfg.family == "encdec":
        return encdec.forward(params, tokens, cfg, frames=batch.get("frames"), cache=cache,
                              position_offset=position_offset)
    logits, new = hybrid.forward(params, tokens, cfg, cache=cache,
                                 position_offset=position_offset)
    return logits, new, torch.zeros((), device=logits.device)


def _forward(params, batch: dict, cfg, cache=None, position_offset=0, collect_kv=False,
             drops=None):
    """(logits, new cache or stacked KV heads): ``_family_forward`` without
    the aux loss."""
    return _family_forward(params, batch, cfg, cache, position_offset, collect_kv, drops)[:2]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood in f32, over ``mask`` where
    given (the JAX package's max-shifted log-sum-exp; the gold logit comes
    from a gather, which equals its masked reduction)."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    shifted = logits - m
    logz = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    gold = torch.gather(shifted, -1, labels.long()[..., None])[..., 0] + m[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def loss_fn(params, batch: dict, cfg, aux_weight: float = 0.01, rows=None):
    """Next-token CE plus ``aux_weight`` times the MoE load-balance loss (0
    for the other families); the VLM's loss covers the text tail only.
    ``rows``: the data-parallel train step's share of the global batch.
    Returns ``(loss, {"ce": ..., "aux": ...})``."""
    logits, _, aux = _family_forward(params, batch, cfg, rows=rows)
    if cfg.family == "vlm" and "patches" in batch:
        logits = logits[:, batch["patches"].shape[1]:]
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


@torch.no_grad()
def prefill(params, batch: dict, cfg, max_len: int, cache_dtype=torch.bfloat16, drops=None):
    """Full-sequence forward that builds a contiguous decode cache (of
    ``cache_dtype``, bf16 by default as in the JAX package; the encdec cache
    is bf16 whatever it says, as the JAX package builds it) on the tokens'
    device. Returns ``(logits, cache)``."""
    _require_family(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    if cfg.family == "hybrid":
        cache = hybrid.init_hybrid_cache(cfg, b, max_len, cache_dtype, tokens.device)
        return hybrid.forward(params, tokens, cfg, cache=cache)
    if cfg.family == "ssm":
        cache = ssm_lm.init_ssm_lm_cache(cfg, b, cache_dtype, tokens.device)
        logits, new_cache, _ = ssm_lm.forward(params, tokens, cfg, cache=cache)
        return logits, new_cache
    if cfg.family == "encdec":
        # the JAX package builds this cache in bf16 whatever cache_dtype says
        enc_out = encdec.encode(params, batch["frames"], cfg)
        cache = encdec.init_encdec_cache(params, cfg, b, max_len, enc_out=enc_out)
        return encdec.decode_stack(params, tokens, None, cfg, cache=cache)
    logits, kvs, _ = transformer.forward(params, tokens, cfg,
                                         prefix_embeds=batch.get("patches"), collect_kv=True,
                                         drops=drops)
    return logits, transformer.cache_from_prefill(kvs, max_len, cache_dtype)


@torch.no_grad()
def decode_step(params, tokens: torch.Tensor, cache, cfg, drops=None):
    """One autoregressive step; tokens (B, 1) sit at each slot's length (the
    paged cache's per-slot lengths, a contiguous cache's one length, or its
    per-slot (B,) lengths: there a row at the buffer's end drops its write)."""
    offset = cache.length if isinstance(cache.length, int) else cache.length.long()
    return _forward(params, {"tokens": tokens}, cfg, cache=cache, position_offset=offset,
                    drops=drops)


@torch.no_grad()
def chunk_prefill_step(params, tokens: torch.Tensor, counts: torch.Tensor, cache, cfg,
                       drops=None):
    """One chunked-prefill step over a (B, C) token chunk at each slot's
    current length. Rows may be ragged: only ``counts[b]`` leading tokens are
    valid and lengths advance by ``counts``; the padded tail writes KV past
    the valid prefix, which is never attended and is overwritten by the next
    real insert. Returns ``(logits (B, C, vocab), new cache)``."""
    _require_paged(cfg, "chunked prefill")
    n0 = cache.length
    logits, new_cache = _forward(params, {"tokens": tokens}, cfg, cache=cache,
                                 position_offset=n0.long(), drops=drops)
    return logits, new_cache._replace(length=n0 + counts)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               per_slot: bool = False):
    """The family's contiguous decode cache, on the card unless ``device``
    says otherwise. ``per_slot`` gives the transformer cache (batch,) lengths,
    one per serving slot (the slot-padded engine's); the other families have
    none, as in the JAX package. The encdec cache's cross heads are zeros
    (no encoder output), as the JAX package's reference engine builds it."""
    _require_family(cfg)
    dev = resolve_device(device)
    if per_slot:
        _require_paged(cfg, "a per-slot cache")
        return transformer.init_cache(cfg, batch, max_len, dtype, dev, per_slot=True)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid_cache(cfg, batch, max_len, dtype, dev)
    if cfg.family == "ssm":
        return ssm_lm.init_ssm_lm_cache(cfg, batch, dtype, dev)
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(None, cfg, batch, max_len, dtype=dtype, device=dev)
    return transformer.init_cache(cfg, batch, max_len, dtype, dev)


def init_paged_cache(cfg, max_slots: int, num_pages: int, block_size: int,
                     pages_per_slot: int, dtype=torch.float32, device=None,
                     quantized: bool = False):
    """Block-paged serving cache; ``quantized`` gives int8 pages with f32
    scale pools."""
    _require_paged(cfg, "paged KV cache")
    return transformer.init_paged_cache(cfg, max_slots, num_pages, block_size,
                                        pages_per_slot, dtype, resolve_device(device),
                                        quantized=quantized)


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the JAX package's
    ``ShapeDtypeStruct`` stand-in)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg, shape, per_host: int | None = None) -> dict[str, TensorSpec]:
    """Stand-ins for every model input of a cell: train/prefill give
    tokens, labels and the stub frontend's frames or patches; decode gives
    one token per row (the cache's shapes come from ``init_cache``)."""
    b = per_host or shape.global_batch
    t = shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), i32)}
    specs = {"tokens": TensorSpec((b, t), i32), "labels": TensorSpec((b, t), i32)}
    if cfg.family == "encdec":
        specs["frames"] = TensorSpec((b, cfg.encoder_seq, cfg.d_model), cfg.param_dtype)
    if cfg.family == "vlm":
        specs["patches"] = TensorSpec((b, cfg.num_patches, cfg.d_model), cfg.param_dtype)
    return specs
