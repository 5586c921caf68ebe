"""Unified model API over the ported families, dense and hybrid (port of
``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params tree
    _forward(params, batch, cfg, ...)               -> (logits, cache or kv)
    prefill(params, batch, cfg, max_len)            -> (logits, contiguous cache)
    decode_step(params, tokens, cache, cfg)         -> (logits, cache)
    chunk_prefill_step(params, tokens, counts, cache, cfg) -> (logits, cache)
    init_cache(cfg, batch, max_len)                 -> LMCache or HybridCache
    init_paged_cache(cfg, ...)                      -> PagedKVCache
    cross_entropy(logits, labels, mask)             -> mean next-token NLL
    loss_fn(params, batch, cfg)                     -> (loss, metrics)

The paged cache and chunked prefill need a family with per-slot lengths
(dense) and raise for the hybrid, as in the JAX package. The moe, ssm,
encdec and vlm families come with their slices and raise here.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import hybrid, transformer

__all__ = ["init_params", "prefill", "decode_step", "chunk_prefill_step", "init_cache",
           "init_paged_cache", "cross_entropy", "loss_fn"]

FAMILIES = ("dense", "hybrid")


def _require_ported(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported yet (ported: {FAMILIES})")


def _require_paged(cfg, what: str):
    _require_ported(cfg)
    if cfg.family != "dense":
        raise ValueError(f"{what} needs a KV-cache family, got {cfg.family!r}")


def init_params(cfg, seed: int = 0, device=None) -> dict:
    """Random parameters from a numpy seed, on the card unless ``device``
    says otherwise."""
    _require_ported(cfg)
    init = transformer.init_lm if cfg.family == "dense" else hybrid.init_hybrid
    return init(cfg, seed, resolve_device(device))


def _forward(params, batch: dict, cfg, cache=None, position_offset=0, collect_kv=False):
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return hybrid.forward(params, batch["tokens"], cfg, cache=cache,
                              position_offset=position_offset)
    return transformer.forward(params, batch["tokens"], cfg, cache=cache,
                               position_offset=position_offset, collect_kv=collect_kv)


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


def loss_fn(params, batch: dict, cfg, aux_weight: float = 0.01):
    """Next-token CE plus ``aux_weight`` times the auxiliary loss, which is 0
    for the dense family (the MoE load-balance term comes with that family).
    Returns ``(loss, {"ce": ..., "aux": ...})``."""
    logits, _ = _forward(params, batch, cfg)
    loss = cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


@torch.no_grad()
def prefill(params, batch: dict, cfg, max_len: int, cache_dtype=torch.bfloat16):
    """Full-sequence forward that builds a contiguous decode cache (of
    ``cache_dtype``, bf16 by default as in the JAX package) on the tokens'
    device. Returns ``(logits, cache)``."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    if cfg.family == "hybrid":
        cache = hybrid.init_hybrid_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                                         tokens.device)
        return hybrid.forward(params, tokens, cfg, cache=cache)
    logits, kvs = transformer.forward(params, tokens, cfg, collect_kv=True)
    return logits, transformer.cache_from_prefill(kvs, max_len, cache_dtype)


@torch.no_grad()
def decode_step(params, tokens: torch.Tensor, cache, cfg):
    """One autoregressive step; tokens (B, 1) sit at each slot's length (the
    paged cache's per-slot lengths, or a contiguous cache's one length)."""
    offset = cache.length if isinstance(cache.length, int) else cache.length.long()
    return _forward(params, {"tokens": tokens}, cfg, cache=cache, position_offset=offset)


@torch.no_grad()
def chunk_prefill_step(params, tokens: torch.Tensor, counts: torch.Tensor, cache, cfg):
    """One chunked-prefill step over a (B, C) token chunk at each slot's
    current length. Rows may be ragged: only ``counts[b]`` leading tokens are
    valid and lengths advance by ``counts``; the padded tail writes KV past
    the valid prefix, which is never attended and is overwritten by the next
    real insert. Returns ``(logits (B, C, vocab), new cache)``."""
    _require_paged(cfg, "chunked prefill")
    n0 = cache.length
    logits, new_cache = _forward(params, {"tokens": tokens}, cfg, cache=cache,
                                 position_offset=n0.long())
    return logits, new_cache._replace(length=n0 + counts)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """The family's contiguous decode cache, on the card unless ``device``
    says otherwise."""
    _require_ported(cfg)
    init = transformer.init_cache if cfg.family == "dense" else hybrid.init_hybrid_cache
    return init(cfg, batch, max_len, dtype, resolve_device(device))


def init_paged_cache(cfg, max_slots: int, num_pages: int, block_size: int,
                     pages_per_slot: int, dtype=torch.float32, device=None,
                     quantized: bool = False):
    """Block-paged serving cache; ``quantized`` gives int8 pages with f32
    scale pools."""
    _require_paged(cfg, "paged KV cache")
    return transformer.init_paged_cache(cfg, max_slots, num_pages, block_size,
                                        pages_per_slot, dtype, resolve_device(device),
                                        quantized=quantized)
