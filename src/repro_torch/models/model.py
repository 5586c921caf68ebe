"""Unified model API, dense family only (port of the serving part of
``repro/models/model.py``).

    init_params(cfg, seed, device)                  -> params tree
    _forward(params, batch, cfg, ...)               -> (logits, cache or kv)
    decode_step(params, tokens, cache, cfg)         -> (logits, cache)
    chunk_prefill_step(params, tokens, counts, cache, cfg) -> (logits, cache)
    init_paged_cache(cfg, ...)                      -> PagedKVCache

The moe, ssm, hybrid, encdec and vlm families come with their slices and
raise here.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import transformer

__all__ = ["init_params", "decode_step", "chunk_prefill_step", "init_paged_cache"]


def _require_dense(cfg):
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet (dense only)")


def init_params(cfg, seed: int = 0, device=None) -> dict:
    """Random parameters from a numpy seed, on the card unless ``device``
    says otherwise."""
    _require_dense(cfg)
    return transformer.init_lm(cfg, seed, resolve_device(device))


def _forward(params, batch: dict, cfg, cache=None, position_offset=0, collect_kv=False):
    _require_dense(cfg)
    return transformer.forward(params, batch["tokens"], cfg, cache=cache,
                               position_offset=position_offset, collect_kv=collect_kv)


@torch.no_grad()
def decode_step(params, tokens: torch.Tensor, cache, cfg):
    """One autoregressive step; tokens (B, 1) sit at each slot's length."""
    return _forward(params, {"tokens": tokens}, cfg, cache=cache,
                    position_offset=cache.length.long())


@torch.no_grad()
def chunk_prefill_step(params, tokens: torch.Tensor, counts: torch.Tensor, cache, cfg):
    """One chunked-prefill step over a (B, C) token chunk at each slot's
    current length. Rows may be ragged: only ``counts[b]`` leading tokens are
    valid and lengths advance by ``counts``; the padded tail writes KV past
    the valid prefix, which is never attended and is overwritten by the next
    real insert. Returns ``(logits (B, C, vocab), new cache)``."""
    n0 = cache.length
    logits, new_cache = _forward(params, {"tokens": tokens}, cfg, cache=cache,
                                 position_offset=n0.long())
    return logits, new_cache._replace(length=n0 + counts)


def init_paged_cache(cfg, max_slots: int, num_pages: int, block_size: int,
                     pages_per_slot: int, dtype=torch.float32, device=None):
    _require_dense(cfg)
    return transformer.init_paged_cache(cfg, max_slots, num_pages, block_size,
                                        pages_per_slot, dtype, resolve_device(device))
