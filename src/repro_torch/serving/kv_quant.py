"""int8 KV quantization (port of ``repro/serving/kv_quant.py``).

Per-(head, position) symmetric int8 over head_dim: each K or V row keeps one
f32 scale (``amax / 127 + 1e-12``), so appending a token never re-scales the
history. Halves the pages against bf16 and quarters them against f32; the
paged engine's ``kv_dtype='int8'`` pools (``models/transformer.py``) use
this quantizer, dequantizing in the page gather.

Layout mirrors ``LMCache``: the q8 payload (L, B, H, S, D) int8 and the
scales (L, B, H, S, 1) f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantKVCache", "quantize_kv", "dequantize_kv", "quantize_cache",
           "dequantize_cache", "append_token", "cache_bytes"]


class QuantKVCache(NamedTuple):
    k_q: torch.Tensor       # (L, B, H, S, D) int8
    k_scale: torch.Tensor   # (L, B, H, S, 1) f32
    v_q: torch.Tensor
    v_scale: torch.Tensor
    length: int


def quantize_kv(k: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``dim`` (head_dim), rounding half to even as
    ``jnp.round`` does. Returns ``(q, scale)``."""
    kf = k.float()
    scale = kf.abs().amax(dim=dim, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_cache(cache) -> QuantKVCache:
    """LMCache -> QuantKVCache."""
    k_q, k_s = quantize_kv(cache.k)
    v_q, v_s = quantize_kv(cache.v)
    return QuantKVCache(k_q, k_s, v_q, v_s, cache.length)


def dequantize_cache(qc: QuantKVCache, dtype=torch.bfloat16):
    from ..models.transformer import LMCache

    return LMCache(k=dequantize_kv(qc.k_q, qc.k_scale, dtype),
                   v=dequantize_kv(qc.v_q, qc.v_scale, dtype), length=qc.length)


def append_token(qc: QuantKVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> QuantKVCache:
    """Write a (L, B, H, t, D) step at position ``length``, in place (the
    history is untouched: per-token scales), and return the cache with the
    length advanced."""
    at, t = int(qc.length), k_new.shape[3]
    for new, payload, scale in ((k_new, qc.k_q, qc.k_scale), (v_new, qc.v_q, qc.v_scale)):
        q, s = quantize_kv(new)
        payload[:, :, :, at:at + t] = q
        scale[:, :, :, at:at + t] = s
    return qc._replace(length=at + t)


def cache_bytes(cache) -> int:
    """Bytes of every tensor the cache holds (None fields count nothing)."""
    return sum(x.numel() * x.element_size() for x in cache if isinstance(x, torch.Tensor))
