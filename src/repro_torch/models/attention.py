"""Attention: GQA projections, RoPE, and the no-cache and paged-cache paths
(port of the dense-Llama part of ``repro/models/attention.py``).

Paths, one set of weights:
  * no cache (``kernel_impl`` dense or blockwise): plain causal masked
    softmax. The blockwise flash-style memory bound and the Pallas flash
    kernel (``kernel_impl='pallas'``, which raises here) come with the flash
    attention slice;
  * paged cache, ``kernel_impl='pallas'``: the CUDA paged kernels
    (``kernels/ops.py``), single-query for decode and k-query for chunks;
  * paged cache otherwise: gather the slot's pages, then masked einsum.

The paged insert updates the page pools IN PLACE: the JAX package donated
the pool buffers to its jitted programs, so no caller held the old pools;
here the engine owns the one pool and every layer writes into its slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF, _gather_pages
from .layers import apply_rope, apply_weight

__all__ = ["PagedLayerCache", "paged_insert", "paged_gather", "dense_attention",
           "attention_block"]


class PagedLayerCache(NamedTuple):
    """One layer's view of a block-paged KV cache.

    Token position j of slot b lives in page ``block_table[b, j // bs]`` at
    offset ``j % bs``. Entries ``>= num_pages`` are unmapped: writes to them
    drop, gathers clamp (the length mask hides what they read).
    """

    k: torch.Tensor            # (num_pages, Hkv, block_size, D) page pool
    v: torch.Tensor
    block_table: torch.Tensor  # (B, pages_per_slot) int32
    length: torch.Tensor       # (B,) int32 valid tokens per slot


def paged_insert(cache: PagedLayerCache, kh: torch.Tensor, vh: torch.Tensor) -> PagedLayerCache:
    """Write t tokens (B, Hkv, t, D) at positions length..length+t-1 of each
    slot, in place. Writes to unmapped pages and to positions past the
    table's capacity (``>= pages_per_slot * bs``) are dropped, as JAX's
    ``mode='drop'`` scatter drops them; ``index_put_`` would not, so the
    dropped rows are masked out explicitly."""
    n, _, bs, _ = cache.k.shape
    nb = cache.block_table.shape[1]
    t = kh.shape[2]
    pos = cache.length.long()[:, None] + torch.arange(t, device=kh.device)[None, :]
    blk = (pos // bs).clamp(0, nb - 1)
    page = torch.gather(cache.block_table.long(), 1, blk)
    keep = (pos < nb * bs) & (page < n)
    page, off = page[keep], (pos % bs)[keep]
    cache.k[page, :, off, :] = kh.transpose(1, 2)[keep].to(cache.k.dtype)
    cache.v[page, :, off, :] = vh.transpose(1, 2)[keep].to(cache.v.dtype)
    return cache._replace(length=cache.length + t)


def paged_gather(cache: PagedLayerCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's logical KV sequence, (B, Hkv, pages_per_slot * bs, D):
    position j here holds what position j of a contiguous cache would."""
    return _gather_pages(cache.k, cache.block_table), _gather_pages(cache.v, cache.block_table)


def dense_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Softmax attention with GQA broadcast, (B, Hq, T, D) x (B, Hkv, S, D)."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", w, v.float()).to(q.dtype)


def attention_block(
    params: dict,
    x: torch.Tensor,                 # (B, T, d_model)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor,         # (1 or B, T)
    rope_theta: float = 1e4,
    cache: PagedLayerCache | None = None,
    kernel_impl: str = "blockwise",
):
    """Projections + RoPE + attention + output projection.

    Without a cache returns ``(out, (kh, vh))`` - the rotated KV heads, so a
    one-shot prefill can fill pages without re-projecting. With a paged cache
    the t new positions are inserted first and query i of slot b attends keys
    ``<= length[b] + i``; returns ``(out, updated layer cache)``.
    """
    b, t, _ = x.shape
    q = apply_weight(x, params["q"]).reshape(b, t, n_heads, head_dim)
    k = apply_weight(x, params["k"]).reshape(b, t, n_kv, head_dim)
    v = apply_weight(x, params["v"]).reshape(b, t, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    qh = q.transpose(1, 2)                # (B, Hq, T, D)
    kh = k.transpose(1, 2)                # (B, Hkv, T, D)
    vh = v.transpose(1, 2)

    if cache is None:
        if kernel_impl == "pallas":
            raise NotImplementedError(
                "attention without a cache under kernel_impl='pallas' needs the "
                "flash attention kernel, ported in a later slice; serve with "
                "chunked prefill (EngineConfig.prefill_chunk) or use "
                "kernel_impl='dense'"
            )
        out = dense_attention(qh, kh, vh, causal=True)
        new_cache = (kh, vh)
    else:
        new_cache = paged_insert(cache, kh, vh)
        if kernel_impl == "pallas":
            if t == 1:
                out = ops.paged_attention(
                    qh[:, :, 0].contiguous(), new_cache.k, new_cache.v,
                    new_cache.block_table, cache.length,
                )[:, :, None]
            else:
                out = ops.paged_attention_kquery(
                    qh.contiguous(), new_cache.k, new_cache.v,
                    new_cache.block_table, cache.length,
                )
        else:
            kg, vg = paged_gather(new_cache)
            group = n_heads // n_kv
            qg = qh.reshape(b, n_kv, group, t, head_dim).float() * (1.0 / math.sqrt(head_dim))
            sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kg.float())
            q_idx = cache.length.long()[:, None] + torch.arange(t, device=x.device)[None, :]
            k_idx = torch.arange(kg.shape[2], device=x.device)
            mask = k_idx[None, None, :] <= q_idx[..., None]            # (B, t, S)
            sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))
            w = torch.softmax(sc, dim=-1)
            out = torch.einsum("bhgts,bhsd->bhgtd", w, vg.float())
            out = out.reshape(b, n_heads, t, head_dim).to(x.dtype)

    out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    return apply_weight(out, params["o"]), new_cache
