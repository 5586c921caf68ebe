"""Attention: GQA projections, RoPE, and the no-cache, contiguous-cache and
paged-cache paths (port of ``repro/models/attention.py``).

Paths, one set of weights:
  * no cache, ``kernel_impl='pallas'``: the CUDA flash attention kernel
    (``kernels/ops.py``), causal, forward only: it has no backward (nor has
    the Pallas kernel), so asking for gradients through it raises;
  * no cache, ``kernel_impl='blockwise'``: the flash forward and backward in
    PyTorch (``models/flash_vjp.py``), the JAX trainer's path;
  * no cache, ``kernel_impl='dense'``: plain causal masked softmax;
  * paged cache, ``kernel_impl='pallas'``: the CUDA paged kernels
    (``kernels/ops.py``), single-query for decode and k-query for chunks
    and verify windows, over the pages they take
    (``kernels/paged_attention.py::takes_pages``: the model's dtype, or bf16
    pages under an f32 model; the engines refuse any other float pages under
    ``'pallas'`` when they are built);
  * paged cache otherwise, and int8 pages under any ``kernel_impl`` (as in
    the JAX package, whose Pallas path needs ``k_scale is None``): gather the
    slot's pages (dequantized), then masked einsum;
  * contiguous cache (``KVCache``) with one host length for the batch (the
    reference engine's and the hybrid's): the t new positions insert at the
    length; t == 1 attends by masked einsum, t > 1 (prefill into a cache)
    through ``models/flash_vjp.py`` with the causal offset at the length, as
    the JAX package's path does;
  * contiguous cache with per-slot ``(B,)`` lengths (the slot-padded
    ``ServingEngine``'s): row b's t positions insert at ``length[b]``
    (``contiguous_insert``: positions past the buffer drop, as JAX's
    ``mode='drop'`` scatter drops them) and query i of row b attends keys
    ``<= length[b] + i`` by masked einsum (the JAX package takes its
    blockwise path for t > 1; the engines never insert more than one token
    per row into this cache).

Both inserts update the caches IN PLACE: the JAX package donated the cache
buffers to its jitted programs, so no caller held the old ones; here the
engine owns the one cache and every layer writes into its slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.paged_attention import takes_pages
from ..kernels.ref import NEG_INF, _gather_pages, attention_ref
from ..serving.kv_quant import quantize_kv
from .flash_vjp import flash_attention_vjp
from .layers import apply_rope, apply_weight

__all__ = ["KVCache", "PagedLayerCache", "contiguous_insert", "paged_insert", "paged_gather",
           "attention_block"]


class KVCache(NamedTuple):
    """One layer's contiguous KV cache: positions 0 .. length - 1 of every
    row are valid. ``length`` is a host integer (the caller keeps it), or a
    (B,) int32 tensor of per-slot lengths on the cache's device."""

    k: torch.Tensor   # (B, Hkv, S, D)
    v: torch.Tensor
    length: int | torch.Tensor


def contiguous_insert(cache: KVCache, kh: torch.Tensor, vh: torch.Tensor) -> KVCache:
    """Write t tokens (B, Hkv, t, D) at positions length[b] .. length[b] +
    t - 1 of each row of a per-slot cache, in place; positions ``>= S`` are
    dropped, as JAX's ``mode='drop'`` scatter drops them. No host sync: a
    dropped position is aimed at the row's last position S - 1 with the
    value S - 1 ends up holding (its own write where one lands there, else
    what it held), so every write to one position carries one value and the
    scatter's order cannot matter. Returns the cache at ``length + t``."""
    s = cache.k.shape[2]
    t = kh.shape[2]
    n0 = cache.length.long()
    pos = n0[:, None] + torch.arange(t, device=kh.device)[None, :]     # (B, t)
    keep = pos < s
    idx = torch.where(keep, pos, torch.full_like(pos, s - 1))
    at_last = s - 1 - n0                                               # (B,): i landing at S - 1
    lands = ((at_last >= 0) & (at_last < t))[:, None, None]
    for pool, new in ((cache.k, kh), (cache.v, vh)):
        new = new.to(pool.dtype)
        b, h, _, d = new.shape
        mine = torch.gather(new, 2, at_last.clamp(0, t - 1)[:, None, None, None]
                            .expand(b, h, 1, d))[:, :, 0]
        last = torch.where(lands, mine, pool[:, :, s - 1])            # (B, Hkv, D)
        val = torch.where(keep[:, None, :, None], new, last[:, :, None, :])
        pool.scatter_(2, idx[:, None, :, None].expand(b, h, t, d), val)
    return cache._replace(length=cache.length + t)


class PagedLayerCache(NamedTuple):
    """One layer's view of a block-paged KV cache.

    Token position j of slot b lives in page ``block_table[b, j // bs]`` at
    offset ``j % bs``. Entries ``>= num_pages`` are unmapped: writes to them
    drop, gathers clamp (the length mask hides what they read). With
    ``k_scale``/``v_scale`` the payload pools are int8, dequantized per
    (position, head): the ``serving/kv_quant.py`` layout.
    """

    k: torch.Tensor            # (num_pages, Hkv, block_size, D) page pool
    v: torch.Tensor
    block_table: torch.Tensor  # (B, pages_per_slot) int32
    length: torch.Tensor       # (B,) int32 valid tokens per slot
    k_scale: torch.Tensor | None = None   # (num_pages, Hkv, block_size, 1) f32
    v_scale: torch.Tensor | None = None


def paged_insert(cache: PagedLayerCache, kh: torch.Tensor, vh: torch.Tensor) -> PagedLayerCache:
    """Write t tokens (B, Hkv, t, D) at positions length..length+t-1 of each
    slot, in place. Writes to unmapped pages and to positions past the
    table's capacity (``>= pages_per_slot * bs``) are dropped, as JAX's
    ``mode='drop'`` scatter drops them; ``index_put_`` would not, so the
    dropped rows are masked out explicitly. Int8 pools take each (position,
    head) row quantized, its scale into the scale pools."""
    n, _, bs, _ = cache.k.shape
    nb = cache.block_table.shape[1]
    t = kh.shape[2]
    pos = cache.length.long()[:, None] + torch.arange(t, device=kh.device)[None, :]
    blk = (pos // bs).clamp(0, nb - 1)
    page = torch.gather(cache.block_table.long(), 1, blk)
    keep = (pos < nb * bs) & (page < n)
    page, off = page[keep], (pos % bs)[keep]
    k_tok, v_tok = kh.transpose(1, 2)[keep], vh.transpose(1, 2)[keep]   # (kept, Hkv, D)
    if cache.k_scale is not None:
        for tok, pool, scales in ((k_tok, cache.k, cache.k_scale),
                                  (v_tok, cache.v, cache.v_scale)):
            q, sc = quantize_kv(tok)
            pool[page, :, off, :] = q
            scales[page, :, off, :] = sc
    else:
        cache.k[page, :, off, :] = k_tok.to(cache.k.dtype)
        cache.v[page, :, off, :] = v_tok.to(cache.v.dtype)
    return cache._replace(length=cache.length + t)


def paged_gather(cache: PagedLayerCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's logical KV sequence, (B, Hkv, pages_per_slot * bs, D):
    position j here holds what position j of a contiguous cache would; int8
    pages come back dequantized in f32."""
    def gather(pages, scales):
        g = _gather_pages(pages, cache.block_table)
        if scales is not None:
            g = g.float() * _gather_pages(scales, cache.block_table)
        return g

    return gather(cache.k, cache.k_scale), gather(cache.v, cache.v_scale)


def attention_block(
    params: dict,
    x: torch.Tensor,                 # (B, T, d_model)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor,         # (1 or B, T)
    rope_theta: float = 1e4,
    cache: PagedLayerCache | KVCache | None = None,
    kernel_impl: str = "blockwise",
    q_block: int = 512,
    kv_block: int = 1024,
):
    """Projections + RoPE + attention + output projection. The four
    projections get (B, T, .) activations, unflattened, so a batched adapter
    site (``serving/adapters.py``) can pick each slot's tables.

    Without a cache returns ``(out, (kh, vh))`` - the rotated KV heads, so a
    one-shot prefill can fill pages without re-projecting. With a paged cache
    the t new positions are inserted first and query i of slot b attends keys
    ``<= length[b] + i``; returns ``(out, updated layer cache)``. A
    contiguous cache does the same at its one length or at each row's.
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
            if torch.is_grad_enabled() and any(t.requires_grad for t in (qh, kh, vh)):
                raise NotImplementedError(
                    "the CUDA flash attention kernel (kernel_impl='pallas') has no "
                    "backward; train with kernel_impl='blockwise'")
            out = ops.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                      causal=True)
        elif kernel_impl == "dense":
            out = attention_ref(qh, kh, vh, causal=True)
        else:
            out = flash_attention_vjp(qh, kh, vh, True, q_block, kv_block)
        new_cache = (kh, vh)
    elif isinstance(cache, KVCache) and isinstance(cache.length, torch.Tensor):
        new_cache = contiguous_insert(cache, kh, vh)
        q_idx = cache.length.long()[:, None] + torch.arange(t, device=x.device)[None, :]
        out = _masked_attention(qh, new_cache.k, new_cache.v, q_idx, n_heads, n_kv,
                                head_dim).to(x.dtype)
    elif isinstance(cache, KVCache):
        n0 = int(cache.length)
        cache.k[:, :, n0:n0 + t] = kh.to(cache.k.dtype)
        cache.v[:, :, n0:n0 + t] = vh.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, n0 + t)
        if t > 1:
            out = flash_attention_vjp(qh, cache.k, cache.v, True, q_block, kv_block,
                                      causal_offset=n0)
        else:
            out = _masked_attention(qh, cache.k, cache.v,
                                    torch.full((b, 1), n0, device=x.device), n_heads, n_kv,
                                    head_dim).to(x.dtype)
    else:
        new_cache = paged_insert(cache, kh, vh)
        if kernel_impl == "pallas" and takes_pages(qh.dtype, cache.k.dtype):
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
            q_idx = cache.length.long()[:, None] + torch.arange(t, device=x.device)[None, :]
            out = _masked_attention(qh, kg, vg, q_idx, n_heads, n_kv, head_dim).to(x.dtype)

    out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    return apply_weight(out, params["o"]), new_cache


def _masked_attention(qh, kh, vh, q_idx, n_heads: int, n_kv: int, head_dim: int):
    """O(t * S) attention in f32: query i of row b (at position
    ``q_idx[b, i]``) attends keys ``<= q_idx[b, i]`` of kh/vh (B, Hkv, S, D)."""
    b, _, t, _ = qh.shape
    group = n_heads // n_kv
    qg = qh.reshape(b, n_kv, group, t, head_dim).float() * (1.0 / math.sqrt(head_dim))
    sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kh.float())
    k_idx = torch.arange(kh.shape[2], device=qh.device)
    mask = k_idx[None, None, :] <= q_idx[..., None]            # (B, t, S)
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", w, vh.float())
    return out.reshape(b, n_heads, t, head_dim)
