"""Attention: GQA projections, RoPE, and the no-cache, contiguous-cache and
paged-cache paths (port of ``repro/models/attention.py``).

Paths, one set of weights:
  * no cache, ``kernel_impl='pallas'``: the CUDA flash attention kernel
    (``kernels/ops.py``), causal or not (the encoder, cross-attention),
    forward only: it has no backward (nor has the Pallas kernel), so asking
    for gradients through it raises;
  * no cache, ``kernel_impl='blockwise'``: the flash forward and backward in
    PyTorch (``models/flash_vjp.py``), the JAX trainer's path;
  * no cache, ``kernel_impl='dense'``: plain masked softmax;
  * cross-attention (``kv_override``): the no-cache paths over the given
    heads, with or without a cache (which passes through untouched);
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


def _proj(x, w, b=None):
    y = apply_weight(x, w)
    return y if b is None else y + b


def attention_block(
    params: dict,
    x: torch.Tensor,                 # (B, T, d_model)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor | None = None,   # (1 or B, T)
    rope_theta: float | None = 1e4,
    causal: bool = True,
    cache: PagedLayerCache | KVCache | None = None,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
    kernel_impl: str = "blockwise",
    q_block: int = 512,
    kv_block: int = 1024,
    causal_scheme: str = "full",
    rows=None,
):
    """Projections (with the q/k/v biases where the tree has them) + RoPE
    (none for ``rope_theta=None``) + attention + output projection. The
    four projections get (B, T, .) activations, unflattened, so a batched
    adapter site (``serving/adapters.py``) can pick each slot's tables.

    Without a cache returns ``(out, (kh, vh))`` - the rotated KV heads, so a
    one-shot prefill can fill pages without re-projecting. With a paged cache
    the t new positions are inserted first and query i of slot b attends keys
    ``<= length[b] + i``; returns ``(out, updated layer cache)``. A
    contiguous cache does the same at its one length or at each row's.
    ``kv_override`` (cross-attention) supplies the (B, Hkv, S, D) heads: no
    key or value projection, no cache insert (the cache passes through), and
    the no-cache paths attend them (non-causal for the encoder-decoder).
    ``causal_scheme`` picks the flash forward of the no-cache blockwise path
    (``models/flash_vjp.py``), as in the JAX package.

    ``rows`` (a ``parallel.sharding.RowSplit``) says that x holds this rank's
    share of the cache's rows: the new K/V rows are gathered from the data
    column and inserted whole, and the queries attend through their own rows
    of the cache's block table, lengths or buffers.
    """
    b, t, _ = x.shape
    q = _proj(x, params["q"], params.get("q_bias")).reshape(b, t, n_heads, head_dim)
    if kv_override is not None:
        kh, vh = kv_override
    else:
        k = _proj(x, params["k"], params.get("k_bias")).reshape(b, t, n_kv, head_dim)
        v = _proj(x, params["v"], params.get("v_bias")).reshape(b, t, n_kv, head_dim)
        if positions is None:
            positions = torch.arange(t, device=x.device)[None, :]
        if rope_theta is not None:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        kh = k.transpose(1, 2)            # (B, Hkv, T, D)
        vh = v.transpose(1, 2)
    qh = q.transpose(1, 2)                # (B, Hq, T, D)
    own = (lambda t: t) if rows is None else rows.take
    if rows is not None and cache is not None and kv_override is None:
        kh, vh = rows.gather(torch.stack([kh, vh]), dim=1).unbind(0)   # one collective

    if cache is None or kv_override is not None:
        if kernel_impl == "pallas":
            if torch.is_grad_enabled() and any(t.requires_grad for t in (qh, kh, vh)):
                raise NotImplementedError(
                    "the CUDA flash attention kernel (kernel_impl='pallas') has no "
                    "backward; train with kernel_impl='blockwise'")
            # the kernel masks ragged T and S itself (the encoder's 1500 frames)
            out = ops.flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                      causal=causal, any_length=True)
        elif kernel_impl == "dense":
            out = attention_ref(qh, kh, vh, causal=causal)
        else:
            out = flash_attention_vjp(qh, kh, vh, causal, q_block, kv_block,
                                      scheme=causal_scheme)
        new_cache = cache if kv_override is not None else (kh, vh)
    elif isinstance(cache, KVCache) and isinstance(cache.length, torch.Tensor):
        new_cache = contiguous_insert(cache, kh, vh)
        q_idx = own(cache.length).long()[:, None] + torch.arange(t, device=x.device)[None, :]
        out = _masked_attention(qh, own(new_cache.k), own(new_cache.v), q_idx, n_heads, n_kv,
                                head_dim).to(x.dtype)
    elif isinstance(cache, KVCache):
        n0 = int(cache.length)
        cache.k[:, :, n0:n0 + t] = kh.to(cache.k.dtype)
        cache.v[:, :, n0:n0 + t] = vh.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, n0 + t)
        if t > 1:
            out = flash_attention_vjp(qh, own(cache.k), own(cache.v), True, q_block, kv_block,
                                      causal_offset=n0)
        else:
            out = _masked_attention(qh, own(cache.k), own(cache.v),
                                    torch.full((b, 1), n0, device=x.device), n_heads, n_kv,
                                    head_dim).to(x.dtype)
    else:
        new_cache = paged_insert(cache, kh, vh)
        table, lengths = own(new_cache.block_table), own(cache.length)
        if kernel_impl == "pallas" and takes_pages(qh.dtype, cache.k.dtype):
            if t == 1:
                out = ops.paged_attention(
                    qh[:, :, 0].contiguous(), new_cache.k, new_cache.v, table, lengths,
                )[:, :, None]
            else:
                out = ops.paged_attention_kquery(
                    qh.contiguous(), new_cache.k, new_cache.v, table, lengths,
                )
        else:
            kg, vg = paged_gather(new_cache._replace(block_table=table))
            q_idx = lengths.long()[:, None] + torch.arange(t, device=x.device)[None, :]
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
