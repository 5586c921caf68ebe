"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``).

They run on any device. The kernel wrappers take them for CPU tensors, the
tests hold them against the JAX package's Pallas kernels, and
``chip_smoke.py`` holds each CUDA kernel against them on the card. Nothing on
the main path calls them when a card is present.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

__all__ = [
    "lowrank_matmul_ref",
    "slr_matmul_ref",
    "slr_matmul_stacked_ref",
    "paged_attention_ref",
    "paged_attention_kquery_ref",
]


def lowrank_matmul_ref(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    return (x.float() @ p.float() @ vt.float()).to(x.dtype)


def slr_matmul_ref(x: torch.Tensor, p, vt, bsr=None) -> torch.Tensor:
    """y = x @ P @ Vt + x @ S with both terms in one f32 accumulator and one
    cast to x.dtype (the fused kernel's numerics)."""
    from .bsr_matmul import bsr_to_dense

    xf = x.float()
    m = vt.shape[-1] if vt is not None else bsr.shape[1]
    acc = torch.zeros((x.shape[0], m), dtype=torch.float32, device=x.device)
    if p is not None and p.shape[-1] > 0:
        acc = acc + xf @ p.float() @ vt.float()
    if bsr is not None and not bsr.empty:
        acc = acc + xf @ bsr_to_dense(bsr).float()
    return acc.to(x.dtype)


def slr_matmul_stacked_ref(x: torch.Tensor, p, vt, stack, layer: int) -> torch.Tensor:
    """Layer ``layer`` of every stacked table, then ``slr_matmul_ref``."""
    bsr = None if stack is None or stack.empty else stack.at_layer(layer)
    return slr_matmul_ref(x, None if p is None else p[layer],
                          None if vt is None else vt[layer], bsr)


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, bs, D) pool + (B, nb) table -> (B, Hkv, nb * bs, D); unmapped
    entries clamp to the last page (the length mask hides them)."""
    n = pages.shape[0]
    g = pages[table.long().clamp_max(n - 1)]          # (B, nb, Hkv, bs, D)
    b, nb, h, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, nb * bs, d)


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths) -> torch.Tensor:
    """Single-query decode attention through the block table: the query of
    slot b sits at ``lengths[b]`` and sees keys at positions <= lengths[b].
    q (B, Hq, D) -> (B, Hq, D)."""
    return paged_attention_kquery_ref(q[:, :, None], k_pages, v_pages,
                                      block_table, lengths)[:, :, 0]


def paged_attention_kquery_ref(q, k_pages, v_pages, block_table, lengths) -> torch.Tensor:
    """kq queries per slot at ``lengths[b] .. lengths[b] + kq - 1``; query i
    sees keys at positions <= lengths[b] + i. Tiling-free by design.
    q (B, Hq, kq, D) -> (B, Hq, kq, D)."""
    _, hkv, _, d = k_pages.shape
    b, hq, kq, _ = q.shape
    group = hq // hkv
    k = _gather_pages(k_pages, block_table).float()
    v = _gather_pages(v_pages, block_table).float()
    s = k.shape[2]
    qg = q.reshape(b, hkv, group, kq, d).float() * (1.0 / math.sqrt(d))
    sc = torch.einsum("bhgqd,bhsd->bhgqs", qg, k)
    q_pos = lengths.long()[:, None] + torch.arange(kq, device=q.device)[None, :]
    mask = torch.arange(s, device=q.device)[None, None, :] <= q_pos[:, :, None]
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bhgqd", w, v)
    return out.reshape(b, hq, kq, d).to(q.dtype)
