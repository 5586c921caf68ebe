"""Paged attention over a block-table KV pool: single-query decode and
k-query (port of ``repro/kernels/paged_attention.py``).

The pool is ``(num_pages, Hkv, bs, D)`` per layer; slot b's position j lives
in page ``block_table[b, j // bs]`` at offset ``j % bs``. Entries
``>= num_pages`` are unmapped: they clamp to the last page and the length
mask hides whatever they hold. Query i of slot b sits at ``lengths[b] + i``
(its KV already inserted) and sees keys at positions <= ``lengths[b] + i``.

Both wrappers run the plain version for CPU tensors and the CUDA kernel
``csrc/paged_attention.cu`` for CUDA tensors.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch

__all__ = ["paged_attention", "paged_attention_kquery", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256


def _check(name, q, k_pages, v_pages, block_table, lengths, kq):
    dev = check_cuda(name, q=q, k_pages=k_pages, v_pages=v_pages,
                     block_table=block_table, lengths=lengths)
    code = dtype_code(q.dtype)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q and the pools must share one dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and lengths must be int32")
    n, hkv, bs, d = k_pages.shape
    b, hq = q.shape[:2]
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"{name}: k/v pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    if q.shape[-1] != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)} (head dim, GQA grouping)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if block_table.dim() != 2 or block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    if b == 0 or kq == 0:
        raise ValueError(f"{name}: empty batch or query window")
    return dev, code, (b, hq, hkv, d, n, bs, block_table.shape[1])


def paged_attention(q, k_pages, v_pages, block_table, lengths) -> torch.Tensor:
    """q (B, Hq, D) -> (B, Hq, D): the decode query of each slot."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pages, v_pages, block_table, lengths)
    if q.dim() != 3:
        raise ValueError(f"paged_attention: q must be (B, Hq, D), got {tuple(q.shape)}")
    dev, code, (b, hq, hkv, d, n, bs, nb) = _check(
        "paged_attention", q, k_pages, v_pages, block_table, lengths, 1)
    out = torch.empty_like(q)
    launch("paged_attention_launch", dev, q.data_ptr(), k_pages.data_ptr(),
           v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, hq, hkv, d, n, bs, nb, code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_kquery(q, k_pages, v_pages, block_table, lengths) -> torch.Tensor:
    """q (B, Hq, kq, D) -> (B, Hq, kq, D): a chunked-prefill chunk (or any
    window of kq consecutive queries) per slot."""
    if q.device.type == "cpu":
        return ref.paged_attention_kquery_ref(q, k_pages, v_pages, block_table, lengths)
    if q.dim() != 4:
        raise ValueError(f"paged_attention_kquery: q must be (B, Hq, kq, D), "
                         f"got {tuple(q.shape)}")
    kq = q.shape[2]
    dev, code, (b, hq, hkv, d, n, bs, nb) = _check(
        "paged_attention_kquery", q, k_pages, v_pages, block_table, lengths, kq)
    out = torch.empty_like(q)
    launch("paged_attention_kquery_launch", dev, q.data_ptr(), k_pages.data_ptr(),
           v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, hq, hkv, kq, d, n, bs, nb, code)
    paged_attention_kquery.launches += 1
    return out


paged_attention_kquery.launches = 0
