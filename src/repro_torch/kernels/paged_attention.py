"""Paged attention over a block-table KV pool: single-query decode and
k-query (port of ``repro/kernels/paged_attention.py``).

The pool is ``(num_pages, Hkv, bs, D)`` per layer; slot b's position j lives
in page ``block_table[b, j // bs]`` at offset ``j % bs``. Entries
``>= num_pages`` are unmapped: they clamp to the last page and the length
mask hides whatever they hold. Query i of slot b sits at ``lengths[b] + i``
(its KV already inserted) and sees keys at positions <= ``lengths[b] + i``.

Both wrappers run the plain version for CPU tensors and the CUDA kernel
``csrc/paged_attention.cu`` for CUDA tensors, its key axis cut by
``paged_plan`` from the table shape, D and the pools' dtype: never from B or
the lengths, so a slot's output is bit for bit the same alone or in any batch.
q and the pools are float32 and float32, bfloat16 and bfloat16, or float32 q
over bfloat16 pools (a bf16 page pool under an f32 model): the kernel then
widens each K and V element to f32 exactly, as the Pallas kernels widen each
tile, and the output is float32.
Decode splits the key axis into segments summed by a thread-block cluster;
k-query walks it whole (one segment), its 16-row tiles filling the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch

__all__ = ["paged_attention", "paged_attention_kquery", "paged_plan", "PagedPlan",
           "dtype_route", "takes_pages", "MAX_HEAD_DIM", "MAX_SEGMENTS",
           "MIN_SEGMENT_CHUNKS"]

MAX_HEAD_DIM = 256
MAX_SEGMENTS = 8        # segments of the key axis: blocks per cluster, the portable limit
MIN_SEGMENT_CHUNKS = 2  # chunks per segment at least (tools/paged_variants.py: decode at
                        # 512 positions takes 8 segments of one chunk no faster than 4 of two)


@dataclass(frozen=True)
class PagedPlan:
    """The key axis of a (slot, KV head, row tile): ``nseg`` segments of
    ``seg_keys`` positions (the last one ragged), each walked in chunks of
    ``chunk`` keys by one block of a thread-block cluster."""
    chunk: int
    seg_keys: int
    nseg: int


def paged_plan(nb: int, bs: int, d: int, itemsize: int,
               max_segments: int = MAX_SEGMENTS) -> PagedPlan:
    """Segments of a table of ``nb`` pages of ``bs`` positions, ``itemsize``
    the pools' (the staged K and V rows'): chunks of 64 keys (32 for f32
    pools at D > 128: ``chunk_keys`` in the source), at least
    ``MIN_SEGMENT_CHUNKS`` per segment and as few more as keep the segments
    within ``max_segments`` (at most the card's cluster limit). Never reads
    B or a slot's length."""
    chunk = 32 if itemsize == 4 and d > 128 else 64
    chunks = -(-nb * bs // chunk)
    per_seg = max(MIN_SEGMENT_CHUNKS, -(-chunks // max_segments))
    return PagedPlan(chunk, per_seg * chunk, -(-chunks // per_seg))


F32_OVER_BF16 = 2   # the kernel's dtype code of float32 q over bfloat16 pools
# the (q, pool) dtype pairs the paged kernels read, with the kernel's dtype code
_PAGE_PAIRS = {(torch.float32, torch.float32): dtype_code(torch.float32),
               (torch.bfloat16, torch.bfloat16): dtype_code(torch.bfloat16),
               (torch.float32, torch.bfloat16): F32_OVER_BF16}


def takes_pages(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> bool:
    """Whether the paged kernels read pools of ``kv_dtype`` under queries of
    ``q_dtype``: float32 over float32, bfloat16 over bfloat16, or float32
    over bfloat16. int8 pools (quantized, with scale pools) never: they take
    the dequantizing page gather, as in the JAX package. The one place that
    decides which pages reach the kernels: the attention layer, the engines'
    constructors and the launcher ask it."""
    return (q_dtype, kv_dtype) in _PAGE_PAIRS


def dtype_route(name: str, q_dtype: torch.dtype, k_dtype: torch.dtype,
                v_dtype: torch.dtype) -> int:
    """The kernel's dtype code for q over k/v pools (``takes_pages``);
    anything else is refused by name."""
    if k_dtype == v_dtype and takes_pages(q_dtype, k_dtype):
        return _PAGE_PAIRS[(q_dtype, k_dtype)]
    raise TypeError(f"{name}: q of {q_dtype} over k/v pools of {k_dtype}/{v_dtype}; the "
                    "kernel takes float32 over float32, bfloat16 over bfloat16, or float32 "
                    "q over bfloat16 pools")


def _check(name, q, k_pages, v_pages, block_table, lengths, kq):
    dev = check_cuda(name, q=q, k_pages=k_pages, v_pages=v_pages,
                     block_table=block_table, lengths=lengths)
    code = dtype_route(name, q.dtype, k_pages.dtype, v_pages.dtype)
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
    plan = paged_plan(nb, bs, d, k_pages.element_size())
    out = torch.empty_like(q)
    launch("paged_attention_launch", dev, q.data_ptr(), k_pages.data_ptr(),
           v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, hq, hkv, d, n, bs, nb, plan.seg_keys, code)
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
    plan = paged_plan(nb, bs, d, k_pages.element_size(), max_segments=1)
    out = torch.empty_like(q)
    launch("paged_attention_kquery_launch", dev, q.data_ptr(), k_pages.data_ptr(),
           v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), b, hq, hkv, kq, d, n, bs, nb, plan.seg_keys, code)
    paged_attention_kquery.launches += 1
    return out


paged_attention_kquery.launches = 0
