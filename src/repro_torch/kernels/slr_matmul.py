"""Fused SLR matmul  y = x @ P[l] @ Vt[l] + x @ S[l]  over layer-stacked tables
(port of ``slr_matmul_stacked_pallas`` and the host side of
``repro/kernels/slr_matmul.py``).

``BsrStack`` is the layer-stacked block-CSC layout:
    counts  (L, JB)                int32
    rows    (L, JB, MAXB)          int32
    vals    (L, JB, MAXB, bs, bs)  float
``shape`` is the per-layer original dense (n, m); ``empty`` means no layer
holds a live block.

``slr_matmul_stacked`` and ``slr_matmul_multi`` (per-slot tables, the port of
``slr_matmul_multi_pallas``) run the plain version for CPU tensors and the
CUDA kernel ``csrc/slr_matmul.cu`` for CUDA tensors. The unstacked
``slr_matmul_pallas`` comes with the hybrid family.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch
from .bsr_matmul import BLOCK_SIZES, MAX_ROW_TILE, BsrMatrix, row_tile

__all__ = ["BsrStack", "stack_bsr", "row_tile", "slr_matmul_stacked", "slr_matmul_multi",
           "BLOCK_SIZES"]


@dataclass(frozen=True)
class BsrStack:
    counts: torch.Tensor
    rows: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]
    block_size: int
    empty: bool = False

    @property
    def num_layers(self) -> int:
        return self.counts.shape[0]

    def at_layer(self, layer: int) -> BsrMatrix:
        return BsrMatrix(self.counts[layer], self.rows[layer], self.vals[layer],
                         self.shape, self.block_size, empty=self.empty)


def stack_bsr(mats: list[BsrMatrix]) -> BsrStack:
    """Stack per-layer tables, padding every layer to the largest MAXB with
    row-0 / zero-tile slots (dead under ``slot < counts``)."""
    if not mats:
        raise ValueError("stack_bsr needs at least one layer")
    shape, bs = mats[0].shape, mats[0].block_size
    if any(m.shape != shape or m.block_size != bs for m in mats):
        raise ValueError(f"layers disagree on shape/block size: "
                         f"{[(m.shape, m.block_size) for m in mats]}")
    maxb = max(m.rows.shape[1] for m in mats)

    def pad_slots(a):
        pad = maxb - a.shape[1]
        if not pad:
            return a
        return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], dim=1)

    return BsrStack(
        torch.stack([m.counts for m in mats]),
        torch.stack([pad_slots(m.rows) for m in mats]),
        torch.stack([pad_slots(m.vals) for m in mats]),
        shape, bs, empty=all(m.empty for m in mats),
    )


def slr_matmul_stacked(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor,
                       stack: BsrStack, layer: int) -> torch.Tensor:
    """Layer ``layer`` of the fused SLR matmul. x (T, K), p (L, K, r),
    vt (L, r, M), ``stack`` of shape (K, M) -> y (T, M) in x.dtype."""
    if x.device.type == "cpu":
        return ref.slr_matmul_stacked_ref(x, p, vt, stack, layer)
    name = "slr_matmul_stacked"
    dev = check_cuda(name, x=x, p=p, vt=vt, counts=stack.counts, rows=stack.rows,
                     vals=stack.vals)
    code = dtype_code(x.dtype)
    if p.dtype != x.dtype or vt.dtype != x.dtype or stack.vals.dtype != x.dtype:
        raise TypeError(f"{name}: x, p, vt and vals must share one dtype, got "
                        f"{x.dtype}, {p.dtype}, {vt.dtype}, {stack.vals.dtype}")
    if stack.counts.dtype != torch.int32 or stack.rows.dtype != torch.int32:
        raise TypeError(f"{name}: counts and rows must be int32")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (T, K), got {tuple(x.shape)}")
    t_dim, k_dim = x.shape
    num_l, _, r = p.shape
    m_dim = stack.shape[1]
    bs = stack.block_size
    jb = -(-m_dim // bs)
    maxb = stack.rows.shape[-1]
    expect = {
        "p": (tuple(p.shape), (num_l, k_dim, r)),
        "vt": (tuple(vt.shape), (num_l, r, m_dim)),
        "stack.shape": (tuple(stack.shape), (k_dim, m_dim)),
        "counts": (tuple(stack.counts.shape), (num_l, jb)),
        "rows": (tuple(stack.rows.shape), (num_l, jb, maxb)),
        "vals": (tuple(stack.vals.shape), (num_l, jb, maxb, bs, bs)),
    }
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul_stacked")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size {bs} not in {BLOCK_SIZES}")
    if not 0 <= layer < num_l:
        raise IndexError(f"{name}: layer {layer} outside [0, {num_l})")
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    bt = row_tile(t_dim, x.dtype, cap=MAX_ROW_TILE)
    launch("slr_matmul_stacked_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           stack.counts.data_ptr(), stack.rows.data_ptr(), stack.vals.data_ptr(),
           y.data_ptr(), t_dim, k_dim, m_dim, r, layer, jb, maxb, bs, bt, code)
    slr_matmul_stacked.launches += 1
    return y


slr_matmul_stacked.launches = 0


def slr_matmul_multi(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor,
                     stack: BsrStack | None, ids: torch.Tensor, layers: int = 1,
                     layer: int = 0) -> torch.Tensor:
    """Per-slot fused SLR matmul: slot ``b`` of x (B, T, K) runs table row
    ``ids[b] * layers + layer`` of p (N, K, r), vt (N, r, M) and ``stack``
    (leading N) -> y (B, T, M) in x.dtype. ``stack=None`` runs the low-rank
    instance of the kernel (the empty-S corner). ``ids`` (B,) int32 stays on
    the device: the kernel reads it, so no slot assignment costs a host sync.
    ``layers``/``layer`` select a layer inside pooled (adapter, layer) rows
    as launch scalars."""
    if x.device.type == "cpu":
        return ref.slr_matmul_multi_ref(x, p, vt, stack, ids, layers, layer)
    name = "slr_matmul_multi"
    tabs = {} if stack is None else dict(counts=stack.counts, rows=stack.rows,
                                         vals=stack.vals)
    dev = check_cuda(name, x=x, p=p, vt=vt, ids=ids, **tabs)
    code = dtype_code(x.dtype)
    dtypes = {x.dtype, p.dtype, vt.dtype} | ({stack.vals.dtype} if stack is not None else set())
    if len(dtypes) != 1:
        raise TypeError(f"{name}: x, p, vt and vals must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    if ids.dtype != torch.int32 or (stack is not None and (
            stack.counts.dtype != torch.int32 or stack.rows.dtype != torch.int32)):
        raise TypeError(f"{name}: ids, counts and rows must be int32")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, K), got {tuple(x.shape)}")
    b_dim, t_dim, k_dim = x.shape
    n_tab, _, r = p.shape
    m_dim = vt.shape[-1]
    expect = {"p": (tuple(p.shape), (n_tab, k_dim, r)),
              "vt": (tuple(vt.shape), (n_tab, r, m_dim)),
              "ids": (tuple(ids.shape), (b_dim,))}
    bs = jb = maxb = 0
    if stack is not None:
        bs = stack.block_size
        jb, maxb = -(-m_dim // bs), stack.rows.shape[-1]
        expect.update({
            "stack.shape": (tuple(stack.shape), (k_dim, m_dim)),
            "counts": (tuple(stack.counts.shape), (n_tab, jb)),
            "rows": (tuple(stack.rows.shape), (n_tab, jb, maxb)),
            "vals": (tuple(stack.vals.shape), (n_tab, jb, maxb, bs, bs)),
        })
        if bs not in BLOCK_SIZES:
            raise ValueError(f"{name}: block size {bs} not in {BLOCK_SIZES}")
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul_multi")
    if layers < 1 or not 0 <= layer < layers or n_tab % layers:
        raise ValueError(f"{name}: layer {layer} of {layers} does not index {n_tab} table rows")
    y = torch.empty((b_dim, t_dim, m_dim), dtype=x.dtype, device=dev)
    if b_dim == 0 or t_dim == 0:
        return y
    bt = row_tile(t_dim, x.dtype, cap=MAX_ROW_TILE)
    tab_ptrs = (None, None, None) if stack is None else (
        stack.counts.data_ptr(), stack.rows.data_ptr(), stack.vals.data_ptr())
    launch("slr_matmul_multi_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           *tab_ptrs, ids.data_ptr(), y.data_ptr(), b_dim, t_dim, k_dim, m_dim, r, layers,
           layer, n_tab, jb, maxb, bs, bt, code)
    slr_matmul_multi.launches += 1
    return y


slr_matmul_multi.launches = 0
