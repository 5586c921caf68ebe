"""Low-rank matmul  y = x @ P @ Vt  (port of
``repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas``).

It serves the empty-S corner of the fused SLR weights and the L part of the
bsr format. The CUDA kernel (``csrc/lowrank_matmul.cu``) is two launches of
the stream kernel, t = x @ P into a (T, rp) f32 buffer and then t @ Vt, the
second a programmatic dependent of the first, cut by ``lowrank_plan``; the
launch count counts the call once. Its per-slot form serves
``slr_matmul_multi``'s empty-S corner (``lowrank_launch``), so a slot gives
bit for bit what ``lowrank_matmul`` gives on its table row.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch, table_dtype_code
from .stream import StreamPlan, card_sms, segment_count

__all__ = ["lowrank_matmul", "lowrank_plan", "lowrank_launch", "LowRankPlan"]

LOWRANK_COLS = 64    # columns per block of both products
LOWRANK_STEP = 32    # reduction rows per stage


@dataclass(frozen=True)
class LowRankPlan:
    """The two products' plans: ``xp`` (t = x @ P over K, r columns) and
    ``tv`` (y = t @ Vt over r, M columns); ``rp`` is t's row stride."""
    xp: StreamPlan
    tv: StreamPlan
    rp: int


@functools.lru_cache(maxsize=4096)
def lowrank_plan(k: int, r: int, m: int, x_size: int, w_size: int, sms: int) -> LowRankPlan:
    """The launch plan over factors P (K, r) and Vt (r, M) of ``w_size``
    bytes per value under x of ``x_size``, on a card of ``sms`` SMs; never T
    or B. Both products take 64 columns per block and stages of 32 rows; K
    and r are each cut into the most segments (up to 8, a power of two) that
    their stages fill. Raises where a block's shared memory would exceed the
    card's 227 KB."""
    def plan(kdim, cols, xs):
        return StreamPlan(LOWRANK_COLS, LOWRANK_STEP, segment_count(-(-kdim // LOWRANK_STEP)),
                          -(-cols // LOWRANK_COLS), xs, w_size, 0, sms)

    what = f"lowrank_matmul: K={k}, r={r}, M={m}"
    return LowRankPlan(plan(k, r, x_size).check(what), plan(r, m, 4).check(what),
                       -(-r // 4) * 4)


def lowrank_launch(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor, y: torch.Tensor,
                   ids: torch.Tensor | None = None, layers: int = 1, layer: int = 0) -> None:
    """Launch the kernel pair for x (B, T, K) into y (B, T, M): one table
    row p (K, r), vt (r, M) for B = 1 without ``ids``, else slot b reads row
    ``ids[b] * layers + layer`` of p (N, K, r), vt (N, r, M) on the device.
    The caller has checked the arguments."""
    dev = x.device
    b_dim, t_dim, k_dim = x.shape
    r, m_dim = vt.shape[-2:]
    n_tab = p.shape[0] if ids is not None else 1
    plan = lowrank_plan(k_dim, r, m_dim, x.element_size(), p.element_size(),
                        card_sms(dev.index))
    xrows, split_p = plan.xp.cut(t_dim, b_dim)
    _, split_v = plan.tv.cut(t_dim, b_dim)
    t = torch.empty((b_dim * t_dim, plan.rp), dtype=torch.float32, device=dev)
    launch("lowrank_matmul_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           None if ids is None else ids.data_ptr(), t.data_ptr(), y.data_ptr(), b_dim, t_dim,
           k_dim, m_dim, r, plan.rp, layers, layer, n_tab, plan.xp.nseg, plan.tv.nseg, xrows,
           split_p, split_v, dtype_code(x.dtype), dtype_code(p.dtype))


def lowrank_matmul(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """x (T, K), p (K, r), vt (r, M) -> y (T, M) in x.dtype; the factors
    share x's dtype, or are float32 under bfloat16 x."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_ref(x, p, vt)
    name = "lowrank_matmul"
    dev = check_cuda(name, x=x, p=p, vt=vt)
    table_dtype_code(name, x.dtype, p, vt)
    if x.dim() != 2 or p.dim() != 2 or vt.dim() != 2:
        raise ValueError(f"{name}: expected 2-D x, p, vt")
    t_dim, k_dim = x.shape
    r, m_dim = vt.shape
    if tuple(p.shape) != (k_dim, r):
        raise ValueError(f"{name}: p has shape {tuple(p.shape)}, expected {(k_dim, r)}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul")
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    lowrank_launch(x[None], p, vt, y)
    lowrank_matmul.launches += 1
    return y


lowrank_matmul.launches = 0
