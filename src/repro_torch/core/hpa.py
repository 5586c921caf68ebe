"""Homomorphic Parameter Allocation (HPA), section 4.3 + App. D (port of
``repro/core/hpa.py``).

Deploy-time capacity control. Given a parameter-removal budget ``C`` and a
mixing coefficient ``kappa``:

    phi_L = kappa*C / C_L          phi_S = (1-kappa)*C / C_S

where ``C_L`` / ``C_S`` are the removable parameters of the low-rank and
sparse components; a ratio above 1 hands its surplus to the other component
(footnote 3). Every block drops the same global fractions: the smallest
``phi_L`` of its singular values and the smallest ``phi_S`` of its sparse
entries by magnitude. A rank unit of an (n, m) block costs n + m parameters,
a sparse unit one value.

The truncation is numpy work in float64 on the host, as in the JAX package,
so a bridged state truncates to the same entries; the results go back to the
state's device and dtypes.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from . import sparse
from .admm import BlockSLR, SLRState
from .selection import BlockInfo

__all__ = ["removable_params", "hpa_compress", "hpa_keep_ratio"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def removable_params(state: SLRState, blocks: list[BlockInfo]) -> tuple[int, int]:
    """(C_L, C_S): removable parameter totals across blocks."""
    c_l = 0
    c_s = 0
    for info in blocks:
        blk = state[info.name]
        c_l += int((blk.s_vals > 0).sum()) * (info.n + info.m)
        c_s += int((blk.s_coo.idx >= 0).sum())
    return c_l, c_s


def _split_budget(c: int, kappa: float, c_l: int, c_s: int) -> tuple[float, float]:
    """Global ratios with footnote-3 surplus reassignment."""
    if c > c_l + c_s:
        raise ValueError(f"budget C={c} exceeds removable params {c_l + c_s}")
    bl, bs = kappa * c, (1.0 - kappa) * c
    if c_l > 0 and bl > c_l:
        bs += bl - c_l
        bl = c_l
    if c_s > 0 and bs > c_s:
        bl += bs - c_s
        bl = min(bl, c_l)
        bs = c_s
    phi_l = bl / c_l if c_l > 0 else 0.0
    phi_s = bs / c_s if c_s > 0 else 0.0
    return min(phi_l, 1.0), min(phi_s, 1.0)


def _ranks(keys: np.ndarray) -> np.ndarray:
    """Position of every entry in a descending sort along the last axis."""
    order = np.argsort(-keys, axis=-1)
    ranks = np.empty_like(order)
    positions = np.arange(keys.shape[-1])[(None,) * (keys.ndim - 1)] * np.ones_like(order)
    np.put_along_axis(ranks, order, positions, axis=-1)
    return ranks


def _truncate_block(blk: BlockSLR, phi_l: float, phi_s: float) -> BlockSLR:
    """Remove the smallest phi_l fraction of singular values and phi_s
    fraction of sparse entries, per stacked slice, by magnitude. With both
    fractions 0 every live entry stays and the block is returned as it is
    (the sorts below would keep it to the bit, at the cost of sorting every
    sparse entry on the host)."""
    if phi_l == 0.0 and phi_s == 0.0:
        return blk
    dev = blk.p.device
    s_vals = _np(blk.s_vals).astype(np.float64)           # (..., r)
    live = s_vals > 0
    keep_counts = np.ceil((1.0 - phi_l) * live.sum(axis=-1)).astype(np.int64)
    keep_mask_l = (_ranks(s_vals) < keep_counts[..., None]) & live
    new_s_vals = np.where(keep_mask_l, s_vals, 0.0)
    # p = U diag(s): zeroing a singular value zeroes its column
    scale = np.where(s_vals > 0, new_s_vals / np.maximum(s_vals, 1e-30), 0.0)
    new_p = _np(blk.p) * scale[..., None, :]

    vals = _np(blk.s_coo.values).astype(np.float64)       # (..., cap)
    idx = _np(blk.s_coo.idx)
    live_s = idx >= 0
    mags = np.where(live_s, np.abs(vals), -np.inf)
    keep_s_counts = np.floor((1.0 - phi_s) * live_s.sum(axis=-1)).astype(np.int64)
    keep_mask_s = (_ranks(mags) < keep_s_counts[..., None]) & live_s
    new_vals = np.where(keep_mask_s, vals, 0.0)
    new_idx = np.where(keep_mask_s, idx, -1).astype(np.int32)

    def back(a, like):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, like.dtype)

    return replace(
        blk,
        p=back(new_p, blk.p),
        s_vals=back(new_s_vals, blk.s_vals),
        s_coo=sparse.CooMatrix(back(new_vals, blk.s_coo.values),
                               back(new_idx, blk.s_coo.idx), blk.s_coo.shape),
    )


def hpa_compress(state: SLRState, blocks: list[BlockInfo], remove_budget: int,
                 kappa: float) -> tuple[SLRState, dict]:
    """HPA truncation under a parameter-removal budget. Returns (state, report)."""
    c_l, c_s = removable_params(state, blocks)
    phi_l, phi_s = _split_budget(remove_budget, kappa, c_l, c_s)
    new_state: SLRState = dict(state)
    for info in blocks:
        new_state[info.name] = _truncate_block(state[info.name], phi_l, phi_s)
    c_l2, c_s2 = removable_params(new_state, blocks)
    report = {
        "phi_L": phi_l,
        "phi_S": phi_s,
        "params_before": c_l + c_s,
        "params_after": c_l2 + c_s2,
        "removed": (c_l + c_s) - (c_l2 + c_s2),
        "index_overhead_entries": c_s2,  # one int32 per surviving sparse entry
    }
    return new_state, report


def hpa_keep_ratio(state: SLRState, blocks: list[BlockInfo], keep_ratio: float,
                   kappa: float) -> tuple[SLRState, dict]:
    """Keep ``keep_ratio`` of the current SLR parameter count."""
    c_l, c_s = removable_params(state, blocks)
    budget = int(round((1.0 - keep_ratio) * (c_l + c_s)))
    return hpa_compress(state, blocks, budget, kappa)
