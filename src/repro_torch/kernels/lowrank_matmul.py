"""Low-rank matmul  y = x @ P @ Vt  with the (T, r) intermediate kept on chip
(port of ``repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas``).

It serves the empty-S corner of ``ops.slr_matmul_stacked``. The CUDA kernel
shares its source with the fused SLR kernel (``csrc/slr_matmul.cu``, built
without the sparse epilogue) and has its own entry point and launch count.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch
from .slr_matmul import MAX_ROW_TILE, row_tile

__all__ = ["lowrank_matmul"]


def lowrank_matmul(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """x (T, K), p (K, r), vt (r, M) -> y (T, M) in x.dtype."""
    if x.device.type == "cpu":
        return ref.lowrank_matmul_ref(x, p, vt)
    name = "lowrank_matmul"
    dev = check_cuda(name, x=x, p=p, vt=vt)
    code = dtype_code(x.dtype)
    if p.dtype != x.dtype or vt.dtype != x.dtype:
        raise TypeError(f"{name}: x, p and vt must share one dtype, got "
                        f"{x.dtype}, {p.dtype}, {vt.dtype}")
    if x.dim() != 2 or p.dim() != 2 or vt.dim() != 2:
        raise ValueError(f"{name}: expected 2-D x, p, vt")
    t_dim, k_dim = x.shape
    r, m_dim = vt.shape
    if tuple(p.shape) != (k_dim, r):
        raise ValueError(f"{name}: p has shape {tuple(p.shape)}, expected {(k_dim, r)}")
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    bt = row_tile(t_dim, x.dtype, cap=MAX_ROW_TILE)
    launch("lowrank_matmul_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           y.data_ptr(), t_dim, k_dim, m_dim, r, bt, code)
    lowrank_matmul.launches += 1
    return y


lowrank_matmul.launches = 0
