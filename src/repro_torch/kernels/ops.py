"""Public entry points for the ported kernels (port of
``repro/kernels/ops.py``).

Models and the serving engine call these. Each kernel wrapper counts its
launches in an integer attribute (``launches``) that it increments where it
launches the CUDA kernel and nowhere else; ``launch_counts`` and
``reset_launch_counts`` read and clear them, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import torch

from .bsr_matmul import BsrMatrix, bsr_matmul as _bsr_matmul_kernel
from .flash_attention import flash_attention
from .lowrank_matmul import lowrank_matmul
from .page_copy import page_copy
from .paged_attention import paged_attention, paged_attention_kquery
from .slr_matmul import BsrStack
from .slr_matmul import slr_matmul as _slr_matmul_kernel
from .slr_matmul import slr_matmul_multi as _slr_matmul_multi_kernel
from .slr_matmul import slr_matmul_stacked as _slr_matmul_stacked_kernel
from .soft_threshold import soft_threshold

__all__ = [
    "slr_matmul",
    "slr_matmul_stacked",
    "slr_matmul_multi",
    "lowrank_matmul",
    "bsr_matmul",
    "paged_attention",
    "paged_attention_kquery",
    "page_copy",
    "flash_attention",
    "soft_threshold",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> wrapper holding its launch count
KERNELS = {
    "slr_matmul": _slr_matmul_kernel,
    "slr_matmul_stacked": _slr_matmul_stacked_kernel,
    "slr_matmul_multi": _slr_matmul_multi_kernel,
    "lowrank_matmul": lowrank_matmul,
    "bsr_matmul": _bsr_matmul_kernel,
    "paged_attention": paged_attention,
    "paged_attention_kquery": paged_attention_kquery,
    "page_copy": page_copy,
    "flash_attention": flash_attention,
    "soft_threshold": soft_threshold,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def bsr_matmul(x: torch.Tensor, bsr: BsrMatrix) -> torch.Tensor:
    """y = x @ S; an S with no live block gives zeros without a launch (the
    JAX dispatcher's static ``empty`` fast path)."""
    if bsr.empty:
        return torch.zeros((x.shape[0], bsr.shape[1]), dtype=x.dtype, device=x.device)
    return _bsr_matmul_kernel(x, bsr)


def slr_matmul(x: torch.Tensor, p, vt, bsr: BsrMatrix | None) -> torch.Tensor:
    """Unstacked fused SLR matmul y = x @ P @ Vt + x @ S, with the degenerate
    corners of the JAX dispatcher: no factors and no S give zeros, an empty S
    runs the low-rank kernel, r == 0 the block-CSC kernel, and both parts
    live the fused unstacked kernel (``slr_matmul_pallas``'s port)."""
    r = 0 if p is None else p.shape[-1]
    empty_s = bsr is None or bsr.empty
    if empty_s and r == 0:
        m = vt.shape[-1] if vt is not None else bsr.shape[1]
        return torch.zeros((x.shape[0], m), dtype=x.dtype, device=x.device)
    if empty_s:
        return lowrank_matmul(x, p, vt)
    if r == 0:
        return bsr_matmul(x, bsr)
    return _slr_matmul_kernel(x, p, vt, bsr)


def slr_matmul_stacked(x: torch.Tensor, p, vt, stack: BsrStack | None,
                       layer: int) -> torch.Tensor:
    """Layer ``layer`` of a stacked fused SLR weight, with the degenerate
    corners of the JAX dispatcher: no factors and no S gives zeros; an empty
    S runs the low-rank kernel on the layer's factors; r == 0 with a live S
    runs the fused kernel with rank-1 zero factors."""
    r = 0 if p is None else p.shape[-1]
    empty_s = stack is None or stack.empty
    if empty_s and r == 0:
        m = vt.shape[-1] if vt is not None else stack.shape[1]
        return torch.zeros((x.shape[0], m), dtype=x.dtype, device=x.device)
    if empty_s:
        return lowrank_matmul(x, p[layer], vt[layer])
    if r == 0:
        num_l = stack.num_layers
        p = torch.zeros((num_l, x.shape[1], 1), dtype=x.dtype, device=x.device)
        vt = torch.zeros((num_l, 1, stack.shape[1]), dtype=x.dtype, device=x.device)
    return _slr_matmul_stacked_kernel(x, p, vt, stack, layer)


def slr_matmul_multi(x: torch.Tensor, p, vt, stack: BsrStack | None, ids: torch.Tensor,
                     layers: int = 1, layer: int = 0) -> torch.Tensor:
    """Per-slot fused SLR matmul: slot ``b`` of x (B, T, K) runs table row
    ``ids[b] * layers + layer`` of the pooled tables, with the corners of the
    JAX dispatcher mirrored op for op, so each slot runs exactly what the
    single-tenant tier runs: no factors and no S give zeros; an empty S is
    the low-rank product per slot (one launch of the kernel's low-rank
    instance, whose rows equal ``lowrank_matmul``'s); r == 0 with a live S
    runs the fused kernel with rank-1 zero factors."""
    r = 0 if p is None else p.shape[-1]
    empty_s = stack is None or stack.empty
    if empty_s and r == 0:
        m = vt.shape[-1] if vt is not None else stack.shape[1]
        return torch.zeros((*x.shape[:2], m), dtype=x.dtype, device=x.device)
    if empty_s:
        return _slr_matmul_multi_kernel(x, p, vt, None, ids, layers, layer)
    if r == 0:
        n_tab = stack.num_layers
        p = torch.zeros((n_tab, x.shape[2], 1), dtype=x.dtype, device=x.device)
        vt = torch.zeros((n_tab, 1, stack.shape[1]), dtype=x.dtype, device=x.device)
    return _slr_matmul_multi_kernel(x, p, vt, stack, ids, layers, layer)
