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

from .lowrank_matmul import lowrank_matmul
from .paged_attention import paged_attention, paged_attention_kquery
from .slr_matmul import BsrStack, slr_matmul_stacked as _slr_matmul_stacked_kernel

__all__ = [
    "slr_matmul_stacked",
    "lowrank_matmul",
    "paged_attention",
    "paged_attention_kquery",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

# kernel name -> wrapper holding its launch count
KERNELS = {
    "slr_matmul_stacked": _slr_matmul_stacked_kernel,
    "lowrank_matmul": lowrank_matmul,
    "paged_attention": paged_attention,
    "paged_attention_kquery": paged_attention_kquery,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


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
