"""Element-wise soft thresholding, the l1 prox (port of
``repro/kernels/soft_threshold.py::soft_threshold_pallas``).

``sign(x) * max(|x| - tau, 0)`` with tau cast to x's dtype first. The Pallas
kernel shrinks one 2-D block by one scalar; the port's ADMM S-update runs a
stacked leaf as one batch of ``nb`` blocks with a threshold each, so this
takes x ``(nb, ...)`` and tau ``(nb,)``, a tensor on x's device: the
controller's beta stays on the card and the launch needs no host sync.

``soft_threshold`` runs the plain version for CPU tensors and the CUDA kernel
``csrc/soft_threshold.cu`` for CUDA tensors; the kernel's C entry cuts the
call itself, so the wrapper passes the slice length and the element count.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch

__all__ = ["soft_threshold"]


def soft_threshold(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """x (nb, ...) float32 or bfloat16, tau (nb,) -> shrunk x, x's dtype."""
    name = "soft_threshold"
    if x.dim() < 1 or tau.dim() != 1 or tau.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: expected x (nb, ...) and tau (nb,), got "
                         f"{tuple(x.shape)} and {tuple(tau.shape)}")
    if x.device.type == "cpu":
        return ref.soft_threshold_ref(x, tau)
    tau = tau.float()
    dev = check_cuda(name, x=x, tau=tau)
    code = dtype_code(x.dtype)
    out = torch.empty_like(x)
    numel = x.numel()
    if numel == 0:
        return out
    launch("soft_threshold_launch", dev, x.data_ptr(), tau.data_ptr(), out.data_ptr(),
           numel // x.shape[0], numel, code)
    soft_threshold.launches += 1
    return out


soft_threshold.launches = 0
