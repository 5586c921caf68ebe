"""Proximal operators and structural statistics for SALAAD (port of
``repro/core/prox.py``).

  * ``soft_threshold``       - prox of ``tau * ||.||_1`` (element-wise shrinkage)
  * ``svt`` / ``svt_from_svd`` - prox of ``tau * ||.||_*`` (singular value thresholding)
  * ``effective_rank_ratio`` - Definition 4.1 (energy-coverage effective rank)
  * ``density``              - fraction of nonzeros of the sparse component

``soft_threshold`` here is the plain, broadcasting version; the ADMM S-update
shrinks a batch of blocks through ``kernels.ops.soft_threshold``, which runs
the CUDA kernel on the card and this arithmetic on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["soft_threshold", "svt", "svt_from_svd", "effective_rank_ratio",
           "effective_rank_ratio_from_singular_values", "density"]


def soft_threshold(z: torch.Tensor, tau) -> torch.Tensor:
    """sign(z) * max(|z| - tau, 0), element-wise; ``tau`` broadcasts."""
    tau = torch.as_tensor(tau, dtype=z.dtype, device=z.device)
    return torch.sign(z) * torch.clamp_min(z.abs() - tau, 0)


def svt_from_svd(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor, tau):
    """Singular-value soft thresholding given an SVD: ``(s_thr, L)`` with
    ``s_thr = (s - tau)_+`` and ``L = u diag(s_thr) vt``."""
    s_thr = torch.clamp_min(s - torch.as_tensor(tau, dtype=s.dtype, device=s.device), 0)
    return s_thr, (u * s_thr[..., None, :]) @ vt


def svt(z: torch.Tensor, tau):
    """prox_{tau ||.||_*}(z) through the full SVD; returns ``(s_thr, L)``."""
    u, s, vt = torch.linalg.svd(z, full_matrices=False)
    return svt_from_svd(u, s, vt, tau)


def effective_rank_ratio_from_singular_values(
    s: torch.Tensor, gamma: float = 0.999, denom: int | None = None
) -> torch.Tensor:
    """min{k : sum_{i<=k} sigma_i / sum_j sigma_j >= gamma} / denom.

    Branch-free as in the JAX package: sort descending, count prefix sums
    strictly below the coverage target, +1 for the crossing index; an
    all-zero spectrum gives 0.
    """
    s = torch.sort(s.abs(), dim=-1, descending=True).values
    total = s.sum(-1, keepdim=True)
    csum = torch.cumsum(s, dim=-1)
    covered = csum >= gamma * total
    k = 1 + (~covered[..., :-1]).sum(-1)
    k = torch.where(total[..., 0] > 0, k, torch.zeros_like(k))
    d = denom if denom is not None else s.shape[-1]
    return k.to(torch.float32) / d


def effective_rank_ratio(mat: torch.Tensor, gamma: float = 0.999) -> torch.Tensor:
    """Definition 4.1 for a dense matrix (computes its singular values)."""
    return effective_rank_ratio_from_singular_values(torch.linalg.svdvals(mat), gamma)


def density(mat: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Fraction of entries with |x| > eps (Upsilon_S in the paper)."""
    return (mat.abs() > eps).float().mean()
