"""Proximal operators and structural statistics for SALAAD (port of the part
of ``repro/core/prox.py`` that the stage-2 sweep uses).

  * ``soft_threshold`` - prox of ``tau * ||.||_1``
  * ``effective_rank_ratio_from_singular_values`` - Definition 4.1
"""
from __future__ import annotations

import torch

__all__ = ["soft_threshold", "effective_rank_ratio_from_singular_values"]


def soft_threshold(z: torch.Tensor, tau) -> torch.Tensor:
    """sign(z) * max(|z| - tau, 0), element-wise; ``tau`` broadcasts."""
    tau = torch.as_tensor(tau, dtype=z.dtype, device=z.device)
    return torch.sign(z) * torch.clamp_min(z.abs() - tau, 0)


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
