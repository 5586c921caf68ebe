"""The I(ntegral)-controller of section 4.2: block-wise adaptive (alpha, beta)
(port of ``repro/core/controller.py``).

    alpha <- max(alpha + rho * (Gamma_L - Gamma_hat) * dalpha, 0)
    beta  <- max(beta  + rho * (Upsilon_S - Upsilon_hat) * dbeta, 0)

Element-wise, so stacked blocks carry per-slice controller state.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["ControllerConfig", "controller_update"]


@dataclass(frozen=True)
class ControllerConfig:
    target_rank_ratio: float = 0.15
    target_density: float = 0.05
    dalpha: float = 0.1
    dbeta: float = 0.003
    gamma: float = 0.999


def controller_update(alpha: torch.Tensor, beta: torch.Tensor,
                      rank_ratio: torch.Tensor, density: torch.Tensor,
                      rho: float, cfg: ControllerConfig):
    alpha_new = alpha + rho * (rank_ratio - cfg.target_rank_ratio) * cfg.dalpha
    beta_new = beta + rho * (density - cfg.target_density) * cfg.dbeta
    return alpha_new.clamp_min(0.0), beta_new.clamp_min(0.0)
