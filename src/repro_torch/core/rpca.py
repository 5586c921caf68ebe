"""Robust PCA by the inexact augmented Lagrange multiplier method (Lin, Chen
and Ma 2010): the post-hoc baseline (port of ``repro/core/rpca.py``).

The paper applies RPCA to standard-trained weights (App. A: weak SLR
structure) and, with HPA, to full-rank checkpoints (Fig. 3's "vanilla"
curves). The iteration:

    L <- SVT_{1/mu}(X - S + Y/mu)
    S <- shrink_{lambda/mu}(X - L + Y/mu)
    Y <- Y + mu (X - L - S)
    mu <- min(mu * rho_mu, mu_max)

with lambda = lam_scale / sqrt(max(n, m)), mu_0 = 1.25 / ||X||_2 and a
fixed iteration count; the residual history shows convergence. Plain
PyTorch in f32, as the JAX version is plain ``jnp``; scalars stay f32
tensors, as they are in the JAX scan.
"""
from __future__ import annotations

import torch

from .prox import soft_threshold, svt

__all__ = ["rpca"]


def rpca(x: torch.Tensor, n_iter: int = 50, lam_scale: float = 1.0, rho_mu: float = 1.2
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose ``x ~= L + S``; returns ``(L, S, residual_history)``, the
    history ``||X - L - S||_F / ||X||_F`` after each of the ``n_iter`` (at
    least one) iterations."""
    x = x.float()
    n, m = x.shape
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    lam = f32(lam_scale) / torch.sqrt(f32(max(n, m)))
    sigma1 = torch.clamp_min(torch.linalg.matrix_norm(x, 2), 1e-12)
    mu = 1.25 / sigma1
    mu_max = mu * 1e7
    x_fro = torch.clamp_min(torch.linalg.vector_norm(x), 1e-12)
    s = torch.zeros_like(x)
    y = x / sigma1
    hist = []
    for _ in range(n_iter):
        _, l = svt(x - s + y / mu, 1.0 / mu)
        s = soft_threshold(x - l + y / mu, lam / mu)
        y = y + mu * (x - l - s)
        hist.append(torch.linalg.vector_norm(x - l - s) / x_fro)
        mu = torch.minimum(mu * rho_mu, mu_max)
    return l, s, torch.stack(hist)

