"""Adam (the paper's base optimizer, zero weight decay by default; port of
``repro/optim/adam.py``).

Moments are kept in f32 whatever the parameter dtype, the global-norm clip
runs first, and bias correction uses the step count. Parameters and moments
are nested dicts of tensors in the parameter tree's layout. The update is
functional - it returns new tensors and leaves its inputs alone - so a state
that a caller holds (a checkpoint being written, a test's reference) never
changes under it; at Llama-60m the second copy costs a few hundred MB.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..tree import leaf_by_path, replace_by_path, tree_leaves_with_path, tree_map

__all__ = ["AdamConfig", "AdamState", "init_adam", "global_norm", "adam_update"]


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0   # paper section 5.1: zero weight decay
    grad_clip: float = 1.0      # global-norm clip; 0 disables


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: int                  # completed updates, on the host


def init_adam(params: Any) -> AdamState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params), count=0)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [leaf.float().square().sum() for _, leaf in tree_leaves_with_path(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def adam_update(grads: Any, state: AdamState, params: Any, cfg: AdamConfig,
                lr_scale: float = 1.0) -> tuple[Any, AdamState]:
    """Returns ``(new_params, new_state)``; nothing is updated in place."""
    if cfg.grad_clip:
        gn = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
    count = state.count + 1
    f = np.float32                     # host scalars in f32, as JAX computes them
    b1c = float(f(1) - f(cfg.b1) ** f(count))
    b2c = float(f(1) - f(cfg.b2) ** f(count))
    lr = float(f(cfg.lr) * f(lr_scale))
    new_mu, new_nu = {}, {}

    def upd(path, p):
        g32 = leaf_by_path(grads, path).float()
        m = cfg.b1 * leaf_by_path(state.mu, path) + (1 - cfg.b1) * g32
        v = cfg.b2 * leaf_by_path(state.nu, path) + (1 - cfg.b2) * g32 * g32
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        new_mu[path], new_nu[path] = m, v
        return (p.float() - lr * step).to(p.dtype)

    new_params = replace_by_path(params, upd)
    pick = lambda table: replace_by_path(params, lambda path, _: table[path])  # noqa: E731
    return new_params, AdamState(mu=pick(new_mu), nu=pick(new_nu), count=count)
