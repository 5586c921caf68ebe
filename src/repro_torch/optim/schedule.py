"""Learning-rate schedules: warmup + cosine, the LLaMA/GaLore standard (port
of ``repro/optim/schedule.py``). Host-side, computed in float32 as the JAX
package computes them."""
from __future__ import annotations

import numpy as np

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000, floor: float = 0.1) -> float:
    """Multiplicative LR scale in [floor, 1]."""
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(warmup, 1)), f(1.0))
    frac = np.clip((step - f(warmup)) / f(max(total - warmup, 1)), f(0.0), f(1.0))
    cos = f(floor) + f(1 - floor) * f(0.5) * (f(1) + np.cos(f(np.pi) * frac))
    return float(f(warm * cos))
