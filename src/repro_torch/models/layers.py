"""Shared layers as plain functions over parameter dicts (port of the dense
Llama part of ``repro/models/layers.py``).

Conventions as in the JAX package: linear weights are stored (d_in, d_out)
so ``x @ w`` applies them, stacked layer parameters carry a leading
``(num_layers,)`` axis, norms and softmax run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_weight", "rmsnorm", "rope_freqs", "apply_rope", "swiglu", "embed"]


def apply_weight(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ w for a dense tensor OR any deployed-format weight object with
    an ``apply`` method (``serving.slr_params.SLRLinear`` / ``SLRLayerView``)."""
    if hasattr(w, "apply"):
        return w.apply(x)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(apply_weight(x, params["gate"])) * apply_weight(x, params["up"])
    return apply_weight(h, params["down"])


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]
