"""Shared layers as plain functions over parameter dicts (port of the parts
of ``repro/models/layers.py`` the dense Llama and the hybrid use).

Conventions as in the JAX package: linear weights are stored (d_in, d_out)
so ``x @ w`` applies them, stacked layer parameters carry a leading
``(num_layers,)`` axis, norms and softmax run in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_weight", "rmsnorm", "apply_norm", "rope_freqs", "apply_rope", "swiglu",
           "apply_mlp", "embed"]


def apply_weight(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ w for a dense tensor OR any deployed-format weight object with
    an ``apply`` method (``serving.slr_params.SLRLinear`` / ``SLRLayerView``,
    ``serving.adapters.AdapterizedLinear`` and its layer view), which gets x
    in its own (B, T, K) shape."""
    if hasattr(w, "apply"):
        return w.apply(x)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred scale, ``x / rms(x) * (1 + scale)``;
    ``scale=None`` is the scale-free norm of the SSM layers."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict | None, norm_type: str) -> torch.Tensor:
    """The config's norm; ``params`` None (or empty) means no scale."""
    if norm_type == "rmsnorm":
        return rmsnorm(x, params["norm_scale"] if params else None)
    raise ValueError(f"norm_type {norm_type!r} is not ported yet")


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


def apply_mlp(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        return swiglu(params, x)
    raise ValueError(f"mlp_type {mlp_type!r} is not ported yet")


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]
