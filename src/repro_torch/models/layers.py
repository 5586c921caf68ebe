"""Shared layers as plain functions over parameter dicts (port of
``repro/models/layers.py``).

Conventions as in the JAX package: linear weights are stored (d_in, d_out)
so ``x @ w`` applies them, stacked layer parameters carry a leading
``(num_layers,)`` axis, norms and softmax run in f32.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["apply_weight", "rmsnorm", "nonparam_layernorm", "apply_norm", "init_norm",
           "rope_freqs", "apply_rope", "sinusoidal_positions", "swiglu", "init_mlp",
           "apply_mlp", "embed", "apply_linear", "seeded_normal"]


def apply_weight(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ w for a dense tensor OR any deployed-format weight object with
    an ``apply`` method (``serving.slr_params.SLRLinear`` / ``SLRLayerView``,
    ``serving.adapters.AdapterizedLinear`` and its layer view), which gets x
    in its own (B, T, K) shape."""
    if hasattr(w, "apply"):
        return w.apply(x)
    return x @ w


# elements drawn by one child generator in ``seeded_normal``
_INIT_CHUNK = 1 << 24


def seeded_normal(seed: int, device, dtype):
    """``normal(shape, scale)``: standard normals times ``scale`` as a
    ``dtype`` tensor on ``device``. The values come from numpy: ``seed``'s
    SeedSequence spawns one child generator per 2**24-element chunk of each
    leaf, in call order, and the chunks fill in parallel threads (billions
    of parameters at full width), so the values do not depend on the number
    of threads, and the CPU and the card draw the same weights."""
    seq = np.random.SeedSequence(seed)

    def normal(shape, scale):
        out = np.empty(int(np.prod(shape)), np.float32)
        kids = seq.spawn(-(-out.size // _INIT_CHUNK))

        def fill(i):
            part = out[i * _INIT_CHUNK:(i + 1) * _INIT_CHUNK]
            np.random.default_rng(kids[i]).standard_normal(out=part, dtype=np.float32)
            part *= np.float32(scale)

        with ThreadPoolExecutor(os.cpu_count()) as pool:
            list(pool.map(fill, range(len(kids))))
        return torch.from_numpy(out.reshape(shape)).to(device=device, dtype=dtype)

    return normal


# ----------------------------------------------------------------- norms ---


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred scale, ``x / rms(x) * (1 + scale)``;
    ``scale=None`` is the scale-free norm of the SSM layers."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


def _standardize(x32: torch.Tensor, eps: float) -> torch.Tensor:
    # population variance, as jnp.var
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return (x32 - mu) * torch.rsqrt(var + eps)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale, no bias)."""
    return _standardize(x.float(), eps).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict | None, norm_type: str) -> torch.Tensor:
    """The config's norm; for rmsnorm, ``params`` None (or empty) means no
    scale."""
    if norm_type == "rmsnorm":
        return rmsnorm(x, params["norm_scale"] if params else None)
    if norm_type == "nonparam_ln":
        return nonparam_layernorm(x)
    if norm_type == "layernorm":
        y = _standardize(x.float(), 1e-5)
        y = y * params["norm_scale"].float() + params["norm_bias"].float()
        return y.to(x.dtype)
    raise ValueError(norm_type)


def init_norm(d: int, norm_type: str, dtype, device, lead: tuple[int, ...] = ()) -> dict:
    """The norm's leaves, stacked over ``lead``: rmsnorm a zero scale,
    nonparam_ln none, layernorm a scale of ones and a zero bias."""
    if norm_type == "rmsnorm":
        return {"norm_scale": torch.zeros((*lead, d), dtype=dtype, device=device)}
    if norm_type == "nonparam_ln":
        return {}
    if norm_type == "layernorm":
        return {"norm_scale": torch.ones((*lead, d), dtype=dtype, device=device),
                "norm_bias": torch.zeros((*lead, d), dtype=dtype, device=device)}
    raise ValueError(norm_type)


# ------------------------------------------------------------- positions ---


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


def sinusoidal_positions(seq: int, d: int, offset: int = 0) -> torch.Tensor:
    """Absolute positions, (seq, d) f32, INTERLEAVED: sin at even columns,
    cos at odd ones (the encoder's layout; computed in numpy's f64 as the
    JAX package does)."""
    pos = np.arange(offset, offset + seq)[:, None]
    div = np.exp(np.arange(0, d, 2) * -(np.log(10000.0) / d))
    pe = np.zeros((seq, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


# ------------------------------------------------------------------- MLP ---


def init_mlp(normal, d: int, d_ff: int, mlp_type: str, dtype, device,
             lead: tuple[int, ...] = ()) -> dict:
    """The MLP's leaves with the JAX package's shapes and scales, stacked
    over ``lead``; ``normal(shape, scale)`` draws the random ones."""
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    if mlp_type in ("swiglu", "geglu"):
        return {"gate": normal((*lead, d, d_ff), s_in), "up": normal((*lead, d, d_ff), s_in),
                "down": normal((*lead, d_ff, d), s_out)}
    if mlp_type == "gelu":
        return {"up": normal((*lead, d, d_ff), s_in),
                "up_bias": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
                "down": normal((*lead, d_ff, d), s_out),
                "down_bias": torch.zeros((*lead, d), dtype=dtype, device=device)}
    raise ValueError(mlp_type)


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(apply_weight(x, params["gate"])) * apply_weight(x, params["up"])
    return apply_weight(h, params["down"])


def apply_mlp(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """swiglu, geglu, or the plain gelu MLP with biases (whisper); both gelus
    take the tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    if mlp_type == "swiglu":
        return swiglu(params, x)
    if mlp_type == "geglu":
        h = F.gelu(apply_weight(x, params["gate"]), approximate="tanh") \
            * apply_weight(x, params["up"])
        return apply_weight(h, params["down"])
    if mlp_type == "gelu":
        h = F.gelu(apply_weight(x, params["up"]) + params["up_bias"], approximate="tanh")
        return apply_weight(h, params["down"]) + params["down_bias"]
    raise ValueError(mlp_type)


# ------------------------------------------------------------- embedding ---


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens]


def apply_linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` plus the bias ``b`` where the leaf dict has one."""
    y = apply_weight(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y
