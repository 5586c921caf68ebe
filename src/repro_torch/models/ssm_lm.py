"""Mamba2 decoder-only LM: attention-free, a stack of SSD blocks (port of
``repro/models/ssm_lm.py``).

The tree is the JAX package's: ``embed/embedding`` (tokens are not scaled),
``layers/...`` stacked on a leading layer axis (``models/ssm.py``'s block
leaves), ``final_norm`` and ``lm_head/w``. Each layer is a residual SSD
block on the scale-free RMSNorm of its input; the final norm is the
config's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .layers import apply_norm, apply_weight, embed, init_norm, rmsnorm, seeded_normal
from .ssm import SSMCache, init_ssm_layer, ssm_block, ssm_dims

__all__ = ["SSMLMCache", "init_ssm_lm", "forward", "init_ssm_lm_cache"]


class SSMLMCache(NamedTuple):
    """Decode state; axis 1 of both tensors is the batch."""

    state: torch.Tensor   # (L, B, H, P, N)
    conv: torch.Tensor    # (L, B, 3, conv_dim)
    length: int           # tokens seen (a host integer)


def init_ssm_lm(cfg, seed: int, device) -> dict:
    dt, d = cfg.param_dtype, cfg.d_model
    normal = seeded_normal(seed, device, dt)
    return {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "layers": init_ssm_layer(normal, d, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state,
                                 dt, device, lead=(cfg.num_layers,)),
        "final_norm": init_norm(d, cfg.norm_type, dt, device),
        "lm_head": {"w": normal((d, cfg.vocab_size), 1.0 / np.sqrt(d))},
    }


def _block(lp: dict, x, cfg, cache):
    out, nc = ssm_block(lp, rmsnorm(x, None), expand=cfg.ssm_expand,
                        head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                        chunk=cfg.ssm_chunk, cache=cache)
    return x + out, nc


def forward(params: dict, tokens: torch.Tensor, cfg, *, cache: SSMLMCache | None = None,
            position_offset=0) -> tuple[torch.Tensor, SSMLMCache | None, torch.Tensor]:
    """(logits (B, T, vocab), new cache or None, aux 0). With a cache the T
    tokens continue each layer's state and conv window (recurrently for
    T == 1); the new cache holds fresh tensors at ``length + T``."""
    layers = params["layers"]
    x = embed(params["embed"], tokens)
    t = x.shape[1]
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    states, convs = [], []
    for l in range(cfg.num_layers):
        lp = {k: v[l] for k, v in layers.items()}
        if cache is None:
            if remat:
                x, _ = checkpoint(_block, lp, x, cfg, None, use_reentrant=False)
            else:
                x, _ = _block(lp, x, cfg, None)
            continue
        x, nc = _block(lp, x, cfg, SSMCache(cache.state[l], cache.conv[l], cache.length))
        states.append(nc.state)
        convs.append(nc.conv)
    x = apply_norm(x, params.get("final_norm"), cfg.norm_type)
    logits = apply_weight(x, params["lm_head"]["w"])
    aux = torch.zeros((), device=x.device)
    if cache is None:
        return logits, None, aux
    return logits, SSMLMCache(torch.stack(states), torch.stack(convs), cache.length + t), aux


def init_ssm_lm_cache(cfg, batch: int, dtype=torch.bfloat16, device=None) -> SSMLMCache:
    _, nheads, conv_dim = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    return SSMLMCache(
        state=torch.zeros((cfg.num_layers, batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=dtype, device=device),
        conv=torch.zeros((cfg.num_layers, batch, 3, conv_dim), dtype=dtype, device=device),
        length=0,
    )
