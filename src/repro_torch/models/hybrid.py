"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention + MLP
block applied after every ``attn_every`` SSM layers (port of
``repro/models/hybrid.py``).

The parameter tree is the JAX package's: ``ssm_layers`` holds nested
(G, E, ...) stacks, G = num_layers / attn_every groups of E = attn_every
layers; ``shared_attn`` holds the one block's 2-D weights, read once for all
G applications (SALAAD counts it once, as the architecture shares it). The
forward walks the groups and, inside each, the group's SSM layers in Python
loops (JAX's outer and inner scans), then applies the shared block.

The shared block's linear sites are 2-D leaves, so the ``fused`` deployment
serves them as per-matrix fused weights (``kernels/ops.slr_matmul``); the SSM
projections are read as plain tensors (deployment materializes them).

Under ``cfg.remat``, with gradients on and no cache, each SSM layer and each
whole group (its SSM layers, then the shared attention and MLP block) run
inside ``torch.utils.checkpoint``, as the JAX package checkpoints them: the
group alone would recompute all of its layers' SSD internals at once in the
backward, and an unchecked shared block would keep its residuals alive
across every application.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .attention import KVCache, attention_block
from .layers import apply_mlp, apply_norm, apply_weight, embed, rmsnorm, seeded_normal
from .ssm import SSMCache, init_ssm_layer, ssm_block, ssm_dims

__all__ = ["HybridCache", "init_hybrid", "forward", "init_hybrid_cache"]


class HybridCache(NamedTuple):
    """Contiguous decode cache; axis 1 of every tensor is the batch."""

    ssm_state: torch.Tensor   # (L, B, H, P, N)
    conv: torch.Tensor        # (L, B, 3, conv_dim)
    k: torch.Tensor           # (G, B, Hkv, S, D) shared-attn cache per application
    v: torch.Tensor
    length: int               # valid prefix (a host integer)


def init_hybrid(cfg, seed: int, device) -> dict:
    """Random weights with the JAX package's shapes and scales, drawn by
    ``layers.seeded_normal`` (2.7e9 parameters at full width)."""
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple of "
                         f"attn_every={cfg.attn_every}")
    g = cfg.num_layers // cfg.attn_every
    dt, d, hd = cfg.param_dtype, cfg.d_model, cfg.head_dim
    normal = seeded_normal(seed, device, dt)

    def norm():
        return {"norm_scale": torch.zeros((d,), dtype=dt, device=device)}

    ssm_layers = init_ssm_layer(normal, d, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state, dt,
                                device, lead=(g, cfg.attn_every))
    shared = {
        "q": normal((d, cfg.num_heads * hd), 1.0 / np.sqrt(d)),
        "k": normal((d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "v": normal((d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "o": normal((cfg.num_heads * hd, d), 1.0 / np.sqrt(cfg.num_heads * hd)),
        "pre_attn": norm(),
        "pre_mlp": norm(),
        "gate": normal((d, cfg.d_ff), 1.0 / np.sqrt(d)),
        "up": normal((d, cfg.d_ff), 1.0 / np.sqrt(d)),
        "down": normal((cfg.d_ff, d), 1.0 / np.sqrt(cfg.d_ff)),
    }
    return {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "ssm_layers": ssm_layers,
        "shared_attn": shared,
        "final_norm": norm(),
        "lm_head": {"w": normal((d, cfg.vocab_size), 1.0 / np.sqrt(d))},
    }


def _ssm_layer(lp: dict, x: torch.Tensor, cfg, layer_cache: SSMCache | None = None):
    out, nc = ssm_block(lp, rmsnorm(x, None), expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                        d_state=cfg.ssm_state, chunk=cfg.ssm_chunk, cache=layer_cache)
    return x + out, nc


def _shared_block(shared: dict, x: torch.Tensor, cfg, positions, att_cache=None):
    h = apply_norm(x, shared.get("pre_attn"), cfg.norm_type)
    attn_out, _ = attention_block(
        shared, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_theta=cfg.rope_theta, cache=att_cache,
        kernel_impl=cfg.kernel_impl, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
        causal_scheme=cfg.causal_scheme)
    x = x + attn_out
    h = apply_norm(x, shared.get("pre_mlp"), cfg.norm_type)
    return x + apply_mlp(shared, h, cfg.mlp_type)


def _group(glp: dict, shared: dict, x: torch.Tensor, cfg, positions, remat: bool):
    """One group without a cache: its SSM layers, then the shared block;
    under ``remat`` each SSM layer is checkpointed."""
    for ei in range(cfg.attn_every):
        lp = {k: v[ei] for k, v in glp.items()}
        if remat:
            x, _ = checkpoint(_ssm_layer, lp, x, cfg, use_reentrant=False)
        else:
            x, _ = _ssm_layer(lp, x, cfg)
    return _shared_block(shared, x, cfg, positions)


def forward(params: dict, tokens: torch.Tensor, cfg, *, cache: HybridCache | None = None,
            position_offset=0) -> tuple[torch.Tensor, HybridCache | None]:
    """(logits (B, T, vocab), new cache or None).

    With a cache the tokens sit at ``cache.length``: the SSM layers step
    their states (recurrently for T == 1, chunked otherwise) and the shared
    block writes its KV into the cache's per-application slice in place; the
    new cache carries fresh state and conv tensors and ``length + T``.
    """
    g, e_per = cfg.num_layers // cfg.attn_every, cfg.attn_every
    x = embed(params["embed"], tokens)
    t = x.shape[1]
    positions = position_offset + torch.arange(t, device=x.device)[None, :]
    shared = params["shared_attn"]
    ssm = params["ssm_layers"]
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        for gi in range(g):
            glp = {k: v[gi] for k, v in ssm.items()}
            if remat:
                x = checkpoint(_group, glp, shared, x, cfg, positions, True,
                               use_reentrant=False)
            else:
                x = _group(glp, shared, x, cfg, positions, False)
    else:
        states, convs = [], []
        for gi in range(g):
            for ei in range(e_per):
                l_idx = gi * e_per + ei
                lp = {k: v[gi, ei] for k, v in ssm.items()}
                x, nc = _ssm_layer(lp, x, cfg, SSMCache(cache.ssm_state[l_idx],
                                                        cache.conv[l_idx], cache.length))
                states.append(nc.state)
                convs.append(nc.conv)
            att_cache = KVCache(cache.k[gi], cache.v[gi], cache.length)
            x = _shared_block(shared, x, cfg, positions, att_cache)

    x = apply_norm(x, params.get("final_norm"), cfg.norm_type)
    logits = apply_weight(x, params["lm_head"]["w"])
    if cache is None:
        return logits, None
    return logits, HybridCache(torch.stack(states), torch.stack(convs), cache.k, cache.v,
                               cache.length + t)


def init_hybrid_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> HybridCache:
    g = cfg.num_layers // cfg.attn_every
    _, nheads, conv_dim = ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    kv = (g, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return HybridCache(
        ssm_state=torch.zeros((cfg.num_layers, batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                              dtype=dtype, device=device),
        conv=torch.zeros((cfg.num_layers, batch, 3, conv_dim), dtype=dtype, device=device),
        k=torch.zeros(kv, dtype=dtype, device=device),
        v=torch.zeros(kv, dtype=dtype, device=device),
        length=0,
    )
