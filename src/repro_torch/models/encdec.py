"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The audio frontend is a stub: the encoder takes precomputed frame
embeddings (B, frames, d_model). Positions are absolute sinusoids with no
rotation (``rope_theta=None``): the encoder adds the interleaved table of
``layers.sinusoidal_positions`` (sin at even columns), the decoder the
CONCATENATED ``[sin, cos]`` table at each token's position, as the JAX
package does. Decoder layers: causal self-attention, cross-attention over
the encoder output, the gelu MLP.

The tree is the JAX package's: ``embed``, ``encoder`` and ``decoder``
(stacked blocks: ``self/{q,k,v,o}``, ``cross/...`` in the decoder, the
norms, the MLP), ``enc_norm``, ``final_norm``, ``lm_head``. Each stack runs
as a Python loop over layer indices; the ``bsr`` deployment unrolls both
stacks into lists of per-layer dicts, which the same loops walk.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .attention import KVCache, attention_block
from .layers import (apply_mlp, apply_norm, apply_weight, embed, init_mlp, init_norm,
                     seeded_normal, sinusoidal_positions)
from .transformer import layer_view

__all__ = ["EncDecCache", "init_encdec", "encode", "decode_stack", "forward",
           "init_encdec_cache", "cross_kv"]


class EncDecCache(NamedTuple):
    """Decode cache; axis 1 of every tensor is the batch."""

    k: torch.Tensor         # (L, B, Hkv, S, D) decoder self-attention cache
    v: torch.Tensor
    cross_k: torch.Tensor   # (L, B, Hkv, F, D) from the encoder output
    cross_v: torch.Tensor
    length: int             # valid prefix (a host integer)


def _init_stack(normal, cfg, num: int, cross: bool, device) -> dict:
    dt, d, hd = cfg.param_dtype, cfg.d_model, cfg.head_dim
    lead = (num,)

    def qkv():
        s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(cfg.num_heads * hd)
        return {"q": normal((num, d, cfg.num_heads * hd), s),
                "k": normal((num, d, cfg.num_kv_heads * hd), s),
                "v": normal((num, d, cfg.num_kv_heads * hd), s),
                "o": normal((num, cfg.num_heads * hd, d), so)}

    p = {"self": qkv(), "pre_self": init_norm(d, cfg.norm_type, dt, device, lead)}
    if cross:
        p["cross"] = qkv()
        p["pre_cross"] = init_norm(d, cfg.norm_type, dt, device, lead)
    p["pre_mlp"] = init_norm(d, cfg.norm_type, dt, device, lead)
    p.update(init_mlp(normal, d, cfg.d_ff, cfg.mlp_type, dt, device, lead))
    return p


def init_encdec(cfg, seed: int, device) -> dict:
    dt, d = cfg.param_dtype, cfg.d_model
    normal = seeded_normal(seed, device, dt)
    return {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "encoder": _init_stack(normal, cfg, cfg.encoder_layers, False, device),
        "decoder": _init_stack(normal, cfg, cfg.num_layers, True, device),
        "enc_norm": init_norm(d, cfg.norm_type, dt, device),
        "final_norm": init_norm(d, cfg.norm_type, dt, device),
        "lm_head": {"w": normal((d, cfg.vocab_size), 1.0 / np.sqrt(d))},
    }


def _layer(stack, l: int) -> dict:
    return stack[l] if isinstance(stack, (list, tuple)) else layer_view(stack, l)


def _attn(cfg, lp, h, **kw):
    return attention_block(lp, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                           head_dim=cfg.head_dim, rope_theta=None,
                           kernel_impl=cfg.kernel_impl, **kw)


def _enc_layer(lp, x, cfg):
    h = apply_norm(x, lp.get("pre_self"), cfg.norm_type)
    out, _ = _attn(cfg, lp["self"], h, causal=False, q_block=cfg.attn_q_block,
                   kv_block=cfg.attn_kv_block)
    x = x + out
    h = apply_norm(x, lp.get("pre_mlp"), cfg.norm_type)
    return x + apply_mlp(lp, h, cfg.mlp_type)


def encode(params: dict, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings -> encoder hidden states."""
    _, f, d = frames.shape
    x = frames + sinusoidal_positions(f, d).to(frames.device, frames.dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.encoder_layers):
        lp = _layer(params["encoder"], l)
        x = checkpoint(_enc_layer, lp, x, cfg, use_reentrant=False) if remat \
            else _enc_layer(lp, x, cfg)
    return apply_norm(x, params.get("enc_norm"), cfg.norm_type)


def cross_kv(lp_cross: dict, enc_out: torch.Tensor, cfg):
    """The cross-attention heads (B, Hkv, F, D) of one decoder layer."""
    b, f, _ = enc_out.shape
    k = apply_weight(enc_out, lp_cross["k"]).reshape(b, f, cfg.num_kv_heads, cfg.head_dim)
    v = apply_weight(enc_out, lp_cross["v"]).reshape(b, f, cfg.num_kv_heads, cfg.head_dim)
    return k.transpose(1, 2), v.transpose(1, 2)


def _dec_layer(lp, x, cfg, positions, self_cache, ckv, blocks):
    h = apply_norm(x, lp.get("pre_self"), cfg.norm_type)
    out, kv = _attn(cfg, lp["self"], h, positions=positions, causal=True, cache=self_cache,
                    **blocks)
    x = x + out
    h = apply_norm(x, lp.get("pre_cross"), cfg.norm_type)
    out, _ = _attn(cfg, lp["cross"], h, causal=False, kv_override=ckv, **blocks)
    x = x + out
    h = apply_norm(x, lp.get("pre_mlp"), cfg.norm_type)
    return x + apply_mlp(lp, h, cfg.mlp_type), kv


def decode_stack(params: dict, tokens: torch.Tensor, enc_out, cfg,
                 cache: EncDecCache | None = None, position_offset=0):
    """Decoder forward. Without a cache the cross heads come from
    ``enc_out``; with one, from the cache, and the self-attention KV
    inserts at ``cache.length`` in place. Returns (logits, new cache or
    None)."""
    t = tokens.shape[1]
    x = embed(params["embed"], tokens)
    positions = position_offset + torch.arange(t, device=x.device)[None, :]
    d = cfg.d_model
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
                    * (-np.log(10000.0) / d))
    ang = positions[..., None].float() * div
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(x.dtype)
    # the JAX package's cached decoder keeps the attention's default blocks
    blocks = {} if cache is not None else dict(q_block=cfg.attn_q_block,
                                               kv_block=cfg.attn_kv_block)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for l in range(cfg.num_layers):
        lp = _layer(params["decoder"], l)
        if cache is None:
            ckv = cross_kv(lp["cross"], enc_out, cfg)
            if remat:
                x, _ = checkpoint(_dec_layer, lp, x, cfg, positions, None, ckv, blocks,
                                  use_reentrant=False)
            else:
                x, _ = _dec_layer(lp, x, cfg, positions, None, ckv, blocks)
        else:
            x, _ = _dec_layer(lp, x, cfg, positions,
                              KVCache(cache.k[l], cache.v[l], cache.length),
                              (cache.cross_k[l], cache.cross_v[l]), blocks)
    x = apply_norm(x, params.get("final_norm"), cfg.norm_type)
    logits = apply_weight(x, params["lm_head"]["w"])
    if cache is None:
        return logits, None
    return logits, cache._replace(length=cache.length + t)


def forward(params: dict, tokens: torch.Tensor, cfg, *, frames=None,
            cache: EncDecCache | None = None, position_offset=0):
    """(logits, cache or encoder output, aux 0): without a cache the frames
    (zeros of ``encoder_seq`` frames when None) are encoded first; with one
    the cross heads are the cache's."""
    if cache is None:
        if frames is None:
            # a tokens-only batch (the trainer's SyntheticC4): zero frames
            # through the stub frontend (the JAX package's encode raises here)
            frames = torch.zeros((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                                 dtype=cfg.param_dtype, device=tokens.device)
        enc_out = encode(params, frames, cfg)
        logits, _ = decode_stack(params, tokens, enc_out, cfg, position_offset=position_offset)
        return logits, enc_out, torch.zeros((), device=logits.device)
    logits, new_cache = decode_stack(params, tokens, None, cfg, cache=cache,
                                     position_offset=position_offset)
    return logits, new_cache, torch.zeros((), device=logits.device)


@torch.no_grad()
def init_encdec_cache(params, cfg, batch: int, max_len: int, enc_out=None,
                      dtype=torch.bfloat16, device=None) -> EncDecCache:
    """Zeroed self-attention cache; the cross heads of every decoder layer
    from ``enc_out``, or zeros over ``encoder_seq`` frames when it is None
    (the reference engine's cache, as in the JAX package)."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if enc_out is None:
        cshape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)
        ck = torch.zeros(cshape, dtype=dtype, device=device)
        cv = torch.zeros(cshape, dtype=dtype, device=device)
    else:
        device = enc_out.device
        heads = [cross_kv(_layer(params["decoder"], l)["cross"], enc_out, cfg)
                 for l in range(cfg.num_layers)]
        ck = torch.stack([k for k, _ in heads]).to(dtype)
        cv = torch.stack([v for _, v in heads]).to(dtype)
    return EncDecCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       cross_k=ck, cross_v=cv, length=0)
