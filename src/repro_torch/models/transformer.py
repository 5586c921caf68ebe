"""Decoder-only dense transformer LM with a paged KV cache (port of the dense
part of ``repro/models/transformer.py``).

Parameters keep the JAX package's tree: ``embed/embedding``, ``layers/...``
stacked on a leading layer axis, ``final_norm/norm_scale`` and
``lm_head/w``. The layer stack runs as a Python loop over layer indices -
the counterpart of JAX's scan by index: ``layer_view`` hands each layer plain
tensor slices and, for stacked fused SLR weights, an ``SLRLayerView`` that
keeps the stacked tables whole and passes the layer index to the kernel.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .attention import PagedLayerCache, attention_block
from .layers import apply_weight, embed, rmsnorm, swiglu

__all__ = ["PagedKVCache", "init_lm", "layer_view", "forward", "init_paged_cache",
           "scatter_prefill_pages"]


class PagedKVCache(NamedTuple):
    """Block-paged serving cache: a fixed pool of pages per layer plus a
    per-slot block table shared by all layers. Position j of slot b lives in
    page ``block_table[b, j // block_size]``, offset ``j % block_size``;
    entries ``>= num_pages`` are unmapped."""

    k: torch.Tensor            # (L, num_pages, Hkv, block_size, D)
    v: torch.Tensor
    block_table: torch.Tensor  # (max_slots, pages_per_slot) int32
    length: torch.Tensor       # (max_slots,) int32

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def init_lm(cfg, seed: int, device) -> dict:
    """Random weights with the JAX package's shapes and scales (other values:
    they come from numpy's generator, seeded with ``seed``)."""
    rng = np.random.default_rng(seed)
    dt = cfg.param_dtype
    num_l, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "q": normal((num_l, d, cfg.num_heads * hd), 1.0 / np.sqrt(d)),
        "k": normal((num_l, d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "v": normal((num_l, d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "o": normal((num_l, cfg.num_heads * hd, d), 1.0 / np.sqrt(cfg.num_heads * hd)),
        "pre_attn": {"norm_scale": zeros(num_l, d)},
        "pre_mlp": {"norm_scale": zeros(num_l, d)},
        "gate": normal((num_l, d, cfg.d_ff), 1.0 / np.sqrt(d)),
        "up": normal((num_l, d, cfg.d_ff), 1.0 / np.sqrt(d)),
        "down": normal((num_l, cfg.d_ff, d), 1.0 / np.sqrt(cfg.d_ff)),
    }
    return {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "layers": layers,
        "final_norm": {"norm_scale": zeros(d)},
        "lm_head": {"w": normal((d, cfg.vocab_size), 1.0 / np.sqrt(d))},
    }


def layer_view(layers: dict, l: int) -> dict:
    """Layer ``l`` of the stacked layer tree: tensors are sliced, deployed
    weights give their ``at_layer(l)`` view."""
    out = {}
    for k, v in layers.items():
        if isinstance(v, dict):
            out[k] = layer_view(v, l)
        elif hasattr(v, "at_layer"):
            out[k] = v.at_layer(l)
        else:
            out[k] = v[l]
    return out


def _layer_apply(lp: dict, x, cfg, positions, cache):
    h = rmsnorm(x, lp["pre_attn"]["norm_scale"])
    attn_out, kv = attention_block(
        lp, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_theta=cfg.rope_theta, cache=cache,
        kernel_impl=cfg.kernel_impl,
    )
    x = x + attn_out
    h = rmsnorm(x, lp["pre_mlp"]["norm_scale"])
    return x + swiglu(lp, h), kv


def forward(params: dict, tokens: torch.Tensor, cfg, *,
            cache: PagedKVCache | None = None, position_offset=0,
            collect_kv: bool = False) -> tuple[torch.Tensor, Any]:
    """(logits (B, T, vocab), new cache or stacked KV heads).

    * no cache: the second value is the stacked ``(kh, vh)`` heads, each
      (L, B, Hkv, T, D), when ``collect_kv`` (one-shot prefill), else None;
    * paged cache: tokens insert at each slot's length; the pools update in
      place and the returned cache carries ``length + T``.
    """
    x = embed(params["embed"], tokens)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    b, t, _ = x.shape
    offset = torch.as_tensor(position_offset, device=x.device)
    steps = torch.arange(t, device=x.device)
    positions = offset[:, None] + steps[None, :] if offset.dim() else offset + steps[None, :]

    layers = params["layers"]
    kvs = []
    for l in range(cfg.num_layers):
        lp = layer_view(layers, l)
        layer_cache = None
        if cache is not None:
            layer_cache = PagedLayerCache(cache.k[l], cache.v[l], cache.block_table,
                                          cache.length)
        x, kv = _layer_apply(lp, x, cfg, positions, layer_cache)
        if cache is None and collect_kv:
            kvs.append(kv)

    x = rmsnorm(x, params["final_norm"]["norm_scale"])
    logits = apply_weight(x, params["lm_head"]["w"])
    if cache is not None:
        return logits, cache._replace(length=cache.length + t)
    if collect_kv:
        return logits, (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    return logits, None


def init_paged_cache(cfg, max_slots: int, num_pages: int, block_size: int,
                     pages_per_slot: int, dtype, device) -> PagedKVCache:
    """Fixed page pool per layer; the whole block table starts unmapped."""
    pool = (cfg.num_layers, num_pages, cfg.num_kv_heads, block_size, cfg.head_dim)
    return PagedKVCache(
        k=torch.zeros(pool, dtype=dtype, device=device),
        v=torch.zeros(pool, dtype=dtype, device=device),
        block_table=torch.full((max_slots, pages_per_slot), num_pages, dtype=torch.int32,
                               device=device),
        length=torch.zeros((max_slots,), dtype=torch.int32, device=device),
    )


def scatter_prefill_pages(cache: PagedKVCache, kvs, page_map: torch.Tensor) -> PagedKVCache:
    """Write whole prompt blocks into the page pools, in place.

    ``kvs`` are the stacked prefill heads (L, B, Hkv, T, D) with T a multiple
    of the block size; ``page_map`` (B, T // bs) names each block's page, and
    entries ``>= num_pages`` drop.
    """
    kh, vh = kvs
    num_l, b, h, t, d = kh.shape
    bs = cache.block_size
    if t % bs:
        raise ValueError(f"prefill length {t} is not a multiple of block size {bs}")
    pages = page_map.reshape(-1).long()
    keep = pages < cache.num_pages
    for pool, heads in ((cache.k, kh), (cache.v, vh)):
        chunks = heads.reshape(num_l, b, h, t // bs, bs, d).permute(0, 1, 3, 2, 4, 5)
        chunks = chunks.reshape(num_l, -1, h, bs, d)
        pool[:, pages[keep]] = chunks[:, keep].to(pool.dtype)
    return cache
