"""Decoder-only transformer LM (dense, MoE, and the VLM backbone) with a
paged or a contiguous KV cache (port of ``repro/models/transformer.py``).

Parameters keep the JAX package's tree: ``embed/embedding``, ``layers/...``
stacked on a leading layer axis (q/k/v/o with ``q_bias``/``k_bias``/
``v_bias`` under ``qkv_bias``; the norms' leaves, none for ``nonparam_ln``;
the MLP's, or ``moe/router`` and ``moe/experts/{gate,up,down}`` for the MoE
family), ``final_norm`` and ``lm_head/w`` (absent under ``tie_embeddings``:
the head is then ``embedding.T``). The VLM's patch stub enters as
``prefix_embeds``, concatenated before the sqrt(d)-scaled token
embeddings. The layer stack runs as a Python loop over layer indices -
the counterpart of JAX's scan by index: ``layer_view`` hands each layer plain
tensor slices and, for stacked fused SLR weights and pooled adapter sites
(``serving/adapters.py``), an ``at_layer`` view that keeps the stacked tables
whole and passes the layer index to the kernel. Every view's ``apply`` takes
the (B, T, K) activations as they are: a batched adapter site selects its
tables per slot, so rows are never flattened across slots on its way. The
``bsr`` format unrolls ``layers`` into a list of per-layer dicts, which the
same loop walks directly (JAX's ``_forward_unrolled``).

The no-cache path is what training differentiates: it writes nothing in
place, the per-layer slices accumulate their gradients into the stacked
leaves, and under ``cfg.remat`` each layer runs inside
``torch.utils.checkpoint`` (its activations are recomputed in the backward
pass, as ``jax.checkpoint`` recomputes them in the JAX package).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel.sharding import current_mesh
from .attention import KVCache, PagedLayerCache, attention_block
from .layers import apply_mlp, apply_norm, apply_weight, embed, init_mlp, init_norm, seeded_normal
from .moe import DropCounter, init_moe, moe_ffn
from ..serving.kv_quant import quantize_kv

__all__ = ["LMCache", "PagedKVCache", "init_lm", "layer_view", "forward", "init_cache",
           "cache_from_prefill", "init_paged_cache", "lm_head", "scatter_prefill_pages",
           "copy_cache_pages"]


class LMCache(NamedTuple):
    """Contiguous decode cache: positions 0 .. length - 1 of every row are
    valid; axis 1 of k and v is the batch. ``length`` is a host integer (the
    reference engine's) or a (B,) int32 tensor of per-slot lengths (the
    slot-padded ``ServingEngine``'s)."""

    k: torch.Tensor   # (L, B, Hkv, S, D)
    v: torch.Tensor
    length: int | torch.Tensor


class PagedKVCache(NamedTuple):
    """Block-paged serving cache: a fixed pool of pages per layer plus a
    per-slot block table shared by all layers. Position j of slot b lives in
    page ``block_table[b, j // block_size]``, offset ``j % block_size``;
    entries ``>= num_pages`` are unmapped. Int8 pools carry per-(position,
    head) scale pools in ``k_scale``/``v_scale`` (``serving/kv_quant.py``);
    None means float pages."""

    k: torch.Tensor            # (L, num_pages, Hkv, block_size, D)
    v: torch.Tensor
    block_table: torch.Tensor  # (max_slots, pages_per_slot) int32
    length: torch.Tensor       # (max_slots,) int32
    k_scale: torch.Tensor | None = None   # (L, num_pages, Hkv, block_size, 1) f32
    v_scale: torch.Tensor | None = None

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


def init_lm(cfg, seed: int, device) -> dict:
    """Random weights with the JAX package's shapes and scales (other
    values: ``layers.seeded_normal`` draws them from ``seed``)."""
    dt = cfg.param_dtype
    num_l, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    normal = seeded_normal(seed, device, dt)
    lead = (num_l,)
    layers = {
        "q": normal((num_l, d, cfg.num_heads * hd), 1.0 / np.sqrt(d)),
        "k": normal((num_l, d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "v": normal((num_l, d, cfg.num_kv_heads * hd), 1.0 / np.sqrt(d)),
        "o": normal((num_l, cfg.num_heads * hd, d), 1.0 / np.sqrt(cfg.num_heads * hd)),
        "pre_attn": init_norm(d, cfg.norm_type, dt, device, lead),
        "pre_mlp": init_norm(d, cfg.norm_type, dt, device, lead),
    }
    if cfg.qkv_bias:
        for name, width in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                            ("v", cfg.num_kv_heads)):
            layers[f"{name}_bias"] = torch.zeros((num_l, width * hd), dtype=dt, device=device)
    if cfg.num_experts:
        layers["moe"] = init_moe(normal, d, cfg.d_ff, cfg.num_experts, dt, device, lead)
    else:
        layers.update(init_mlp(normal, d, cfg.d_ff, cfg.mlp_type, dt, device, lead))
    params = {
        "embed": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "layers": layers,
        "final_norm": init_norm(d, cfg.norm_type, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal((d, cfg.vocab_size), 1.0 / np.sqrt(d))}
    return params


def lm_head(params: dict):
    """The output projection: ``lm_head/w``, or the embedding's transpose
    under tied embeddings."""
    return params["lm_head"]["w"] if "lm_head" in params else params["embed"]["embedding"].T


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


def _layer_apply(lp: dict, x, cfg, positions, cache, drops=None, rows=None):
    """One layer; returns (x, aux loss, kv or new layer cache)."""
    h = apply_norm(x, lp.get("pre_attn"), cfg.norm_type)
    attn_out, kv = attention_block(
        lp, h, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
        positions=positions, rope_theta=cfg.rope_theta, causal=True, cache=cache,
        kernel_impl=cfg.kernel_impl, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
        causal_scheme=cfg.causal_scheme, rows=rows,
    )
    x = x + attn_out
    h = apply_norm(x, lp.get("pre_mlp"), cfg.norm_type)
    if cfg.num_experts:
        out, aux = moe_ffn(lp["moe"], h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor, num_groups=cfg.moe_groups,
                           drops=drops, rows=rows)
    else:
        out, aux = apply_mlp(lp, h, cfg.mlp_type), torch.zeros((), device=x.device)
    return x + out, aux, kv


def forward(params: dict, tokens: torch.Tensor, cfg, *,
            prefix_embeds: torch.Tensor | None = None,
            cache: PagedKVCache | LMCache | None = None, position_offset=0,
            collect_kv: bool = False,
            drops: DropCounter | None = None,
            rows=None) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """(logits (B, T', vocab), new cache or stacked KV heads, aux loss):
    T' counts the ``prefix_embeds`` rows (B, P, d) in front of the tokens;
    the aux loss is the MoE load-balance term summed over layers (0 for the
    other families). ``drops`` counts the pairs the MoE capacity dropped.

    * no cache: the second value is the stacked ``(kh, vh)`` heads, each
      (L, B, Hkv, T', D), when ``collect_kv`` (one-shot prefill), else None;
    * paged cache: tokens insert at each slot's length; the pools update in
      place and the returned cache carries ``length + T``;
    * contiguous cache: the same at its one length or at each row's, in
      place (per-slot writes past the buffer drop).

    Under a serving mesh with a data axis (``parallel/sharding.py``) this
    rank computes its share of the rows: the new K/V rows of each layer are
    gathered before the cache insert (the pools hold every row) and the
    logits and collected heads are gathered at the end. A data-parallel
    train step passes its ``BatchShard`` as ``rows``: the batch is this
    rank's rows already.
    """
    x = embed(params["embed"], tokens)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, t, _ = x.shape
    offset = torch.as_tensor(position_offset, device=x.device)
    steps = torch.arange(t, device=x.device)
    positions = offset[:, None] + steps[None, :] if offset.dim() else offset + steps[None, :]
    mesh = current_mesh()
    if rows is None and mesh is not None:
        rows = mesh.row_split(b)
    if rows is not None:
        x = rows.take(x)
        if positions.shape[0] == b:
            positions = rows.take(positions)

    layers = params["layers"]
    unrolled = isinstance(layers, (list, tuple))
    kvs = []
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and cache is None and not collect_kv and torch.is_grad_enabled()
    for l in range(cfg.num_layers):
        lp = layers[l] if unrolled else layer_view(layers, l)
        layer_cache = None
        if isinstance(cache, LMCache):
            layer_cache = KVCache(cache.k[l], cache.v[l], cache.length)
        elif cache is not None:
            quant = cache.k_scale is not None
            layer_cache = PagedLayerCache(cache.k[l], cache.v[l], cache.block_table,
                                          cache.length,
                                          cache.k_scale[l] if quant else None,
                                          cache.v_scale[l] if quant else None)
        if remat:
            x, a, kv = checkpoint(_layer_apply, lp, x, cfg, positions, None, None, rows,
                                  use_reentrant=False)
        else:
            x, a, kv = _layer_apply(lp, x, cfg, positions, layer_cache, drops, rows)
        aux = aux + a
        if cache is None and collect_kv:
            kvs.append(kv)

    x = apply_norm(x, params.get("final_norm"), cfg.norm_type)
    logits = apply_weight(x, lm_head(params))
    if rows is not None:
        logits = rows.gather(logits)
    if cache is not None:
        return logits, cache._replace(length=cache.length + t), aux
    if collect_kv:
        kh, vh = torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])
        if rows is not None:
            kh, vh = rows.gather(kh, dim=1), rows.gather(vh, dim=1)
        return logits, (kh, vh), aux
    return logits, None, aux


def init_cache(cfg, batch: int, max_len: int, dtype, device,
               per_slot: bool = False) -> LMCache:
    """Zeroed contiguous cache at length 0: one host length, or with
    ``per_slot`` a (batch,) int32 tensor of lengths."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device) if per_slot else 0
    return LMCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=length)


def cache_from_prefill(kvs, max_len: int, dtype) -> LMCache:
    """An LMCache from ``forward``'s stacked prefill heads (L, B, Hkv, T, D);
    a VLM prefill's T counts the patch prefix and may pass ``max_len``, and
    the cache then grows to hold it."""
    kh, vh = kvs
    t = kh.shape[3]
    pad = (0, 0, 0, max(max_len - t, 0))
    return LMCache(k=torch.nn.functional.pad(kh.to(dtype), pad),
                   v=torch.nn.functional.pad(vh.to(dtype), pad), length=t)


def init_paged_cache(cfg, max_slots: int, num_pages: int, block_size: int,
                     pages_per_slot: int, dtype, device, quantized: bool = False) -> PagedKVCache:
    """Fixed page pool per layer; the whole block table starts unmapped.
    ``quantized`` makes int8 payload pools with f32 scale pools (``dtype`` is
    then the activations', not the pages')."""
    pool = (cfg.num_layers, num_pages, cfg.num_kv_heads, block_size, cfg.head_dim)
    payload = torch.int8 if quantized else dtype

    def scales():
        return torch.zeros(pool[:-1] + (1,), dtype=torch.float32, device=device) \
            if quantized else None

    return PagedKVCache(
        k=torch.zeros(pool, dtype=payload, device=device),
        v=torch.zeros(pool, dtype=payload, device=device),
        block_table=torch.full((max_slots, pages_per_slot), num_pages, dtype=torch.int32,
                               device=device),
        length=torch.zeros((max_slots,), dtype=torch.int32, device=device),
        k_scale=scales(), v_scale=scales(),
    )


def scatter_prefill_pages(cache: PagedKVCache, kvs, page_map: torch.Tensor) -> PagedKVCache:
    """Write whole prompt blocks into the page pools, in place.

    ``kvs`` are the stacked prefill heads (L, B, Hkv, T, D) with T a multiple
    of the block size; ``page_map`` (B, T // bs) names each block's page, and
    entries ``>= num_pages`` drop. Int8 pools take each row quantized.
    """
    kh, vh = kvs
    num_l, b, h, t, d = kh.shape
    bs = cache.block_size
    if t % bs:
        raise ValueError(f"prefill length {t} is not a multiple of block size {bs}")
    pages = page_map.reshape(-1).long()
    keep = pages < cache.num_pages
    for pool, scales, heads in ((cache.k, cache.k_scale, kh), (cache.v, cache.v_scale, vh)):
        chunks = heads.reshape(num_l, b, h, t // bs, bs, d).permute(0, 1, 3, 2, 4, 5)
        chunks = chunks.reshape(num_l, -1, h, bs, d)[:, keep]
        if scales is not None:
            chunks, sc = quantize_kv(chunks)
            scales[:, pages[keep]] = sc
        pool[:, pages[keep]] = chunks.to(pool.dtype)
    return cache


def copy_cache_pages(cache: PagedKVCache, src: torch.Tensor, dst: torch.Tensor) -> PagedKVCache:
    """Copy whole pages ``src[i] -> dst[i]`` of every layer in every pool the
    cache carries (k, v and, for int8 pages, both scale pools: a page copied
    without its scales would dequantize garbage), in place, through the
    page-copy kernel: the device half of prefix-cache copy-on-write (the
    engine remaps its block table to ``dst`` host-side)."""
    for pool in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if pool is not None:
            ops.page_copy(pool, src, dst)
    return cache
