"""DeployedModel: run the transformer on SLR (L + S) weights directly (port
of ``repro/serving/deployed.py``).

Every SALAAD-selected matmul weight (attention q/k/v/o, MLP gate/up/down,
the encoder-decoder's cross-attention) becomes a
:class:`~repro_torch.serving.slr_params.SLRLinear` in the parameter tree, so
the unchanged model code runs ``x @ P @ Vt + x @ S`` at every linear site
through ``models.layers.apply_weight``. Gather sites (the embedding, which a
tied head reads transposed), the MoE routers and experts (every block with
``moe`` in its name: the experts are dispatched by batched products) and the
SSM projections (read as plain tensors by ``models/ssm.py``) are served
dense-materialized; biases stay plain leaves. Formats:

  * ``dense``    - X_hat = L + S materialized
  * ``factored`` - (p, vt) + COO S, plain PyTorch products
  * ``bsr``      - factored L + block-CSC S through the low-rank and
                   block-CSC kernels; the kernels are per matrix, so the
                   layer stack is unrolled into a list of per-layer dicts
                   (``models.transformer.forward`` loops over it)
  * ``fused``    - one fused SLR kernel per linear site with layer-stacked
                   block-CSC tables; the layer loop passes the layer index.
                   A weight outside a layer stack (the hybrid's shared
                   block) gets per-matrix tables and the unstacked kernel

The families follow the JAX package's support matrix: the SSM LM's forward
walks its stacked layer tree, so ``bsr`` (which unrolls it) raises for the
``ssm`` family, and the encoder-decoder cannot take ``fused`` weights (the
JAX forward scans its stacks directly, which fused stacked tables do not
allow), so that raises too. The port's encoder-decoder ``bsr`` holds each
stacked site of the encoder and decoder as a list of per-layer block-CSC
weights, so those sites take the low-rank and block-CSC kernels (the JAX
package keeps them stacked in factored form: the same numbers, other
bytes).
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import sparse
from ..core.admm import SLRState, surrogate_params
from ..core.selection import BlockInfo, path_str
from ..models import model as model_lib
from ..tree import replace_by_path, tree_leaves_with_path
from .slr_params import (
    SLRLinear,
    build_slr_linears,
    coo_to_bsr,
    coo_to_bsr_stack,
    live_rank_slice,
)

__all__ = ["DeployedModel", "is_linear_site"]

# parameter-dict keys consumed through apply_weight (plain x @ w sites)
_LINEAR_KEYS = frozenset({"q", "k", "v", "o", "gate", "up", "down", "w"})


def is_linear_site(info: BlockInfo) -> bool:
    last = info.name.split("/")[-1]
    return last in _LINEAR_KEYS and "moe" not in info.name and not info.is_embedding


def _materialize_dense(blk, leaf_dtype) -> torch.Tensor:
    """X_hat = L + S for a block served dense. The product runs over the live
    rank only (the dead columns of p are zero, so they add nothing): a
    fresh all-zero state, or a truncated tier, skips most of it."""
    dense = sparse.to_dense(blk.s_coo).to(blk.p.dtype)
    p, vt = live_rank_slice(blk)
    if p is not None:
        dense = p @ vt + dense
    return dense.to(leaf_dtype)


def _coo_slice_to_bsr(lin: SLRLinear, bsr_block: int) -> SLRLinear:
    """One unstacked weight's COO part as block-CSC, on the kernel path; a
    weight with no S keeps the plain path, as in the JAX package."""
    if lin.s_coo is None:
        return lin
    return SLRLinear(p=lin.p, vt=lin.vt, s_coo=None, shape=lin.shape,
                     s_bsr=coo_to_bsr(lin.s_coo, bsr_block), use_kernel=True)


def _fuse_linear(lin: SLRLinear, bsr_block: int) -> SLRLinear:
    """Stacked weights keep the layer axis as a ``BsrStack``; unstacked ones
    get a per-matrix block-CSC, applied by ``ops.slr_matmul``."""
    if lin.ndim == 3:
        s_stack = coo_to_bsr_stack(lin.s_coo, bsr_block) if lin.s_coo is not None else None
        return SLRLinear(p=lin.p, vt=lin.vt, s_coo=None, s_stack=s_stack,
                         shape=lin.shape, fuse=True, use_kernel=True)
    s_bsr = coo_to_bsr(lin.s_coo, bsr_block) if lin.s_coo is not None else None
    return SLRLinear(p=lin.p, vt=lin.vt, s_coo=None, shape=lin.shape, s_bsr=s_bsr,
                     fuse=True, use_kernel=True)


def _unroll_layers(cfg, serving: Any, bsr_block: int) -> Any:
    """The stacked layer tree as a list of per-layer dicts, each layer's SLR
    weights converted to block-CSC (the bsr kernels are per matrix)."""
    layers = serving.get("layers") if isinstance(serving, dict) else None
    if layers is None:
        return serving

    def layer(l: int, node):
        if isinstance(node, dict):
            return {k: layer(l, v) for k, v in node.items()}
        if isinstance(node, SLRLinear):
            return _coo_slice_to_bsr(node.at_layer(l), bsr_block)
        return node[l]

    return {**serving, "layers": [layer(l, layers) for l in range(cfg.num_layers)]}


def _check_format(cfg, fmt: str):
    """The JAX package's support matrix: its two failing cells raise here."""
    if fmt == "bsr" and cfg.family == "ssm":
        raise ValueError("fmt='bsr' cannot serve the ssm family: its forward walks the "
                         "stacked layer tree, which bsr unrolls into per-layer dicts (the "
                         "JAX package's scan fails on it too); serve fused, factored or "
                         "dense")
    if fmt == "fused" and cfg.family == "encdec":
        raise ValueError("fmt='fused' cannot serve the encdec family: its stacked fused "
                         "weights are applied per layer by index, and the encoder-decoder's "
                         "forward walks its stacks directly in the JAX package; serve bsr, "
                         "factored or dense")


class DeployedModel:
    """A servable model: arch config + a parameter tree in a deployment
    format, consumed by the ordinary ``models.model`` API."""

    def __init__(self, cfg, params: Any, fmt: str = "dense"):
        self.cfg = cfg
        self.params = params
        self.fmt = fmt

    @classmethod
    def build(cls, cfg, params: Any, state: SLRState, blocks: list[BlockInfo],
              fmt: str = "factored", bsr_block: int = 128) -> "DeployedModel":
        """Deploy (params, SLR state) at format ``fmt``, on the state's device."""
        if fmt == "dense":
            return cls(cfg, surrogate_params(params, state, blocks), fmt)
        if fmt not in ("factored", "bsr", "fused"):
            raise ValueError(f"unknown deployment format {fmt!r}")
        _check_format(cfg, fmt)
        by_name = {info.name: info for info in blocks}
        linears = build_slr_linears(state, blocks)

        def replace_leaf(path, leaf):
            name = path_str(path)
            info = by_name.get(name)
            if info is None or name not in state:
                return leaf
            if not is_linear_site(info):
                return _materialize_dense(state[name], leaf.dtype)
            lin = linears[name]
            if fmt == "fused":
                return _fuse_linear(lin, bsr_block)
            if fmt == "bsr" and lin.ndim == 2:
                # unstacked weights outside the layer stack also take the kernels
                return _coo_slice_to_bsr(lin, bsr_block)
            if fmt == "bsr" and cfg.family == "encdec":
                # a list of per-layer block-CSC weights in the stacked tree:
                # the layer loops index it, and the stacked norms and biases
                # stay shared by every tier of a bank, as in the JAX package
                return [_coo_slice_to_bsr(lin.at_layer(l), bsr_block)
                        for l in range(info.stack_dims[0])]
            return lin

        serving = replace_by_path(params, replace_leaf)
        if fmt == "bsr":
            serving = _unroll_layers(cfg, serving, bsr_block)
        return cls(cfg, serving, fmt)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, **extra) -> torch.Tensor:
        """Full no-cache forward -> logits (parity checks / eval); ``extra``
        holds the stub frontends' ``frames`` or ``patches``."""
        logits, _ = model_lib._forward(self.params, {"tokens": tokens, **extra}, self.cfg)
        return logits

    def param_bytes(self) -> dict:
        """Served memory by leaf kind (structured vs dense), in bytes."""
        structured = dense = 0
        for _, leaf in tree_leaves_with_path(self.params):
            if isinstance(leaf, SLRLinear):
                structured += leaf.param_bytes
            else:
                dense += leaf.numel() * leaf.element_size()
        return {"structured_bytes": structured, "dense_bytes": dense,
                "total_bytes": structured + dense, "format": self.fmt}
