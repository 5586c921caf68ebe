"""DeployedModel: run the transformer on SLR (L + S) weights directly (port
of ``repro/serving/deployed.py``).

Every SALAAD-selected matmul weight (attention q/k/v/o, MLP gate/up/down)
becomes a :class:`~repro_torch.serving.slr_params.SLRLinear` in the
parameter tree, so the unchanged model code runs ``x @ P @ Vt + x @ S`` at
every linear site through ``models.layers.apply_weight``. Gather sites (the
embedding) are served dense-materialized. Formats:

  * ``dense``    - X_hat = L + S materialized
  * ``factored`` - (p, vt) + COO S, plain PyTorch products
  * ``fused``    - one fused SLR kernel per linear site with layer-stacked
                   block-CSC tables; the layer loop passes the layer index
  * ``bsr``      - a later slice (it needs the ``bsr_matmul`` kernel)
"""
from __future__ import annotations

from typing import Any

import torch

from ..core import sparse
from ..core.admm import SLRState, surrogate_params
from ..core.selection import BlockInfo, path_str
from ..models import model as model_lib
from ..tree import replace_by_path, tree_leaves_with_path
from .slr_params import SLRLinear, build_slr_linears, coo_to_bsr_stack

__all__ = ["DeployedModel", "is_linear_site"]

# parameter-dict keys consumed through apply_weight (plain x @ w sites)
_LINEAR_KEYS = frozenset({"q", "k", "v", "o", "gate", "up", "down", "w"})


def is_linear_site(info: BlockInfo) -> bool:
    last = info.name.split("/")[-1]
    return last in _LINEAR_KEYS and "moe" not in info.name and not info.is_embedding


def _materialize_dense(blk, leaf_dtype) -> torch.Tensor:
    dense = blk.p @ blk.vt + sparse.to_dense(blk.s_coo).to(blk.p.dtype)
    return dense.to(leaf_dtype)


def _fuse_linear(lin: SLRLinear, bsr_block: int) -> SLRLinear:
    if lin.ndim != 3:
        raise NotImplementedError(
            "a fused weight outside a layer stack needs the unstacked "
            "slr_matmul kernel, ported in a later slice"
        )
    s_stack = coo_to_bsr_stack(lin.s_coo, bsr_block) if lin.s_coo is not None else None
    return SLRLinear(p=lin.p, vt=lin.vt, s_coo=None, s_stack=s_stack,
                     shape=lin.shape, fuse=True)


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
        if fmt == "bsr":
            raise NotImplementedError(
                "the 'bsr' deployment format needs the bsr_matmul kernel, ported "
                "in a later slice; use 'fused' or 'factored'"
            )
        if fmt not in ("factored", "fused"):
            raise ValueError(f"unknown deployment format {fmt!r}")
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
            return _fuse_linear(lin, bsr_block) if fmt == "fused" else lin

        return cls(cfg, replace_by_path(params, replace_leaf), fmt)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full no-cache forward -> logits (parity checks / eval)."""
        logits, _ = model_lib._forward(self.params, {"tokens": tokens}, self.cfg)
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
