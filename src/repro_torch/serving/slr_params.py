"""Deployment-time SLR parameters (port of ``repro/serving/slr_params.py``).

Formats:
  * ``dense``    - X_hat = L + S materialized (``core.admm.surrogate_params``)
  * ``factored`` - (p, vt) + COO S; linears run ``(x @ p) @ vt + x @ S``
  * ``bsr``      - per-layer (p, vt) + block-CSC S through the low-rank and
                   block-CSC kernels (``kernels/lowrank_matmul.py``,
                   ``kernels/bsr_matmul.py``), one weight per layer
  * ``fused``    - one kernel per linear site: ``x @ P @ Vt + x @ S`` with
                   layer-stacked block-CSC tables, or per-matrix tables for
                   a weight outside a layer stack (the hybrid's shared
                   block), through ``kernels/ops.py``

``deployment_report`` accounts bytes per format with the JAX package's
conventions (bf16 deploy baseline), so the two reports are equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import sparse
from ..core.admm import SLRState, surrogate_params
from ..core.selection import BlockInfo, path_str
from ..kernels import ops
from ..kernels.bsr_matmul import BsrMatrix, bsr_from_dense
from ..kernels.slr_matmul import BsrStack, stack_bsr
from ..tree import tree_leaves_with_path

__all__ = ["SLRLinear", "SLRLayerView", "coo_to_bsr", "coo_to_bsr_stack",
           "build_slr_linears", "live_rank_slice", "deploy_params", "deployment_report"]


@dataclass
class SLRLinear:
    """One deployed SLR weight, in place of a dense matrix in the parameter
    tree; ``models.layers.apply_weight`` calls ``apply``. Stacked weights
    carry a leading layer axis on every table."""

    p: torch.Tensor | None           # (n, r_live) or (L, n, r_live)
    vt: torch.Tensor | None          # (r_live, m) or (L, r_live, m)
    s_coo: sparse.CooMatrix | None
    shape: tuple[int, int]
    s_stack: BsrStack | None = None  # layer-stacked block-CSC (fused format)
    fuse: bool = False               # one fused kernel per apply
    s_bsr: BsrMatrix | None = None   # per-matrix block-CSC (bsr format)
    use_kernel: bool = False         # apply through the kernels
    # (row0, row1, col0, col1): the block of the whole weight this one is, on
    # a rank of a model-parallel mesh (``parallel/sharding.py``); the COO
    # tables stay whole and only the entries inside the block apply
    block: tuple[int, int, int, int] | None = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = x @ (L + S) for an unstacked (or layer-sliced) weight."""
        if (self.p is None and self.s_coo is None and self.s_bsr is None
                and self.s_stack is None):
            # fully truncated (extreme HPA budgets, or an untrained state)
            return torch.zeros((*x.shape[:-1], self.shape[1]), dtype=x.dtype, device=x.device)
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        if self.fuse:
            if self.s_stack is not None:
                raise RuntimeError("stacked fused weights apply per layer: take at_layer(l)")
            y = ops.slr_matmul(flat, self.p, self.vt, self.s_bsr)
            return y.reshape(*x.shape[:-1], self.shape[1])
        y = 0.0
        if self.p is not None:
            if self.use_kernel:
                y = ops.lowrank_matmul(flat, self.p, self.vt).reshape(*x.shape[:-1], -1)
            else:
                y = (x @ self.p) @ self.vt
        if self.s_bsr is not None and self.use_kernel:
            y = y + ops.bsr_matmul(flat, self.s_bsr).reshape(*x.shape[:-1], self.shape[1])
        elif self.s_coo is not None:
            y = y + x @ sparse.to_dense(self.s_coo, self.block).to(x.dtype)
        return y

    def at_layer(self, layer: int):
        """Layer ``layer`` of a stacked weight: an ``SLRLayerView`` for fused
        weights with stacked tables (they stay whole), a sliced copy
        otherwise."""
        if self.fuse and self.s_stack is not None:
            return SLRLayerView(self, layer)
        coo = self.s_coo
        if coo is not None:
            coo = sparse.CooMatrix(coo.values[layer], coo.idx[layer], coo.shape)
        return dataclasses.replace(
            self,
            p=None if self.p is None else self.p[layer],
            vt=None if self.vt is None else self.vt[layer],
            s_coo=coo,
        )

    @property
    def ndim(self) -> int:
        """Logical ndim of the dense weight this object replaces."""
        if self.p is not None:
            return self.p.dim()
        if self.s_coo is not None:
            return self.s_coo.values.dim() + 1
        return 3 if self.s_stack is not None else 2

    @property
    def param_bytes(self) -> int:
        total = 0
        if self.p is not None:
            total += self.p.numel() * self.p.element_size()
            total += self.vt.numel() * self.vt.element_size()
        tables = self.s_stack if self.s_stack is not None else self.s_bsr
        if tables is not None:
            total += tables.vals.numel() * tables.vals.element_size()
            total += tables.rows.numel() * 4 + tables.counts.numel() * 4
        elif self.s_coo is not None:
            nnz = int((self.s_coo.idx >= 0).sum())
            total += nnz * (self.s_coo.values.element_size() + 4)
        return total


class SLRLayerView:
    """Layer ``layer`` of a stacked fused :class:`SLRLinear`: the stacked
    tables stay whole and the layer index goes to the kernel."""

    __slots__ = ("lin", "layer")

    def __init__(self, lin: SLRLinear, layer: int):
        self.lin = lin
        self.layer = layer

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.lin
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        y = ops.slr_matmul_stacked(flat, lin.p, lin.vt, lin.s_stack, self.layer)
        return y.reshape(*x.shape[:-1], lin.shape[1])


def _fit_block(n: int, m: int, bsr_block: int) -> int:
    """Halve the block size while it divides neither dim (floor 8); a size
    that still does not divide is zero-padded by ``bsr_from_dense``."""
    bs = bsr_block
    while (n % bs or m % bs) and bs > 8:
        bs //= 2
    return bs


def coo_to_bsr(s_coo: sparse.CooMatrix, bsr_block: int) -> BsrMatrix:
    """Dense-ify an unstacked COO matrix and re-tile it as block-CSC (f32
    tables, as in the JAX package), on the COO's device. Ragged shapes
    zero-pad their trailing partial blocks."""
    dense_s = sparse.to_dense(s_coo).float().cpu().numpy()
    n, m = dense_s.shape
    return bsr_from_dense(dense_s, _fit_block(n, m, bsr_block), device=s_coo.values.device)


def coo_to_bsr_stack(s_coo: sparse.CooMatrix, bsr_block: int) -> BsrStack:
    """Dense-ify a layer-stacked COO matrix and re-tile every layer as
    block-CSC with one shared (block size, MAXB) layout (f32 tables, as in
    the JAX package), on the COO's device."""
    dense_s = sparse.to_dense(s_coo).float().cpu().numpy()
    num_l, n, m = dense_s.shape
    bs = _fit_block(n, m, bsr_block)
    dev = s_coo.values.device
    return stack_bsr([bsr_from_dense(dense_s[l], bs, device=dev) for l in range(num_l)])


def live_rank_slice(blk):
    """Trim factored L to live singular values (stacked blocks keep the max
    live rank across slices so shapes stay static). The order is numpy's
    argsort, as in the JAX package, so bridged states trim identically."""
    s_vals = blk.s_vals.float().cpu().numpy()
    live = s_vals > 0
    r_live = int(live.sum(axis=-1).max()) if live.size else 0
    if r_live == 0:
        return None, None
    order = torch.from_numpy(np.argsort(-s_vals, axis=-1)[..., :r_live]).to(blk.p.device)
    p = torch.take_along_dim(blk.p, order[..., None, :], dim=-1)
    vt = torch.take_along_dim(blk.vt, order[..., :, None], dim=-2)
    return p.contiguous(), vt.contiguous()


def build_slr_linears(state: SLRState, blocks: list[BlockInfo]) -> dict[str, SLRLinear]:
    """Per-block factored representation; stacked blocks stay stacked. An
    empty S (no live entry) is dropped at build time."""
    out = {}
    for info in blocks:
        blk = state[info.name]
        p, vt = live_rank_slice(blk)
        s_coo = blk.s_coo if int((blk.s_coo.idx >= 0).sum()) else None
        out[info.name] = SLRLinear(p=p, vt=vt, s_coo=s_coo, shape=(info.n, info.m))
    return out


def deploy_params(params: Any, state: SLRState, blocks: list[BlockInfo], fmt: str = "dense"):
    """For fmt='dense': params with X replaced by X_hat = L + S (the
    architecture-preserving deployment: the model code runs unchanged, paper
    §4.3). The other formats are built by ``DeployedModel.build``."""
    if fmt != "dense":
        raise ValueError(f"deploy_params builds the dense format only, got fmt={fmt!r}; "
                         "use serving.deployed.DeployedModel.build for the others")
    return surrogate_params(params, state, blocks)


def deployment_report(params: Any, state: SLRState, blocks: list[BlockInfo]) -> dict:
    """Bytes by format vs the dense original (per block + totals)."""
    report: dict[str, Any] = {"blocks": {}}
    dense_total = 0
    slr_total = 0
    for info in blocks:
        blk = state[info.name]
        dense_b = int(np.prod(info.shape)) * 2  # bf16 deploy baseline
        nnz = int((blk.s_coo.idx >= 0).sum())
        live = int((blk.s_vals > 0).sum())
        slr_b = live * (info.n + info.m) * 2 + nnz * (2 + 4)
        report["blocks"][info.name] = {
            "dense_bytes": dense_b, "slr_bytes": slr_b, "rank_live": live, "nnz": nnz,
        }
        dense_total += dense_b
        slr_total += slr_b
    sel = {info.name for info in blocks}
    unselected = sum(int(np.prod(leaf.shape)) * 2
                     for path, leaf in tree_leaves_with_path(params)
                     if path_str(path) not in sel)
    report["dense_total_bytes"] = dense_total + unselected
    report["slr_total_bytes"] = slr_total + unselected
    report["compression"] = (dense_total + unselected) / max(slr_total + unselected, 1)
    return report
