"""Two-stage ADMM for SLR induction, Algorithm 1 of the paper (port of
``repro/core/admm.py``).

Stage 1 (guided learning) lives in the training loop: K optimizer steps on
the coupled loss ``l(X) + sum_i rho_i/2 ||X_i - Z_i||_F^2``; ``penalty``
gives that term with the target ``Z = L + S - Y/rho`` held constant (it is
cached by every ``admm_update`` and detached). Stage 2 is ``admm_update``,
the closed-form prox sweep

    L <- SVT_{alpha/rho}(X - S + Y/rho)
    S <- shrink_{beta/rho}(X - L + Y/rho)
    Y <- Y + rho (X - L - S)

followed by the I-controller update of (alpha, beta). L is stored factored
(``p = U diag(s_thr)``, ``vt``), S as a capped COO list, Y dense. Stacked
leaves ``(L, n, m)`` run as one batch of independent blocks, each with its
own (alpha, beta) - the batch dimension stands in for JAX's ``vmap``.

The SVD is the randomized range finder (``rsvd.randomized_svd``) unless
``exact_svd`` asks for ``torch.linalg.svd``. Its sketches are drawn on the
CPU from keys (step, block index, slice, sweep), so a restart replays a step
exactly and the card draws what the CPU draws; a caller may hand its own
sketches in. The S shrinkage runs through ``kernels.ops.soft_threshold``:
the hand-written CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..kernels import ops
from ..tree import leaf_by_path, replace_by_path
from . import sparse
from .controller import ControllerConfig, controller_update
from .prox import effective_rank_ratio_from_singular_values
from .rsvd import randomized_svd, rank_cap, sketch
from .scaling import PAPER_RHO_CONSTANT, rho_for_block
from .selection import BlockInfo, SelectionConfig, path_str, select_blocks, total_logical_blocks

__all__ = ["SalaadConfig", "BlockSLR", "SLRState", "init_slr_state", "penalty",
           "admm_update", "block_sketches", "surrogate_params", "slr_param_count"]


@dataclass(frozen=True)
class SalaadConfig:
    """Everything that parameterizes Algorithm 1 (the JAX package's fields
    and defaults)."""

    rho_constant: float = PAPER_RHO_CONSTANT   # proportionality in Eq. (7)
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    selection: SelectionConfig = field(default_factory=SelectionConfig)
    rank_cap_ratio: float = 0.25     # randomized-SVD sketch cap (vs min(n, m))
    coo_cap_density: float = 0.15    # S capacity (vs n * m)
    rsvd_iters: int = 2              # power iterations in the range finder
    admm_inner_steps: int = 1        # J in Algorithm 1
    update_every: int = 40           # K in Algorithm 1
    surrogate_dtype: Any = torch.float32
    exact_svd: bool = False          # torch.linalg.svd instead of the rSVD


@dataclass(frozen=True)
class BlockSLR:
    """Per-leaf surrogate state; leading dims mirror the weight's stack dims."""

    p: torch.Tensor             # (..., n, r)  U diag(s_thr) - L = p @ vt
    vt: torch.Tensor            # (..., r, m)
    s_vals: torch.Tensor        # (..., r)     thresholded singular values
    s_coo: sparse.CooMatrix     # sparse S
    y: torch.Tensor             # (..., n, m)  dual
    z: torch.Tensor             # (..., n, m)  cached penalty target L + S - Y/rho
    alpha: torch.Tensor         # (...,)
    beta: torch.Tensor          # (...,)
    rho: float                  # Eq. (7) value for this block shape


SLRState = dict   # block name -> BlockSLR


def init_slr_state(params: Any, cfg: SalaadConfig) -> tuple[SLRState, list[BlockInfo]]:
    """Zero-initialized surrogate state for every selected block, on the
    device of the parameters."""
    blocks = select_blocks(params, cfg.selection)
    n_logical = max(1, total_logical_blocks(blocks))
    state: SLRState = {}
    for info in blocks:
        dev = leaf_by_path(params, info.path).device
        n, m = info.n, info.m
        r = rank_cap(n, m, cfg.rank_cap_ratio)
        cap = sparse.coo_cap(n, m, cfg.coo_cap_density)
        stack = info.stack_dims
        z = lambda *shape, dt=cfg.surrogate_dtype: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        state[info.name] = BlockSLR(
            p=z(*stack, n, r), vt=z(*stack, r, m), s_vals=z(*stack, r),
            s_coo=sparse.CooMatrix(
                values=z(*stack, cap),
                idx=torch.full((*stack, cap), -1, dtype=torch.int32, device=dev),
                shape=(n, m),
            ),
            y=z(*stack, n, m), z=z(*stack, n, m),
            alpha=z(*stack, dt=torch.float32), beta=z(*stack, dt=torch.float32),
            rho=rho_for_block(n, m, n_logical, cfg.rho_constant),
        )
    return state, blocks


def penalty(params: Any, state: SLRState, blocks: list[BlockInfo]) -> torch.Tensor:
    """Stage-1 coupled-loss term ``sum_i rho_i/2 ||X_i - Z_i||_F^2`` in f32,
    against the cached target Z, detached: it is a constant within a
    guided-learning phase."""
    total = None
    for info in blocks:
        blk = state[info.name]
        x = leaf_by_path(params, info.path).float()
        term = 0.5 * blk.rho * ((x - blk.z.detach().float()) ** 2).sum()
        total = term if total is None else total + term
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


def block_sketches(step: int, index: int, info: BlockInfo, rank: int, sweeps: int,
                   device) -> torch.Tensor:
    """The rSVD sketches of selected leaf number ``index`` at ``step``:
    (num_blocks, sweeps, m, rank), slice b's sweep j keyed (step, index, b, j)."""
    omega = torch.stack([
        torch.stack([sketch((step, index, b, j), info.m, rank) for j in range(sweeps)])
        for b in range(info.num_blocks)])
    return omega.to(device)


# slices of one stacked leaf swept together: the sweep holds about ten f32
# temporaries of (slices, n, m), so a leaf above this many elements is swept
# in chunks of whole slices (each slice is an independent block)
SWEEP_ELEMS = 1 << 28


def _sweep(x32, y32, s_dense, alpha, beta, rho: float, r: int, cap: int, cfg, omega):
    """The J-sweep and controller update of a batch of (n, m) blocks (f32);
    returns (p, vt, s_thr, coo, y, z) and the per-block stats."""
    nb, n, m = x32.shape
    p_new = torch.zeros((nb, n, r), device=x32.device)
    vt_new = torch.zeros((nb, r, m), device=x32.device)
    s_thr = torch.zeros((nb, r), device=x32.device)
    for j in range(cfg.admm_inner_steps):
        mmat = x32 - s_dense + y32 / rho
        if cfg.exact_svd:
            u, s, v = torch.linalg.svd(mmat, full_matrices=False)
            u, s, vt_new = u[..., :r], s[..., :r], v[..., :r, :]
        else:
            u, s, vt_new = randomized_svd(mmat, omega[:, j], cfg.rsvd_iters)
        del mmat
        s_thr = torch.clamp_min(s - (alpha / rho)[:, None], 0.0)
        p_new = u * s_thr[:, None, :]
        l_dense = p_new @ vt_new
        s_dense = ops.soft_threshold((x32 - l_dense + y32 / rho).contiguous(), beta / rho)
        y32 = y32 + rho * (x32 - l_dense - s_dense)
        del l_dense

    coo = sparse.from_dense(s_dense, cap)
    del s_dense
    s_back = sparse.to_dense(coo)
    rank_ratio = effective_rank_ratio_from_singular_values(
        s_thr, cfg.controller.gamma, denom=min(n, m))
    dens = sparse.nnz(coo).float() / (n * m)
    alpha_new, beta_new = controller_update(alpha, beta, rank_ratio, dens, rho,
                                            cfg.controller)
    l_dense = p_new @ vt_new
    recon_err = torch.linalg.vector_norm(x32 - l_dense - s_back, dim=(-2, -1))
    z_new = l_dense + s_back - y32 / rho
    stats = {"rank_ratio": rank_ratio, "density": dens, "recon_err": recon_err,
             "alpha": alpha_new, "beta": beta_new}
    return (p_new, vt_new, s_thr, coo, y32, z_new), stats


def _update_leaf(x: torch.Tensor, blk: BlockSLR, info: BlockInfo, cfg: SalaadConfig,
                 omega: torch.Tensor | None = None):
    """One J-sweep for every slice of one leaf, as batches of (n, m) blocks
    of at most ``SWEEP_ELEMS`` elements; ``omega`` (nb, J, m, r) are the rSVD
    sketches (unused by the exact SVD)."""
    n, m = info.n, info.m
    stack = info.stack_dims
    nb = info.num_blocks
    r = blk.p.shape[-1]
    cap = blk.s_coo.values.shape[-1]
    rho = blk.rho
    dt = blk.p.dtype
    flat = lambda a, *tail: a.reshape(nb, *tail)  # noqa: E731
    x, y = flat(x, n, m), flat(blk.y, n, m)
    values, idx = flat(blk.s_coo.values, cap), flat(blk.s_coo.idx, cap)
    alpha, beta = blk.alpha.reshape(nb), blk.beta.reshape(nb)

    per = max(1, SWEEP_ELEMS // (n * m))
    outs, stat_parts = [], []
    for b0 in range(0, nb, per):
        sl = slice(b0, min(nb, b0 + per))
        s_dense = sparse.to_dense(sparse.CooMatrix(values[sl], idx[sl], (n, m))).float()
        (p_new, vt_new, s_thr, coo, y32, z_new), stats = _sweep(
            x[sl].float(), y[sl].float(), s_dense, alpha[sl], beta[sl], rho, r, cap, cfg,
            None if omega is None else omega[sl])
        outs.append((p_new.to(dt), vt_new.to(dt), s_thr.to(dt), coo.values.to(dt), coo.idx,
                     y32.to(dt), z_new.to(dt)))
        stat_parts.append(stats)
    cat = lambda parts: parts[0] if len(parts) == 1 else torch.cat(parts)  # noqa: E731
    p_new, vt_new, s_thr, values, idx, y_new, z_new = (cat(list(a)) for a in zip(*outs))
    stats = {k: cat([st[k] for st in stat_parts]) for k in stat_parts[0]}
    unflat = lambda a: a.reshape(tuple(stack) + tuple(a.shape[1:]))  # noqa: E731
    new = BlockSLR(
        p=unflat(p_new), vt=unflat(vt_new), s_vals=unflat(s_thr),
        s_coo=sparse.CooMatrix(unflat(values), unflat(idx), (n, m)),
        y=unflat(y_new), z=unflat(z_new),
        alpha=unflat(stats["alpha"]), beta=unflat(stats["beta"]), rho=rho,
    )
    return new, {k: unflat(v) for k, v in stats.items()}


@torch.no_grad()
def admm_update(params: Any, state: SLRState, blocks: list[BlockInfo],
                cfg: SalaadConfig, step: int = 0,
                sketches: dict[str, torch.Tensor] | None = None) -> tuple[SLRState, dict]:
    """Stage 2 + I-controller for every block. Deterministic in ``step``: the
    rSVD sketches of leaf i are ``block_sketches(step, i, ...)`` unless
    ``sketches`` maps the leaf's name to its own (num_blocks, J, m, r)."""
    new_state: SLRState = {}
    all_stats: dict = {}
    for i, info in enumerate(blocks):
        x = leaf_by_path(params, info.path)
        blk = state[info.name]
        omega = None
        if not cfg.exact_svd:
            if sketches is not None and info.name in sketches:
                omega = sketches[info.name].to(x.device, torch.float32)
            else:
                omega = block_sketches(int(step), i, info, blk.p.shape[-1],
                                       cfg.admm_inner_steps, x.device)
        new_state[info.name], all_stats[info.name] = _update_leaf(x, blk, info, cfg, omega)
    recon = [s["recon_err"].mean() for s in all_stats.values()]
    all_stats["_mean_recon_err"] = torch.stack(recon).mean() if recon else torch.zeros(())
    return new_state, all_stats


def surrogate_params(params: Any, state: SLRState, blocks: list[BlockInfo]) -> Any:
    """X_hat = L + S for selected blocks; other leaves pass through."""
    by_name = {info.name for info in blocks}

    def replace_leaf(path, leaf):
        name = path_str(path)
        if name in by_name and name in state:
            blk = state[name]
            dense = blk.p @ blk.vt + sparse.to_dense(blk.s_coo).to(blk.p.dtype)
            return dense.to(leaf.dtype)
        return leaf

    return replace_by_path(params, replace_leaf)


def slr_param_count(state: SLRState, blocks: list[BlockInfo]) -> dict:
    """Deployment parameter accounting (factored L + COO S), per block and
    total: live ranks times (n + m), plus live S entries."""
    out: dict = {}
    total = 0
    for info in blocks:
        blk = state[info.name]
        rank_live = (blk.s_vals > 0).sum(-1).cpu().numpy()
        nnz_live = sparse.nnz(blk.s_coo).cpu().numpy()
        l_params = int(np.sum(rank_live) * (info.n + info.m))
        s_params = int(np.sum(nnz_live))
        out[info.name] = {"L": l_params, "S": s_params}
        total += l_params + s_params
    out["_total"] = total
    return out
