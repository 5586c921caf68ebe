"""Stage 2 of Algorithm 1 (the closed-form prox sweep) and the SLR state it
updates (port of ``repro/core/admm.py``).

    L <- SVT_{alpha/rho}(X - S + Y/rho)
    S <- shrink_{beta/rho}(X - L + Y/rho)
    Y <- Y + rho (X - L - S)

followed by the I-controller update of (alpha, beta). L is stored factored
(``p = U diag(s_thr)``, ``vt``), S as a capped COO list, Y dense. Stacked
leaves ``(L, n, m)`` run as one batch of independent blocks, each with its
own (alpha, beta) — the batch dimension stands in for JAX's ``vmap``.

Only the exact-SVD path (``torch.linalg.svd``, as the JAX package's
``jnp.linalg.svd``) is ported: that is all the serving slice needs to build a
non-trivial SLR state. The randomized SVD of the training path, and the
stage-1 penalty, come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..tree import leaf_by_path, replace_by_path
from . import sparse
from .controller import ControllerConfig, controller_update
from .prox import effective_rank_ratio_from_singular_values, soft_threshold
from .rsvd import rank_cap
from .scaling import PAPER_RHO_CONSTANT, rho_for_block
from .selection import BlockInfo, SelectionConfig, path_str, select_blocks, total_logical_blocks

__all__ = ["SalaadConfig", "BlockSLR", "SLRState", "init_slr_state",
           "admm_update", "surrogate_params"]


@dataclass(frozen=True)
class SalaadConfig:
    rho_constant: float = PAPER_RHO_CONSTANT
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    selection: SelectionConfig = field(default_factory=SelectionConfig)
    rank_cap_ratio: float = 0.25
    coo_cap_density: float = 0.15
    admm_inner_steps: int = 1
    surrogate_dtype: Any = torch.float32
    exact_svd: bool = False

    def __post_init__(self):
        if not self.exact_svd:
            raise NotImplementedError(
                "SalaadConfig(exact_svd=False) selects the randomized SVD, "
                "which is ported with the training slice; pass exact_svd=True"
            )


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


def _update_leaf(x: torch.Tensor, blk: BlockSLR, info: BlockInfo, cfg: SalaadConfig):
    """One J-sweep for every slice of one leaf, as a batch of (n, m) blocks."""
    n, m = info.n, info.m
    stack = info.stack_dims
    nb = info.num_blocks
    r = blk.p.shape[-1]
    cap = blk.s_coo.values.shape[-1]
    rho = blk.rho
    dt = blk.p.dtype
    flat = lambda a, *tail: a.reshape(nb, *tail)  # noqa: E731

    x32 = flat(x, n, m).float()
    y32 = flat(blk.y, n, m).float()
    s_dense = sparse.to_dense(sparse.CooMatrix(
        flat(blk.s_coo.values, cap), flat(blk.s_coo.idx, cap), (n, m))).float()
    alpha = blk.alpha.reshape(nb)
    beta = blk.beta.reshape(nb)
    p_new = torch.zeros((nb, n, r), device=x.device)
    vt_new = torch.zeros((nb, r, m), device=x.device)
    s_thr = torch.zeros((nb, r), device=x.device)
    for _ in range(cfg.admm_inner_steps):
        mmat = x32 - s_dense + y32 / rho
        u, s, v = torch.linalg.svd(mmat, full_matrices=False)
        u, s, vt_new = u[..., :r], s[..., :r], v[..., :r, :]
        s_thr = torch.clamp_min(s - (alpha / rho)[:, None], 0.0)
        p_new = u * s_thr[:, None, :]
        l_dense = p_new @ vt_new
        s_dense = soft_threshold(x32 - l_dense + y32 / rho, (beta / rho)[:, None, None])
        y32 = y32 + rho * (x32 - l_dense - s_dense)

    coo = sparse.from_dense(s_dense, cap)
    s_back = sparse.to_dense(coo)
    rank_ratio = effective_rank_ratio_from_singular_values(
        s_thr, cfg.controller.gamma, denom=min(n, m))
    dens = sparse.nnz(coo).float() / (n * m)
    alpha_new, beta_new = controller_update(alpha, beta, rank_ratio, dens, rho,
                                            cfg.controller)
    l_dense = p_new @ vt_new
    recon_err = torch.linalg.vector_norm(x32 - l_dense - s_back, dim=(-2, -1))
    z_new = l_dense + s_back - y32 / rho
    unflat = lambda a: a.reshape(tuple(stack) + tuple(a.shape[1:]))  # noqa: E731
    stats = {"rank_ratio": rank_ratio, "density": dens, "recon_err": recon_err,
             "alpha": alpha_new, "beta": beta_new}
    new = BlockSLR(
        p=unflat(p_new.to(dt)), vt=unflat(vt_new.to(dt)), s_vals=unflat(s_thr.to(dt)),
        s_coo=sparse.CooMatrix(unflat(coo.values.to(dt)), unflat(coo.idx), (n, m)),
        y=unflat(y32.to(dt)), z=unflat(z_new.to(dt)),
        alpha=unflat(alpha_new), beta=unflat(beta_new), rho=rho,
    )
    return new, {k: unflat(v) for k, v in stats.items()}


@torch.no_grad()
def admm_update(params: Any, state: SLRState, blocks: list[BlockInfo],
                cfg: SalaadConfig, step: int = 0) -> tuple[SLRState, dict]:
    """Stage 2 + I-controller for every block. ``step`` keys the randomized
    SVD in the JAX package; the exact path is deterministic without it."""
    new_state: SLRState = {}
    all_stats: dict = {}
    for info in blocks:
        x = leaf_by_path(params, info.path).float()
        new_state[info.name], all_stats[info.name] = _update_leaf(
            x, state[info.name], info, cfg)
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
