"""Fixed-capacity sparse matrix for the S component (port of
``repro/core/sparse.py``).

S is a capped coordinate list: ``values (..., cap)`` and ``idx (..., cap)``
int32 flat row-major indices, ``-1`` marking an empty slot. ``from_dense``
keeps the ``cap`` largest-magnitude entries, so the cap is a magnitude
pre-truncation, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["CooMatrix", "coo_cap", "from_dense", "to_dense", "nnz"]


@dataclass(frozen=True)
class CooMatrix:
    values: torch.Tensor    # (..., cap)
    idx: torch.Tensor       # (..., cap) int32 flat index into n*m, -1 = empty
    shape: tuple[int, int]  # (n, m) of the dense matrix


def coo_cap(n: int, m: int, cap_density: float = 0.15) -> int:
    cap = max(8, int(cap_density * n * m))
    if cap >= 512:
        cap = -(-cap // 512) * 512
    return min(cap, n * m)


def from_dense(s: torch.Tensor, cap: int) -> CooMatrix:
    """Keep the ``cap`` largest-|.| entries of dense ``s`` (trailing 2 dims)."""
    n, m = s.shape[-2:]
    flat = s.reshape(*s.shape[:-2], n * m)
    _, top_idx = torch.topk(flat.abs(), cap, dim=-1)
    vals = torch.gather(flat, -1, top_idx)
    live = vals.abs() > 0
    return CooMatrix(
        values=torch.where(live, vals, torch.zeros_like(vals)),
        idx=torch.where(live, top_idx, torch.full_like(top_idx, -1)).to(torch.int32),
        shape=(n, m),
    )


def to_dense(coo: CooMatrix) -> torch.Tensor:
    """Scatter back to a dense ``(..., n, m)`` matrix."""
    n, m = coo.shape
    live = coo.idx >= 0
    safe = torch.where(live, coo.idx, torch.zeros_like(coo.idx)).long()
    vals = torch.where(live, coo.values, torch.zeros_like(coo.values))
    batch = coo.values.shape[:-1]
    out = torch.zeros((*batch, n * m), dtype=coo.values.dtype,
                      device=coo.values.device)
    out.scatter_add_(-1, safe, vals)
    return out.reshape(*batch, n, m)


def nnz(coo: CooMatrix) -> torch.Tensor:
    """Number of live entries (per stacked slice)."""
    return (coo.idx >= 0).sum(-1, dtype=torch.int32)
