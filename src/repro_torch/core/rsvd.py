"""Rank cap of the SVD sketch (port of ``rank_cap`` from
``repro/core/rsvd.py``).

``randomized_svd`` itself is ported with the training slice; until then
``admm_update`` runs the exact-SVD path only.
"""
from __future__ import annotations

__all__ = ["rank_cap"]


def rank_cap(n: int, m: int, cap_ratio: float = 0.25, minimum: int = 8) -> int:
    """Sketch size for a block of shape (n, m): ``cap_ratio * min(n, m)``,
    at least ``minimum``, rounded up to 128 once it reaches 128."""
    r = max(minimum, int(cap_ratio * min(n, m)))
    if r >= 128:
        r = (r + 127) // 128 * 128
    return min(r, min(n, m))
