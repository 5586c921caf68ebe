"""The rho scaling law (Eq. 7): rho = C / (N * sqrt(n*m)).

Same constant as ``repro/core/scaling.py``: calibrated so a LLaMA-350M lands
on the paper's rho = 5e-8 (Table 3).
"""
from __future__ import annotations

import math

__all__ = ["PAPER_RHO_CONSTANT", "rho_for_block"]

PAPER_RHO_CONSTANT = 0.014


def rho_for_block(n: int, m: int, num_blocks: int, constant: float = PAPER_RHO_CONSTANT) -> float:
    """Eq. (7): rho proportional to 1 / (N sqrt(n m))."""
    return constant / (num_blocks * math.sqrt(n * m))
