"""High-level SALAAD API: wrap any (loss, optimizer) into Algorithm 1 (port
of ``repro/core/salaad.py``).

    salaad = Salaad(cfg)
    slr_state = salaad.init(params)
    loss = task_loss(params, batch) + salaad.penalty(params, slr_state)  # stage 1
    ...every K steps...
    slr_state, stats = salaad.update(params, slr_state, step)            # stage 2
    deploy = salaad.surrogate(params, slr_state)                         # L + S
    slr_small, report = salaad.compress(slr_state, budget, kappa)        # HPA

No model or optimizer internals are touched: the trainer uses exactly this
interface, and so can any other training loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from . import admm, hpa
from .admm import SalaadConfig, SLRState
from .selection import BlockInfo

__all__ = ["Salaad", "SalaadConfig"]


@dataclass
class Salaad:
    cfg: SalaadConfig = field(default_factory=SalaadConfig)
    blocks: list[BlockInfo] | None = None

    def _blocks(self) -> list[BlockInfo]:
        if self.blocks is None:
            raise RuntimeError("call init() first")
        return self.blocks

    def init(self, params: Any) -> SLRState:
        state, self.blocks = admm.init_slr_state(params, self.cfg)
        return state

    def penalty(self, params: Any, state: SLRState) -> torch.Tensor:
        return admm.penalty(params, state, self._blocks())

    def update(self, params: Any, state: SLRState, step: int) -> tuple[SLRState, dict]:
        return admm.admm_update(params, state, self._blocks(), self.cfg, step)

    def surrogate(self, params: Any, state: SLRState) -> Any:
        return admm.surrogate_params(params, state, self._blocks())

    def compress(self, state: SLRState, remove_budget: int, kappa: float):
        return hpa.hpa_compress(state, self._blocks(), remove_budget, kappa)

    def param_count(self, state: SLRState) -> dict:
        return admm.slr_param_count(state, self._blocks())
