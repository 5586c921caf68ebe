"""TrainState: everything a training step touches (port of
``repro/train/state.py``).

The SALAAD surrogate state rides along (``slr``): the stage-1 step only
reads it (the penalty's cached target Z), the stage-2 ``admm_step`` replaces
it every K steps. ``step`` and the optimizer's ``count`` are host integers:
the loop, the schedule and the rSVD sketch keys read them without a device
sync. The checkpoint stores them as int32 scalars, as the JAX package does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from ..core.admm import SalaadConfig, SLRState, init_slr_state
from ..core.selection import BlockInfo
from ..optim.adam import AdamState, init_adam

__all__ = ["TrainState", "init_train_state"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    slr: SLRState           # {} when SALAAD is off (the vanilla baseline)
    step: int


def init_train_state(params: Any, salaad_cfg: SalaadConfig | None
                     ) -> tuple[TrainState, list[BlockInfo]]:
    if salaad_cfg is None:
        slr, blocks = {}, []
    else:
        slr, blocks = init_slr_state(params, salaad_cfg)
    return TrainState(params=params, opt=init_adam(params), slr=slr, step=0), blocks
