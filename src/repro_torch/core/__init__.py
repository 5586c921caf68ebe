"""SALAAD core: Algorithm 1 (penalty, prox sweep, I-controller), HPA and
the SLR storage."""
from .admm import (  # noqa: F401
    BlockSLR,
    SalaadConfig,
    SLRState,
    admm_update,
    init_slr_state,
    penalty,
    slr_param_count,
    surrogate_params,
)
from .controller import ControllerConfig, controller_update  # noqa: F401
from .prox import (  # noqa: F401
    density,
    effective_rank_ratio,
    effective_rank_ratio_from_singular_values,
    soft_threshold,
    svt,
    svt_from_svd,
)
from .rpca import rpca  # noqa: F401
from .rsvd import randomized_svd, rank_cap, sketch  # noqa: F401
from .salaad import Salaad  # noqa: F401
from .scaling import PAPER_RHO_CONSTANT, rho_for_block  # noqa: F401
from .selection import BlockInfo, SelectionConfig, select_blocks  # noqa: F401
from .sparse import CooMatrix  # noqa: F401
