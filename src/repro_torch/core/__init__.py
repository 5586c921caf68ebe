"""SALAAD core: the parts of the ADMM machinery the serving slice needs."""
from .admm import (  # noqa: F401
    BlockSLR,
    SalaadConfig,
    SLRState,
    admm_update,
    init_slr_state,
    surrogate_params,
)
from .controller import ControllerConfig, controller_update  # noqa: F401
from .prox import effective_rank_ratio_from_singular_values, soft_threshold  # noqa: F401
from .rsvd import rank_cap  # noqa: F401
from .scaling import PAPER_RHO_CONSTANT, rho_for_block  # noqa: F401
from .selection import BlockInfo, SelectionConfig, select_blocks  # noqa: F401
from .sparse import CooMatrix  # noqa: F401
