"""The baselines the paper compares against (Table 1), as weight-space
reparameterizations and an optimizer transform over the same model code
(port of ``repro/baselines``)."""
from .reparam import (  # noqa: F401
    FullRank,
    GaLoreAdam,
    LoRAReparam,
    SLTrainReparam,
    train_baseline,
)
