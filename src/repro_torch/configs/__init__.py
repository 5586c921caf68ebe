"""Architecture configs (torch dtypes)."""
from .base import ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, get_arch, runnable_cells  # noqa: F401
