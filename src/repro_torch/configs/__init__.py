"""Architecture configs (torch dtypes)."""
from .base import ARCH_IDS, ArchConfig, get_arch  # noqa: F401
