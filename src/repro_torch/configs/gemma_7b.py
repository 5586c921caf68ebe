"""Gemma-7B: GeGLU, head_dim 256. [arXiv:2403.08295; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    source="arXiv:2403.08295; hf",
)
