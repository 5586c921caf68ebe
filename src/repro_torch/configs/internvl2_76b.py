"""InternVL2-76B backbone (InternLM2-style LLM); InternViT frontend is a
STUB supplying precomputed patch embeddings. [arXiv:2404.16821]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_patches=256,
    source="arXiv:2404.16821; unverified",
)
