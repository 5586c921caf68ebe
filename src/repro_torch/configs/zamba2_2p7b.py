"""Zamba2-2.7B: Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    source="arXiv:2411.15242; hf",
)
