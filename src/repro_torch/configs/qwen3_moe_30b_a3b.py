"""Qwen3-MoE-30B-A3B: 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
