"""Paper LLaMA-130m: the SALAAD experimental family (GaLore/SLTrain dims)."""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="salaad-llama-130m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    param_dtype=torch.float32,   # paper trains fp32 (§5.1)
    source="paper §5.1; Touvron et al. 2023 family",
)
