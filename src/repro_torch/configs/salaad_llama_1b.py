"""Paper LLaMA-1b: the SALAAD experimental family (GaLore/SLTrain dims)."""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="salaad-llama-1b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5461,
    vocab_size=32000,
    param_dtype=torch.float32,   # paper trains fp32 (§5.1)
    source="paper §5.1; Touvron et al. 2023 family",
)
