"""Paper LLaMA-350m: the SALAAD experimental family (GaLore/SLTrain dims)."""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="salaad-llama-350m",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2736,
    vocab_size=32000,
    param_dtype=torch.float32,   # paper trains fp32 (§5.1)
    source="paper §5.1; Touvron et al. 2023 family",
)
