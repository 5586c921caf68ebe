"""Paper LLaMA-60m: the SALAAD experimental family (GaLore/SLTrain dims)."""
import torch

from .base import ArchConfig

CONFIG = ArchConfig(
    name="salaad-llama-60m",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=1376,
    vocab_size=32000,
    param_dtype=torch.float32,   # paper trains fp32 (§5.1)
    source="paper §5.1; Touvron et al. 2023 family",
)
