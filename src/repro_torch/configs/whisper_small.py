"""Whisper-small: encoder-decoder; conv frontend is a STUB supplying
precomputed frame embeddings (input_specs). [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_theta=None,          # absolute sinusoidal positions
    encoder_layers=12,
    encoder_seq=1500,
    source="arXiv:2212.04356; unverified",
)
