"""Mamba2-370M: attention-free SSD. [arXiv:2405.21060]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    source="arXiv:2405.21060; unverified",
)
