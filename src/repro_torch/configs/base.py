"""ArchConfig with torch dtypes, and the registry of the configurations the
port serves: the paper's dense Llama family (``salaad_llama_*``) and the
Zamba2 hybrid (``zamba2_2p7b``: Mamba2 layers with one shared attention +
SwiGLU block).

Field names, defaults and ``reduced()`` follow ``repro/configs/base.py`` so a
test can build the same architecture on both sides. The fields are those the
ported families read (RMSNorm, SwiGLU, RoPE, no biases, an untied LM head,
the SSM and hybrid dimensions) and the execution fields; the MoE, enc-dec
and vision fields come with their families.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any

import torch

__all__ = ["ArchConfig", "get_arch", "ARCH_IDS"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0         # hybrid: shared attn block after every k ssm layers
    # --- variants ---
    mlp_type: str = "swiglu"    # swiglu (geglu and gelu come with their families)
    norm_type: str = "rmsnorm"  # rmsnorm (the layernorms come with their families)
    rope_theta: float = 1e4
    param_dtype: Any = torch.bfloat16
    # recompute each layer's activations in the backward pass
    # (torch.utils.checkpoint): memory, not numbers
    remat: bool = True
    # attention without a cache: blockwise = the flash forward/backward in
    # PyTorch (models/flash_vjp.py), dense = masked softmax, pallas = the
    # CUDA flash kernel (forward only); with a paged cache: pallas = the
    # CUDA paged kernels, otherwise gather + masked softmax
    kernel_impl: str = "blockwise"
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    causal_scheme: str = "full"         # full; balanced is a later slice
    source: str = ""

    def __post_init__(self):
        if self.mlp_type != "swiglu" or self.norm_type != "rmsnorm":
            raise ValueError(
                f"mlp_type={self.mlp_type!r} / norm_type={self.norm_type!r} are not "
                "ported yet: the ported families use swiglu and rmsnorm")
        if self.causal_scheme != "full":
            raise ValueError(
                f"causal_scheme={self.causal_scheme!r} is not ported yet: the "
                "triangle-only flash scheme (models/flash_balanced.py) is a later slice")

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims (the numbers of
        ``repro.configs.base.ArchConfig.reduced``)."""
        def shrink(v, lo, hi):
            return max(lo, min(v, hi))

        kv = shrink(self.num_kv_heads, 1, 2) if self.num_kv_heads else 0
        heads = 0
        if self.num_heads:
            group = max(1, self.num_heads // max(self.num_kv_heads, 1))
            heads = kv * shrink(group, 1, 2)
        return replace(
            self,
            num_layers=shrink(self.num_layers, 2,
                              4 if self.attn_every == 0 else self.attn_every * 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            param_dtype=torch.float32,
            remat=False,
            kernel_impl="dense",
            attn_q_block=32,
            attn_kv_block=32,
        )


ARCH_IDS = [
    "zamba2_2p7b",
    "salaad_llama_60m",
    "salaad_llama_130m",
    "salaad_llama_350m",
    "salaad_llama_1b",
]


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id not in ARCH_IDS:
        raise ValueError(
            f"architecture {arch_id!r} is not ported yet; the port serves "
            f"{ARCH_IDS} (the other architectures come with their model slices)"
        )
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
