"""ArchConfig with torch dtypes, and the registry of the configurations the
port serves so far: the paper's dense Llama family (``salaad_llama_*``).

Field names, defaults and ``reduced()`` follow ``repro/configs/base.py`` so a
test can build the same architecture on both sides. Only the fields the dense
Llama family sets are here (RMSNorm, SwiGLU, RoPE, no biases, an untied LM
head); the other families and their fields come with their slices.
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
    rope_theta: float = 1e4
    param_dtype: Any = torch.bfloat16
    # dense | blockwise: plain masked-softmax attention without a cache;
    # pallas: the paged CUDA kernels for cached attention (the no-cache
    # flash kernel is a later slice and raises)
    kernel_impl: str = "blockwise"
    source: str = ""

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims (the numbers of
        ``repro.configs.base.ArchConfig.reduced`` for the dense family)."""
        def shrink(v, lo, hi):
            return max(lo, min(v, hi))

        kv = shrink(self.num_kv_heads, 1, 2) if self.num_kv_heads else 0
        heads = 0
        if self.num_heads:
            group = max(1, self.num_heads // max(self.num_kv_heads, 1))
            heads = kv * shrink(group, 1, 2)
        return replace(
            self,
            num_layers=shrink(self.num_layers, 2, 4),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            param_dtype=torch.float32,
            kernel_impl="dense",
        )


ARCH_IDS = [
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
            f"{ARCH_IDS} (the other families come with their model slices)"
        )
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
