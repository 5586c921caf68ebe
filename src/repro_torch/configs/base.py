"""ArchConfig with torch dtypes, the input-shape grid, and the registry of
every architecture of the JAX package (port of ``repro/configs/base.py``).

Field names, defaults, ``reduced()``, ``SHAPES``, ``ARCH_IDS`` and
``runnable_cells()`` follow the JAX package, so a test can build the same
architecture on both sides.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any

import torch

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "ARCH_IDS", "runnable_cells"]


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
    # --- moe ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- ssm / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0         # hybrid: shared attn block after every k ssm layers
    # --- variants ---
    mlp_type: str = "swiglu"    # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | nonparam_ln | layernorm
    qkv_bias: bool = False
    rope_theta: float | None = 1e4  # None => sinusoidal absolute positions (whisper)
    tie_embeddings: bool = False
    # --- encdec (audio): the frontend is a stub providing frame embeddings ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- vlm: the frontend is a stub providing patch embeddings ---
    num_patches: int = 0
    # --- numerics / execution ---
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
    causal_scheme: str = "full"         # full | balanced (models/flash_balanced.py)
    moe_groups: int | None = None       # dispatch groups: kept for config compatibility
    scan_unroll: int | bool = 1         # the JAX scans' unroll: unused by the layer loops
    source: str = ""

    def __post_init__(self):
        if self.causal_scheme not in ("full", "balanced"):
            raise ValueError(f"causal_scheme={self.causal_scheme!r}: expected 'full' or "
                             "'balanced'")

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims (the numbers of
        ``repro.configs.base.ArchConfig.reduced``; MoE dropless, so prefill
        plus decode equals the full forward)."""
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
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            capacity_factor=(
                float(min(self.num_experts, 4)) / max(min(self.top_k, 2), 1)
                if self.num_experts else self.capacity_factor),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            encoder_layers=shrink(self.encoder_layers, 0, 2),
            encoder_seq=min(self.encoder_seq, 16),
            num_patches=min(self.num_patches, 8),
            param_dtype=torch.float32,
            remat=False,
            kernel_impl="dense",
            attn_q_block=32,
            attn_kv_block=32,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "zamba2_2p7b",
    "dbrx_132b",
    "qwen3_moe_30b_a3b",
    "whisper_small",
    "olmo_1b",
    "phi3_medium_14b",
    "gemma_7b",
    "qwen1p5_4b",
    "internvl2_76b",
    "mamba2_370m",
    # the paper's own LLaMA family
    "salaad_llama_60m",
    "salaad_llama_130m",
    "salaad_llama_350m",
    "salaad_llama_1b",
]


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def runnable_cells() -> list[tuple[str, str]]:
    """The assigned (arch x shape) grid, minus the documented skips:
    quadratic attention at 524k positions is skipped."""
    cells = []
    for a in ARCH_IDS[:10]:
        cfg = get_arch(a)
        for s in SHAPES.values():
            if s.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((a, s.name))
    return cells
