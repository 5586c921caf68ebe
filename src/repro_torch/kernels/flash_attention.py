"""Flash attention forward (port of
``repro/kernels/flash_attention.py::flash_attention_pallas``).

q (B, Hq, T, D) attends k / v (B, Hkv, S, D) with GQA (q head h reads KV head
h // (Hq // Hkv)). Under ``causal`` query row i sees keys j <= i, positions
counted from 0 on both sides: the Pallas kernel's alignment, which is the
model's whenever T == S. The output is q.dtype.

It takes the shapes the Pallas wrapper takes - T <= 128 or T a multiple of
128, the same for S - and raises on any other, as the Pallas wrapper asserts,
unless the caller passes ``any_length=True``: the CUDA kernel masks ragged T
and S itself, and the encoder-decoder's 1500 frames are no block multiple.
The model's attention always passes True; the default False exists only so
that the shape checks can hold this wrapper to the Pallas wrapper's rule,
and a later clean-up may drop the flag with that rule.
Mixed f32 and bf16 operands run the f32 instance on widened copies and
return q.dtype, as the Pallas kernel computes in f32 whatever it is given.
``flash_attention`` runs the plain version for CPU tensors and the CUDA kernel
``csrc/flash_attention.cu`` for CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._build import check_cuda, dtype_code, launch

__all__ = ["flash_attention", "BLOCK", "MAX_HEAD_DIM"]

BLOCK = 128          # the Pallas wrapper's default bq = bk
MAX_HEAD_DIM = 256


def _check_seq(name: str, what: str, n: int):
    if n < 1 or (n > BLOCK and n % BLOCK):
        raise ValueError(f"{name}: {what}={n} must be <= {BLOCK} or a multiple of "
                         f"{BLOCK} (pad sequence lengths to block multiples)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    any_length: bool = False) -> torch.Tensor:
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: expected q (B, Hq, T, D) and k, v (B, Hkv, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, t_dim, d = q.shape
    _, hkv, s_dim, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k {tuple(k.shape)} "
                         "(batch, head dim, GQA grouping)")
    if not any_length:
        _check_seq(name, "T", t_dim)
        _check_seq(name, "S", s_dim)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale, offset=0)
    dev = check_cuda(name, q=q, k=k, v=v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        if {q.dtype, k.dtype, v.dtype} <= {torch.float32, torch.bfloat16}:
            # bf16 queries over an f32 cache (the reference engine's cross
            # heads) or the reverse: the Pallas kernel casts every operand
            # to f32 and its output to q's dtype; widening is exact
            return flash_attention(q.float(), k.float(), v.float(), causal, scale,
                                   any_length).to(q.dtype)
        raise TypeError(f"{name}: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    code = dtype_code(q.dtype)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    launch("flash_attention_launch", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, hq, hkv, t_dim, s_dim, d, int(causal), float(scale), code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
