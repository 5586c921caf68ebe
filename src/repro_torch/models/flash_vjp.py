"""Flash attention with a hand-written backward, in PyTorch (port of
``repro/models/flash_vjp.py``).

Differentiating through a blockwise softmax would make autograd keep the
per-block probabilities - the whole O(T^2) score matrix per layer. The flash
backward keeps only ``(q, k, v, out, lse)`` and recomputes the probabilities
block by block:

Forward:  online softmax over kv blocks.
Backward: D = rowsum(dO * O); per (q block, kv block): P = exp(S - lse),
          dV += P^T dO;  dS = P * (dO V^T - D);  dQ += dS K * scale;
          dK += dS^T Q * scale.  GQA folds the group axis into dK and dV.

The math is the JAX package's (a ``jnp`` custom VJP, not a Pallas kernel), so
this is plain PyTorch. One difference in the order of work, not in the
numbers: under ``causal`` a kv block that lies wholly above the diagonal is
skipped; the JAX loop visits it and adds exact zeros (its probabilities
underflow to 0 once the first block, which holds key 0, has set the row max).

``causal_offset`` shifts the diagonal: query row i sees keys j <= i +
offset. A chunk prefilled into a contiguous cache of S positions, whose
first query sits at the cache's length, attends with offset = that length
(``models/attention.py``), as the JAX package's does.

``scheme='balanced'`` runs the forward of ``models/flash_balanced.py`` when
it applies (causal, T == S, T a multiple of the q block), as JAX
``flash_vjp.py`` dispatches; the backward is the full scheme's either way,
since the saved ``(q, k, v, out, lse)`` do not depend on the scheme.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .flash_balanced import balanced_causal_fwd

__all__ = ["flash_attention_vjp"]

NEG_INF = -1e30


def _pad(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = -x.shape[2] % mult
    return F.pad(x, (0, 0, 0, pad)) if pad else x


class _Blocks:
    """q / k / v padded to block multiples and split into blocks, in f32."""

    def __init__(self, q, k, v, q_block, kv_block, offset):
        b, hq, t, d = q.shape
        self.offset = offset
        _, hkv, s, _ = k.shape
        self.b, self.hkv, self.g, self.t, self.s, self.d = b, hkv, hq // hkv, t, s, d
        self.scale = 1.0 / math.sqrt(d)
        self.bq, self.bk = min(q_block, t), min(kv_block, s)
        qp, kp, vp = _pad(q, self.bq), _pad(k, self.bk), _pad(v, self.bk)
        self.tq, self.sk = qp.shape[2], kp.shape[2]
        self.nq, self.nk = self.tq // self.bq, self.sk // self.bk
        self.qb = qp.reshape(b, hkv, self.g, self.nq, self.bq, d).float() * self.scale
        self.kb = kp.reshape(b, hkv, self.nk, self.bk, d).float()
        self.vb = vp.reshape(b, hkv, self.nk, self.bk, d).float()

    def kv_range(self, qi: int, causal: bool) -> range:
        """kv blocks that hold a key some row of q block ``qi`` may see (the
        first block is always visited: it sets every row's max)."""
        if not causal:
            return range(self.nk)
        last_q = (qi + 1) * self.bq - 1 + self.offset
        return range(max(1, min(self.nk, last_q // self.bk + 1)))

    def mask(self, qi: int, ki: int, causal: bool, device) -> torch.Tensor:
        k_pos = ki * self.bk + torch.arange(self.bk, device=device)
        m = (k_pos < self.s)[None, :]
        if causal:
            q_pos = qi * self.bq + torch.arange(self.bq, device=device)
            m = m & (q_pos[:, None] + self.offset >= k_pos[None, :])
        return m                                        # (bq, bk)


def _forward(q, k, v, causal, q_block, kv_block, offset):
    blk = _Blocks(q, k, v, q_block, kv_block, offset)
    shape = (blk.b, blk.hkv, blk.g, blk.bq)
    outs, lses = [], []
    for qi in range(blk.nq):
        q_i = blk.qb[:, :, :, qi]
        m = torch.full((*shape, 1), NEG_INF, device=q.device)
        l = torch.zeros((*shape, 1), device=q.device)
        acc = torch.zeros((*shape, blk.d), device=q.device)
        for ki in blk.kv_range(qi, causal):
            sc = torch.einsum("bhgqd,bhkd->bhgqk", q_i, blk.kb[:, :, ki])
            sc = torch.where(blk.mask(qi, ki, causal, q.device), sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1, keepdim=True)
            acc = corr * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, blk.vb[:, :, ki])
            m = m_new
        lses.append(m[..., 0] + torch.log(torch.clamp_min(l[..., 0], 1e-30)))
        outs.append(acc / torch.clamp_min(l, 1e-30))
    out = torch.stack(outs, 3).reshape(blk.b, blk.hkv * blk.g, blk.tq, blk.d)
    return out[:, :, :blk.t].to(q.dtype), torch.stack(lses, 3)   # lse (b,hkv,g,nq,bq)


def _backward(q, k, v, out, lse, dout, causal, q_block, kv_block, offset):
    blk = _Blocks(q, k, v, q_block, kv_block, offset)
    g_shape = (blk.b, blk.hkv, blk.g, blk.nq, blk.bq, blk.d)
    dob = _pad(dout, blk.bq).reshape(g_shape).float()
    ob = _pad(out, blk.bq).reshape(g_shape).float()
    ddelta = (dob * ob).sum(-1)                                   # (b,hkv,g,nq,bq)
    dk = torch.zeros_like(blk.kb)
    dv = torch.zeros_like(blk.vb)
    dq_chunks = []
    for qi in range(blk.nq):
        q_i, do_i = blk.qb[:, :, :, qi], dob[:, :, :, qi]
        lse_i = lse[:, :, :, qi][..., None]
        dd_i = ddelta[:, :, :, qi][..., None]
        dq_i = torch.zeros_like(q_i)
        for ki in blk.kv_range(qi, causal):
            k_j, v_j = blk.kb[:, :, ki], blk.vb[:, :, ki]
            sc = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_j)
            sc = torch.where(blk.mask(qi, ki, causal, q.device), sc, NEG_INF)
            p = torch.exp(sc - lse_i)
            dv[:, :, ki] += torch.einsum("bhgqk,bhgqd->bhkd", p, do_i)
            ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", do_i, v_j) - dd_i)
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
            # q_i already carries the 1/sqrt(d) factor, so dK needs no other
            dk[:, :, ki] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_i)
        dq_chunks.append(dq_i * blk.scale)
    dq = torch.stack(dq_chunks, 3).reshape(blk.b, blk.hkv * blk.g, blk.tq, blk.d)
    dk = dk.reshape(blk.b, blk.hkv, blk.sk, blk.d)
    dv = dv.reshape(blk.b, blk.hkv, blk.sk, blk.d)
    return (dq[:, :, :blk.t].to(q.dtype), dk[:, :, :blk.s].to(k.dtype),
            dv[:, :, :blk.s].to(v.dtype))


def _takes_balanced(q, k, causal, q_block, scheme) -> bool:
    t = q.shape[2]
    return scheme == "balanced" and causal and t == k.shape[2] and t % min(q_block, t) == 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block, offset, scheme):
        if _takes_balanced(q, k, causal, q_block, scheme):
            out, lse = balanced_causal_fwd(q, k, v, q_block, offset)
            lse = lse.permute(1, 2, 3, 0, 4)          # (nq, b, ...) -> the full scheme's
        else:
            out, lse = _forward(q, k, v, causal, q_block, kv_block, offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_block, kv_block, offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_block: int = 512,
                        kv_block: int = 1024, causal_offset: int = 0,
                        scheme: str = "full") -> torch.Tensor:
    """q (B, Hq, T, D) over k, v (B, Hkv, S, D), GQA by head groups; query
    row i sees keys j <= i + ``causal_offset`` under ``causal``.
    Differentiable in q, k and v with O(T) saved state; the output is
    q.dtype. ``scheme`` is ``'full'`` or ``'balanced'``."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_block), int(kv_block),
                                 int(causal_offset), scheme)
