"""Balanced-causal flash attention forward: only the lower triangle's score
blocks (port of ``repro/models/flash_balanced.py``).

The JAX scan visits every (q chunk, kv chunk) pair and masks the upper
triangle; this scheme pairs q chunk i with q chunk nq-1-i, which together
need (i + 1) + (nq - i) = nq + 1 kv-chunk visits, so every pair of the loop
does the same work and the whole forward visits ceil(nq / 2) * (nq + 1)
blocks. Each step computes one score block for whichever chunk of the pair
needs it: the first i + 1 steps serve chunk i (kv chunks 0..i), the rest
chunk nq-1-i (kv chunks 0..nq-1-i); with odd nq the middle chunk is its own
partner and is served once.

Plain PyTorch, as the JAX module is plain ``jnp``: each chunk sees its kv
chunks in the order the full scheme visits them, with the same online-softmax
arithmetic. The port's full scheme (``models/flash_vjp.py``) already skips
the kv blocks above the diagonal, so this ports the configuration and its
numbers, not a speed-up. Forward only: the backward is the full scheme's.
"""
from __future__ import annotations

import math

import torch

__all__ = ["balanced_causal_fwd"]

NEG_INF = -1e30


def balanced_causal_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_block: int = 512, causal_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, T, D) over k, v (B, Hkv, T, D), GQA by head groups; query
    row i sees keys j <= i + ``causal_offset``. Returns ``(out (B, Hq, T, D)
    in q.dtype, lse (nq, B, Hkv, G, bq) in f32)``, the JAX package's layout.
    Needs T == S and T a multiple of ``min(q_block, T)``."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    bq = min(q_block, t)
    if t != s or t % bq:
        raise ValueError(f"balanced scheme needs T == S and T % q_block == 0, got T={t}, "
                         f"S={s}, q_block={q_block}")
    group = hq // hkv
    nq = t // bq
    qb = q.reshape(b, hkv, group, nq, bq, d).float() * (1.0 / math.sqrt(d))
    kb = k.reshape(b, hkv, nq, bq, d).float()
    vb = v.reshape(b, hkv, nq, bq, d).float()
    pos = torch.arange(t, device=q.device).reshape(nq, bq)
    shape = (b, hkv, group, bq)

    def serve(c: int, kv_chunks: int):
        """Chunk ``c``'s online softmax over kv chunks 0..kv_chunks-1."""
        m = torch.full((*shape, 1), NEG_INF, device=q.device)
        l = torch.zeros((*shape, 1), device=q.device)
        acc = torch.zeros((*shape, d), device=q.device)
        for kv in range(kv_chunks):
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qb[:, :, :, c], kb[:, :, kv])
            seen = (pos[c][:, None] + causal_offset) >= pos[kv][None, :]
            sc = torch.where(seen, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1, keepdim=True)
            acc = corr * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vb[:, :, kv])
            m = m_new
        lse = m[..., 0] + torch.log(torch.clamp_min(l[..., 0], 1e-30))
        return acc / torch.clamp_min(l, 1e-30), lse

    outs, lses = [None] * nq, [None] * nq
    for i in range((nq + 1) // 2):
        j = nq - 1 - i
        outs[i], lses[i] = serve(i, i + 1)            # steps 0..i of the pair
        if j != i:                                    # steps i+1..nq of the pair
            outs[j], lses[j] = serve(j, nq - i)
    out = torch.stack(outs, 3).reshape(b, hq, t, d)
    return out.to(q.dtype), torch.stack(lses)
