"""Mamba2 (SSD, state-space duality) blocks: chunked prefill and O(1) decode
(port of ``repro/models/ssm.py``).

Chunked SSD (Dao & Gu 2024): the sequence splits into chunks of Q tokens;
inside a chunk the recurrence expands into a (Q, Q) lower-triangular
"attention" form, and the state carries from chunk to chunk through a loop.
Decode is the recurrent form: a (B, H, P, N) state updated per token.

Plain PyTorch: the JAX package has no kernel for these blocks. The numerics
follow it op for op, mixed precision included (``ssd_chunked``: the decay
and cumsum math in f32, the large intra-chunk tensors in the activation
dtype). Training differentiates ``ssd_chunked`` with autograd, as the JAX
package has no custom backward either; the (Q, Q) blocks and per-chunk
states it saves live only inside a layer's checkpoint when the model remats
(``ssm_lm.py``, ``hybrid.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .layers import rmsnorm

__all__ = ["SSMCache", "ssm_dims", "init_ssm_layer", "ssd_chunked", "ssm_block",
           "init_ssm_cache"]


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N)
    conv: torch.Tensor    # (B, K-1, conv_dim) rolling conv window
    length: int           # tokens seen (a host integer)


def ssm_dims(d_model: int, expand: int, head_dim: int, d_state: int, ngroups: int = 1):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * ngroups * d_state
    return d_inner, nheads, conv_dim


def init_ssm_layer(normal, d_model: int, expand: int, head_dim: int, d_state: int, dtype,
                   device, lead: tuple[int, ...] = ()) -> dict:
    """One Mamba2 layer's parameters with the JAX package's shapes and scales;
    ``normal(shape, scale)`` draws the random leaves (a tensor of ``shape``
    in ``dtype`` on ``device``), and ``lead`` stacks layers in front."""
    d_inner, nheads, conv_dim = ssm_dims(d_model, expand, head_dim, d_state)
    d_in_proj = 2 * d_inner + 2 * d_state + nheads

    def full(n, value):
        return torch.full((*lead, n), value, dtype=torch.float32, device=device)

    return {
        "in_proj": normal((*lead, d_model, d_in_proj), 1.0 / np.sqrt(d_model)),
        "conv_w": normal((*lead, 4, conv_dim), 0.2),
        "a_log": full(nheads, 0.0),          # A = -exp(a_log) = -1
        "dt_bias": full(nheads, -2.0),       # softplus ~ 0.12
        "d_skip": full(nheads, 1.0),
        "norm_scale": torch.zeros((*lead, d_inner), dtype=dtype, device=device),
        "out_proj": normal((*lead, d_inner, d_model), 1.0 / np.sqrt(d_inner)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, window: torch.Tensor | None = None):
    """Depthwise causal conv, k=4. x (B, L, C), w (4, C); ``window`` (B, 3, C)
    is the trailing context from a cache (zeros without one). Window and x
    meet in their promoted dtype, as in JAX. Returns (y, new window)."""
    b, l, c = x.shape
    k = w.shape[0]
    if window is None:
        window = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(window.dtype, x.dtype)
    xp = torch.cat([window.to(dt), x.to(dt)], dim=1)      # (B, L+3, C)
    y = sum(xp[:, i:i + l] * w[i][None, None] for i in range(k))
    return F.silu(y), xp[:, -(k - 1):]


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < t <= i} da[..., t]; -inf above the diagonal."""
    q = da.shape[-1]
    csum = torch.cumsum(da, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da.device))
    return torch.where(mask, diff, torch.full_like(diff, -float("inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, chunk: int = 128,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (B, L, H, P), dt (B, L, H) (softplus'd, > 0), a (H,)
    (negative), b_in / c_in (B, L, N) -> (y (B, L, H, P), final state
    (B, H, P, N) in f32). L must be a multiple of the chunk (or shorter than
    it): padding would change the final state."""
    bsz, l, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"seq {l} must divide chunk {q}")
    nc = l // q

    f32 = torch.float32
    cdt = x.dtype                      # compute dtype of the large tensors
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    da = dtc * a[None, None, None, :]  # (B, nc, q, h)

    # dt folds into x once: (dt_j x_j) appears in the intra and state terms
    xdt = (x.reshape(bsz, nc, q, h, p).to(f32) * dtc[..., None]).to(cdt)
    bc = b_in.reshape(bsz, nc, q, n).to(cdt)
    cc = c_in.reshape(bsz, nc, q, n).to(cdt)

    # intra-chunk (quadratic in q): Y_intra = (C B^T * L) (dt x)
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2))).to(cdt)     # (B, nc, h, q, q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)               # (B, nc, q, q)
    w = (scores[:, :, None] * lmat).to(cdt)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j
    cum = torch.cumsum(da, dim=2)                                   # (B, nc, q, h)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum).to(cdt)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end, bc, xdt).to(f32)

    # inter-chunk recurrence
    chunk_decay = torch.exp(da.sum(dim=2))                          # (B, nc, h)
    s = init_state.to(f32) if init_state is not None \
        else torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(prevs, dim=1)                             # (B, nc, h, p, n)

    # inter-chunk contribution: Y_inter_i = exp(cum_i) * C_i . S_prev
    in_decay = torch.exp(cum)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc.to(f32), s_prevs, in_decay)

    y = (y_intra.to(f32) + y_inter).reshape(bsz, l, h, p)
    return y.to(x.dtype), s


def ssm_block(params: dict, u: torch.Tensor, *, expand: int, head_dim: int, d_state: int,
              chunk: int = 128, cache: SSMCache | None = None
              ) -> tuple[torch.Tensor, SSMCache]:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.
    u (B, L, d_model). With a cache and L == 1 the recurrent decode step,
    else the chunked scan (from the cache's state when there is one).
    Returns ``(y, new cache)``; the cache argument is not modified."""
    bsz, l, d_model = u.shape
    d_inner, nheads, conv_dim = ssm_dims(d_model, expand, head_dim, d_state)
    n = d_state

    zxbcdt = u @ params["in_proj"]
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, nheads], dim=-1)
    window = cache.conv if cache is not None else None
    xbc, new_window = _causal_conv(xbc, params["conv_w"], window)
    x, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = torch.logaddexp(dt_raw.float() + params["dt_bias"], torch.zeros((), device=u.device))
    a = -torch.exp(params["a_log"])
    xh = x.reshape(bsz, l, nheads, head_dim)

    if cache is not None and l == 1:
        # recurrent decode: state' = state * exp(dt A) + dt * x B^T
        st = cache.state.float()
        dt1 = dt[:, 0]
        da = torch.exp(dt1 * a[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dt1, xh[:, 0].float(), b_in[:, 0].float())
        st_new = st * da[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", st_new, c_in[:, 0].float())[:, None]
        new_cache = SSMCache(st_new.to(cache.state.dtype), new_window, cache.length + 1)
    else:
        init_state = cache.state if cache is not None else None
        y, s_final = ssd_chunked(xh, dt, a, b_in, c_in, chunk=chunk, init_state=init_state)
        n0 = cache.length if cache is not None else 0
        new_cache = SSMCache(s_final.to(u.dtype), new_window, n0 + l)

    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, l, d_inner).to(u.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_scale"])
    return y @ params["out_proj"], new_cache


def init_ssm_cache(bsz: int, d_model: int, expand: int, head_dim: int, d_state: int,
                   dtype, device) -> SSMCache:
    _, nheads, conv_dim = ssm_dims(d_model, expand, head_dim, d_state)
    return SSMCache(
        state=torch.zeros((bsz, nheads, head_dim, d_state), dtype=dtype, device=device),
        conv=torch.zeros((bsz, 3, conv_dim), dtype=dtype, device=device),
        length=0,
    )
