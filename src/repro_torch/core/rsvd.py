"""Randomized SVD (range finder + QR power iterations) and the rank cap of its
sketch (port of ``repro/core/rsvd.py``).

The sketch Omega is an explicit argument. ``sketch`` draws one from a CPU
``torch.Generator`` seeded from a tuple of integers - the ADMM sweep keys it
by (step, block index, slice, sweep) - and the caller moves it to the
device, so:
  * the card and the CPU draw the same sketch;
  * a restored run replays the same step bit for bit (the sketch depends on
    the step counter only, not on a generator's running state);
  * a test can hand in the Omega the JAX package draws for its key.
Torch's generator gives other numbers than ``jax.random.normal``: the two
packages agree on a sketch only when it is handed over.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["randomized_svd", "rank_cap", "sketch"]


def rank_cap(n: int, m: int, cap_ratio: float = 0.25, minimum: int = 8) -> int:
    """Sketch size for a block of shape (n, m): ``cap_ratio * min(n, m)``,
    at least ``minimum``, rounded up to 128 once it reaches 128."""
    r = max(minimum, int(cap_ratio * min(n, m)))
    if r >= 128:
        r = (r + 127) // 128 * 128
    return min(r, min(n, m))


def sketch(key: tuple[int, ...], m: int, r: int) -> torch.Tensor:
    """Gaussian sketch (m, r) float32 on the CPU, a pure function of ``key``
    (non-negative integers)."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed >> 1)
    return torch.randn((m, r), generator=gen, dtype=torch.float32)


def randomized_svd(a: torch.Tensor, omega: torch.Tensor, n_iter: int = 2):
    """Top-r SVD of ``a`` (..., n, m) from the sketch ``omega`` (..., m, r):
    returns U (..., n, r), s (..., r), Vt (..., r, m), in a's dtype.

      Q = orth(A Omega);  Q = orth(A A^T Q) ``n_iter`` times (QR after each
      product);  B = Q^T A (r, m);  SVD(B);  U = Q U_B.

    Leading dims are a batch of independent blocks. Runs in f32.
    """
    a32 = a.float()
    at = a32.transpose(-2, -1)
    q = torch.linalg.qr(a32 @ omega.to(a32))[0]
    for _ in range(n_iter):
        q = torch.linalg.qr(at @ q)[0]
        q = torch.linalg.qr(a32 @ q)[0]
    b = q.transpose(-2, -1) @ a32
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    return (q @ ub).to(a.dtype), s.to(a.dtype), vt.to(a.dtype)
