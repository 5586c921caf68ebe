"""Block-CSC container for the sparse component S (host side of
``repro/kernels/bsr_matmul.py``).

Layout (column-major over output blocks, padded to a fixed per-column count):
    counts  (JB,)              int32 - live blocks feeding output column jb
    rows    (JB, MAXB)         int32 - input row-block index of each block
    vals    (JB, MAXB, bs, bs) float - the tile data (zero-padded)

Dims that do not divide ``block_size`` are zero-padded at conversion, so the
tables cover ``ceil(n/bs) x ceil(m/bs)`` tiles. This layout is the contract
the fused SLR kernel (``slr_matmul.py``) and the bridge share. The sparse-only
``bsr_matmul`` kernel is a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["BsrMatrix", "bsr_from_dense", "bsr_to_dense"]


@dataclass(frozen=True)
class BsrMatrix:
    counts: torch.Tensor      # (JB,) int32
    rows: torch.Tensor        # (JB, MAXB) int32
    vals: torch.Tensor        # (JB, MAXB, bs, bs)
    shape: tuple[int, int]    # original dense (n, m), pre-padding
    block_size: int
    empty: bool = False       # no live blocks anywhere

    @property
    def padded_shape(self) -> tuple[int, int]:
        bs = self.block_size
        n, m = self.shape
        return (-(-n // bs) * bs, -(-m // bs) * bs)


def bsr_from_dense(s, block_size: int = 128, maxb: int | None = None,
                   device=None) -> BsrMatrix:
    """Deploy-time conversion of a dense sparse matrix to block-CSC (numpy
    work, as in the JAX package; the tables land on ``device``, default the
    input's device or the CPU)."""
    if isinstance(s, torch.Tensor):
        device = s.device if device is None else device
        s = s.detach().cpu().numpy()
    s = np.asarray(s)
    n, m = s.shape
    bs = block_size
    if n % bs or m % bs:
        s = np.pad(s, ((0, -n % bs), (0, -m % bs)))
    ib, jb = s.shape[0] // bs, s.shape[1] // bs
    tiles = s.reshape(ib, bs, jb, bs).transpose(0, 2, 1, 3)   # (ib, jb, bs, bs)
    live = np.abs(tiles).max(axis=(2, 3)) > 0
    counts = live.sum(axis=0).astype(np.int32)
    live_max = int(counts.max()) if counts.size else 0
    if maxb is None:
        maxb = max(live_max, 1)
    elif maxb < max(live_max, 1):
        raise ValueError(f"maxb={maxb} < live maximum {live_max}")
    rows = np.zeros((jb, maxb), np.int32)
    vals = np.zeros((jb, maxb, bs, bs), s.dtype)
    for j in range(jb):
        live_rows = np.nonzero(live[:, j])[0]
        rows[j, : len(live_rows)] = live_rows
        vals[j, : len(live_rows)] = tiles[live_rows, j]
    dev = torch.device("cpu") if device is None else device
    return BsrMatrix(torch.from_numpy(counts).to(dev), torch.from_numpy(rows).to(dev),
                     torch.from_numpy(vals).to(dev), (n, m), bs,
                     empty=live_max == 0)


def bsr_to_dense(bsr: BsrMatrix) -> torch.Tensor:
    n, m = bsr.shape
    n_pad, _ = bsr.padded_shape
    bs = bsr.block_size
    jb, maxb = bsr.rows.shape
    slot = torch.arange(maxb, device=bsr.rows.device)[None, :] < bsr.counts[:, None]
    vals = torch.where(slot[:, :, None, None], bsr.vals, torch.zeros_like(bsr.vals))
    dense = torch.zeros((n_pad // bs, jb, bs, bs), dtype=bsr.vals.dtype,
                        device=bsr.vals.device)
    cols = torch.arange(jb, device=bsr.rows.device)
    for t in range(maxb):
        dense.index_put_((bsr.rows[:, t].long(), cols), vals[:, t], accumulate=True)
    return dense.permute(0, 2, 1, 3).reshape(n_pad, jb * bs)[:n, :m]
