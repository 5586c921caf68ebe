"""Block-CSC sparse matmul  y = x @ S  (port of ``repro/kernels/bsr_matmul.py``).

Layout (column-major over output blocks, padded to a fixed per-column count):
    counts  (JB,)              int32 - live blocks feeding output column jb
    rows    (JB, MAXB)         int32 - input row-block index of each block
    vals    (JB, MAXB, bs, bs) float - the tile data (zero-padded)

Dims that do not divide ``block_size`` are zero-padded at conversion, so the
tables cover ``ceil(n/bs) x ceil(m/bs)`` tiles. This layout is the contract
the fused SLR kernel (``slr_matmul.py``), this module's kernel and the bridge
share. ``bsr_matmul`` runs the plain version for CPU tensors and the CUDA
kernel ``csrc/bsr_matmul.cu`` (the stream kernel over each column block's
live tiles, cut by ``bsr_plan``) for CUDA tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import functools

import numpy as np
import torch

from . import ref
from ._build import check_cuda, check_int32, dtype_code, launch, table_dtype_code
from .stream import StreamPlan, card_sms, segment_count

__all__ = ["BsrMatrix", "bsr_from_dense", "bsr_to_dense", "bsr_matmul", "bsr_plan",
           "row_tile", "BLOCK_SIZES"]

# block sizes the kernels are instantiated for: every size _fit_block produces
BLOCK_SIZES = (8, 16, 32, 64, 128)


def row_tile(t_dim: int, dtype: torch.dtype, cap: int = 128) -> int:
    """The JAX kernels' decode-width row tile: T rounded up to the dtype's
    sublane tile, capped at ``cap`` (a 4-row decode batch runs at 8 rows, not
    128). The CUDA kernels take their rows per block from ``StreamPlan.cut``
    and the fused plans; this is the TPU rule's counterpart, held against it
    by the tests."""
    sub = {4: 8, 2: 16, 1: 32}.get(dtype.itemsize, 8)
    return min(cap, -(-t_dim // sub) * sub)


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


@functools.lru_cache(maxsize=4096)
def bsr_plan(n: int, m: int, bs: int, maxb: int, x_size: int, w_size: int,
             sms: int) -> StreamPlan:
    """The launch plan of a block-CSC product over an (n, m) S of bs x bs
    tiles with MAXB slots per column block, x of ``x_size`` bytes per value
    and tiles of ``w_size``, on a card of ``sms`` SMs; never T.

    Columns per block: 16 for bs < 32 (an mma tile is 16 columns), bs up to
    64, two parts of 64 at bs = 128; stages of min(bs, 32) rows; segments:
    the most (up to 8, a power of two) that a full column block's stages
    (MAXB x bs / stage rows) fill. Raises where a block's shared memory would
    exceed the card's 227 KB."""
    if bs not in BLOCK_SIZES:
        raise ValueError(f"bsr_matmul: block size {bs} not in {BLOCK_SIZES}")
    bnb = 16 if bs < 32 else min(bs, 64)
    ks = min(bs, 32)
    plan = StreamPlan(bnb, ks, segment_count(maxb * bs // ks), -(-m // bs) * max(1, bs // bnb),
                      x_size, w_size, maxb, sms)
    return plan.check(f"bsr_matmul: n={n}, m={m}, bs={bs}, MAXB={maxb}")


def bsr_matmul(x: torch.Tensor, bsr: BsrMatrix) -> torch.Tensor:
    """x (T, n) @ block-CSC S (n, m) -> y (T, m) in x.dtype; vals share x's
    dtype, or are float32 under bfloat16 x."""
    if x.device.type == "cpu":
        return ref.bsr_matmul_ref(x, bsr)
    name = "bsr_matmul"
    dev = check_cuda(name, x=x, counts=bsr.counts, rows=bsr.rows, vals=bsr.vals)
    code = dtype_code(x.dtype)
    wcode = table_dtype_code(name, x.dtype, bsr.vals)
    check_int32(name, counts=bsr.counts, rows=bsr.rows)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (T, n), got {tuple(x.shape)}")
    t_dim, n_dim = x.shape
    n_s, m_dim = bsr.shape
    bs = bsr.block_size
    jb, maxb = bsr.rows.shape
    expect = {
        "x": ((n_dim,), (n_s,)),
        "counts": (tuple(bsr.counts.shape), (jb,)),
        "rows (column blocks)": ((jb,), (-(-m_dim // bs),)),
        "vals": (tuple(bsr.vals.shape), (jb, maxb, bs, bs)),
    }
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    plan = bsr_plan(n_dim, m_dim, bs, maxb, x.element_size(), bsr.vals.element_size(),
                    card_sms(dev.index))
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    xrows, split = plan.cut(t_dim)
    launch("bsr_matmul_launch", dev, x.data_ptr(), bsr.counts.data_ptr(),
           bsr.rows.data_ptr(), bsr.vals.data_ptr(), y.data_ptr(), t_dim, n_dim, m_dim,
           jb, maxb, bs, plan.nseg, xrows, split, code, wcode)
    bsr_matmul.launches += 1
    return y


bsr_matmul.launches = 0
