"""Host side of the stream kernel (``csrc/stream_matmul.cuh``), the tensor-core
body of the block-CSC kernel and of the low-rank kernel.

A ``StreamPlan`` is one product's launch plan. Its columns per block,
reduction rows per stage and segments per column block fix every output
element's sums: one chain of products per segment, the segments summed in
order. ``bsr_plan`` (``bsr_matmul.py``) and ``lowrank_plan``
(``lowrank_matmul.py``) build it from the table's shape, the dtypes and the
card, never from T or B. ``StreamPlan.cut`` then picks, per call, the rows
per block and whether a column block's segments run as a cluster of blocks
(``split``) or one block walks them all; both give the same sums, bit for
bit.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

__all__ = ["StreamPlan", "stream_smem_bytes", "stream_segments", "segment_count",
           "card_sms", "STREAM_STAGES", "MAX_ROWS", "DECODE_ROWS", "MAX_SEGMENTS",
           "MAX_SMEM"]

# the kernel's constants (kStages, kMaxRows, kMaxSeg, kMaxSmem in the source)
STREAM_STAGES = 4
MAX_ROWS = 64          # rows of x per block above decode width
DECODE_ROWS = 8        # rows of x per block at decode width (T <= 8)
MAX_SEGMENTS = 8       # segments per column block: blocks per cluster under split
MAX_SMEM = 232448      # dynamic shared memory a block may use (227 KB)


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def stream_smem_bytes(bnb: int, ks: int, xrows: int, x_size: int, w_size: int, reduce: bool,
                      ncols: int) -> int:
    """Dynamic shared memory of one block (``smem_layout`` in the source):
    the ring of W and x stages, the partial tile under a cluster's sum, and
    the column block's live-tile rows."""
    slot = _round16(ks * (bnb + 8) * w_size) + _round16(xrows * (ks + 16 // x_size) * x_size)
    return STREAM_STAGES * slot + (4 * xrows * (bnb + 4) if reduce else 0) + 4 * ncols


def stream_segments(n: int, nseg: int) -> list[range]:
    """The stages of a column block of ``n`` stages that each segment sums,
    in order: segment s takes [n s / nseg, n (s+1) / nseg)."""
    return [range(n * s // nseg, n * (s + 1) // nseg) for s in range(nseg)]


def segment_count(n_stages: int) -> int:
    """Segments per column block: the largest power of two up to
    ``MAX_SEGMENTS`` and up to the column block's stages."""
    nseg = 1
    while nseg * 2 <= min(MAX_SEGMENTS, n_stages):
        nseg *= 2
    return nseg


@functools.cache
def card_sms(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclass(frozen=True)
class StreamPlan:
    """One product's launch plan: ``bnb`` columns per block, stages of ``ks``
    reduction rows, ``nseg`` segments per column block, ``units`` blocks of
    columns per call (a column block may take several); the operand and
    table itemsizes, the live-tile rows a block stages (block-CSC: MAXB) and
    the card's SM count."""
    bnb: int
    ks: int
    nseg: int
    units: int
    x_size: int
    w_size: int
    ncols: int
    sms: int

    def smem(self, xrows: int, split: bool) -> int:
        return stream_smem_bytes(self.bnb, self.ks, xrows, self.x_size, self.w_size,
                                 split and self.nseg > 1, self.ncols)

    def check(self, what: str) -> "StreamPlan":
        """Raise where the largest cut would not fit a block's shared memory."""
        need = self.smem(MAX_ROWS, True)
        if need > MAX_SMEM:
            raise ValueError(f"{what}: {need} bytes of shared memory per block, more than "
                             f"{MAX_SMEM}")
        return self

    def cut(self, rows: int, slots: int = 1) -> tuple[int, int]:
        """(xrows, split) for a call of ``slots`` x ``rows`` rows of x: 8 rows
        per block at decode width, else 64; split while the walk's blocks
        (one per column part and row tile) would not fill every SM once,
        else walk (``tools/stream_cuts.py`` times every cut: at the main
        path's shapes this rule picks the fastest or near it). Moves no sum."""
        xrows = DECODE_ROWS if rows <= DECODE_ROWS else MAX_ROWS
        tiles = slots * -(-rows // xrows)
        return xrows, int(tiles * self.units < self.sms)
