"""Batched whole-page copy over a paged KV pool (port of
``repro/kernels/page_copy.py::page_copy_pallas``).

The device half of copy-on-write prefix sharing: ``pool[:, dst[i]] =
pool[:, src[i]]`` for every pair, every other page untouched. The copy works
IN PLACE on ``pool`` - the Pallas call aliases its pool operand to its output,
and the engine owns the one pool - and returns it. A page is copied byte for
byte, so one kernel serves float, int8 and (..., 1) scale pools.

Precondition (the engine's): every ``dst`` is a fresh page that is no pair's
``src``, so the pairs may run in any order. Identity pairs such as the (0, 0)
pads that round a batch up to a power of two are skipped, and so are pairs
naming a page outside the pool.

``page_copy`` runs the plain version for CPU tensors and the CUDA kernel
``csrc/page_copy.cu`` for CUDA tensors, cut by ``page_copy_plan``.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable
from dataclasses import dataclass

import torch

from . import ref
from ._build import check_cuda, check_int32, launch, library
from .stream import card_sms

__all__ = ["page_copy", "page_copy_plan", "CopyPlan", "CHUNKS"]

CHUNKS = (32768, 16384, 8192, 4096)   # unit sizes, largest first


@dataclass(frozen=True)
class CopyPlan:
    """A call's units: each of the (pair, layer) pages of ``page_bytes``
    cut into ``chunks`` units of ``chunk`` bytes (the last one ragged),
    ``units`` in all, walked by ``grid`` blocks at a stride of the grid."""
    page_bytes: int
    layers: int
    chunk: int
    chunks: int
    units: int
    grid: int

    def unit(self, u: int) -> tuple[int, int, int, int]:
        """(pair, layer, first byte, bytes) of unit ``u``, as the kernel cuts it."""
        c, pl = u % self.chunks, u // self.chunks
        first = c * self.chunk
        return pl // self.layers, pl % self.layers, first, min(self.chunk,
                                                               self.page_bytes - first)


def page_copy_plan(n_pairs: int, n_layers: int, page_bytes: int, sms: int,
                   resident: Callable[[int], int]) -> CopyPlan:
    """Units of the largest chunk in ``CHUNKS`` whose units cover every SM
    (the smallest where none does); the grid is the card's resident blocks
    (``sms`` x ``resident(chunk)``, blocks per SM) or the units, whichever
    is fewer."""
    for chunk in CHUNKS:
        if n_pairs * n_layers * -(-page_bytes // chunk) >= sms:
            break
    per_page = -(-page_bytes // chunk)
    units = n_pairs * n_layers * per_page
    grid = max(1, min(units, sms * resident(chunk)))
    return CopyPlan(page_bytes, n_layers, chunk, per_page, units, grid)


@functools.cache
def card_resident(device: int) -> Callable[[int], int]:
    """``page_copy_plan``'s ``resident`` on CUDA device ``device``: blocks
    per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""

    @functools.cache
    def resident(chunk: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = library().page_copy_resident(chunk, ctypes.byref(out))
        if err:
            raise RuntimeError(f"page_copy_resident failed: cudaError {err} on cuda:{device}")
        return max(1, out.value)

    return resident


def page_copy(pool: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """pool (L, num_pages, ...), src / dst (n,) int32 page ids -> pool, with
    page dst[i] of every layer overwritten by page src[i], in place."""
    if pool.device.type == "cpu":
        return ref.page_copy_ref(pool, src, dst)
    name = "page_copy"
    dev = check_cuda(name, pool=pool, src=src, dst=dst)
    check_int32(name, src=src, dst=dst)
    if pool.dim() < 2:
        raise ValueError(f"{name}: pool must be (L, num_pages, ...), got {tuple(pool.shape)}")
    if src.dim() != 1 or tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"{name}: src {tuple(src.shape)} and dst {tuple(dst.shape)} must "
                         "be two (n,) vectors")
    n = src.shape[0]
    if n == 0 or pool.numel() == 0:
        return pool
    num_l, n_pages = pool.shape[:2]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    plan = page_copy_plan(n, num_l, page_bytes, card_sms(dev.index), card_resident(dev.index))
    launch("page_copy_launch", dev, pool.data_ptr(), src.data_ptr(), dst.data_ptr(), n,
           num_l, n_pages, page_bytes, plan.chunk, plan.grid)
    page_copy.launches += 1
    return pool


page_copy.launches = 0
