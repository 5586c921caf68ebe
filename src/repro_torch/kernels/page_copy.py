"""Batched whole-page copy over a paged KV pool (port of
``repro/kernels/page_copy.py::page_copy_pallas``).

The device half of copy-on-write prefix sharing: ``pool[:, dst[i]] =
pool[:, src[i]]`` for every pair, every other page untouched. The copy works
IN PLACE on ``pool`` - the Pallas call aliases its pool operand to its output,
and the engine owns the one pool - and returns it. A page is copied byte for
byte, so one kernel serves float, int8 and (..., 1) scale pools.

Precondition (the engine's): every ``dst`` is a fresh page that is no pair's
``src``, so the pairs may run in any order. Identity pairs such as the (0, 0)
pads that round a batch up to a power of two are skipped.

``page_copy`` runs the plain version for CPU tensors and the CUDA kernel
``csrc/page_copy.cu`` for CUDA tensors.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import check_cuda, check_int32, launch

__all__ = ["page_copy"]


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
    launch("page_copy_launch", dev, pool.data_ptr(), src.data_ptr(), dst.data_ptr(), n,
           num_l, n_pages, page_bytes)
    page_copy.launches += 1
    return pool


page_copy.launches = 0
