"""Gradient compression for the data-parallel all-reduce (port of
``repro/parallel/compression.py``).

int8 quantized all-reduce with per-tensor scales over the data ranks of a
mesh: each rank quantizes its local gradient, the int8 payloads are summed
exactly in int32 (the ranks gather each other's payloads, one byte an
element on the wire, and add them in data order; integer sums do not depend
on the order), the scales are reduced with max, and the sum is dequantized
with that scale and divided by the number of ranks. The quantization error
of one rank's gradient is at most ``scale / 2`` an element; where the ranks'
scales differ, the max-scale dequantization also scales rank r's payload by
``scale_max / scale_r``, as in the JAX package.

As in the JAX package this is a function, not a trainer knob: the trainer's
data-parallel step averages exact gradients (``train/steps.py``).
``make_compressed_grad_fn`` wraps a loss into a grad function with the
compressed reduction; with ``residuals`` the error-feedback variant carries
each rank's quantization error into its next call (Seide et al. 2014).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..tree import leaf_by_path, replace_by_path, tree_leaves_with_path
from .sharding import BatchShard

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_tree",
           "make_compressed_grad_fn", "wire_bytes"]


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale ``max|g| / 127 + 1e-12``); rounding half to
    even, as ``jnp.round``."""
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def wire_bytes(grads: Any) -> int:
    """The bytes one rank contributes per call: an int8 payload element a
    gradient element and one f32 scale a leaf."""
    return sum(g.numel() + 4 for _, g in tree_leaves_with_path(grads))


def _data_stack(mesh, x: torch.Tensor) -> torch.Tensor:
    """x of every data rank, stacked in data order (x itself at one rank)."""
    if mesh is None or mesh.data_size == 1:
        return x[None]
    return mesh.all_gather_data(x[None], dim=0)


def compressed_psum_tree(grads: Any, mesh, residuals: Any = None):
    """int8-quantized mean of ``grads`` (a dict tree of tensors) over the
    data ranks of ``mesh`` (None: one rank). Every rank calls it with its
    own gradients; all get the same result. With ``residuals`` (same tree)
    each rank adds its previous quantization error before quantizing and
    carries the new one forward: returns ``(mean, new_residuals)``."""
    paths = [p for p, _ in tree_leaves_with_path(grads)]
    g32 = [leaf_by_path(grads, p).float() for p in paths]
    if residuals is not None:
        g32 = [g + leaf_by_path(residuals, p) for g, p in zip(g32, paths)]
    quant = [quantize_int8(g) for g in g32]
    payload = _data_stack(mesh, torch.cat([q.reshape(-1) for q, _ in quant]))
    scales = _data_stack(mesh, torch.stack([s for _, s in quant]))
    n = torch.tensor(float(payload.shape[0]), device=payload.device)
    acc = payload.to(torch.int32).sum(0)                  # exact integer sum
    scale_max = scales.max(0).values
    out, new_r, start = {}, {}, 0
    for i, p in enumerate(paths):
        g = leaf_by_path(grads, p)
        part = acc[start:start + g.numel()].reshape(g.shape)
        start += g.numel()
        out[p] = (part.to(torch.float32) * scale_max[i] / n).to(g.dtype)
        if residuals is not None:
            q, scale = quant[i]
            new_r[p] = g32[i] - dequantize_int8(q, scale)
    mean = replace_by_path(grads, lambda path, _: out[path])
    if residuals is None:
        return mean
    return mean, replace_by_path(grads, lambda path, _: new_r[path])


def make_compressed_grad_fn(loss_fn: Callable, mesh, data_axis: str = "data"):
    """``grads(params, batch)`` with an int8 data-parallel reduction:
    ``loss_fn(params, local_batch) -> scalar`` is evaluated on this rank's
    rows of the global batch (its data rank's ``1/N``), differentiated with
    ``torch.autograd`` and reduced with :func:`compressed_psum_tree`."""
    if data_axis != "data":
        raise ValueError(f"data_axis={data_axis!r}: the port's meshes carry the batch "
                         "on 'data'")

    def grad_fn(params, batch):
        n = next(iter(batch.values())).shape[0]
        if mesh is not None and mesh.data_size > 1 and n % mesh.data_size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{mesh.data_size} data ranks")
        if mesh is not None:
            shard = BatchShard(mesh, n)
            batch = {k: shard.select(v) for k, v in batch.items()}
        leaves = {path: leaf.detach().requires_grad_(True)
                  for path, leaf in tree_leaves_with_path(params)}
        live = replace_by_path(params, lambda path, _: leaves[path])
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(live, batch), list(leaves.values()))
        by_path = dict(zip(leaves, grads))
        return compressed_psum_tree(replace_by_path(params, lambda path, _: by_path[path]),
                                    mesh)

    return grad_fn
