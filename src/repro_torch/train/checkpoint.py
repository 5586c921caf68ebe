"""Checkpoints in the JAX package's on-disk format (port of
``repro/train/checkpoint.py``), so a run of either package restores the
other's.

Format: ``<dir>/step_{step:010d}/arrays.npz`` holding every leaf of the
TrainState under its '/'-joined path (``params/layers/q``,
``opt/mu/layers/q``, ``opt/count``, ``slr/layers/q/s_coo/values``,
``slr/embed/embedding/alpha``, ``step``, ...), beside a ``meta.json``;
``<dir>/manifest.json`` names the latest step. Static metadata (a block's
``rho``, a COO matrix's ``shape``) is not stored: the target state supplies
it. bfloat16 leaves are stored as float32. Writes go to a temporary
directory that ``os.replace`` moves into place, so a crashed writer never
corrupts the latest checkpoint; the oldest checkpoints beyond ``keep`` are
deleted.

``restore`` rebuilds a state of the target's structure with each leaf in the
target leaf's dtype and on its device. Saving copies every tensor to host
memory first: no stored array aliases a live parameter.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "all_steps", "flatten"]

MANIFEST = "manifest.json"
# dataclass fields that are static metadata, not leaves (BlockSLR.rho,
# CooMatrix.shape), as the JAX package registers them
STATIC_FIELDS = frozenset({"rho", "shape"})


def _children(node: Any):
    """(key, child) pairs of one node of a TrainState, in the JAX
    package's flattening: named-tuple fields, sorted dict keys, dataclass
    data fields."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)
                if f.name not in STATIC_FIELDS]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, np.generic, int)) \
        and not isinstance(node, bool)


def _walk(node: Any, prefix: str = ""):
    """(path, leaf) for every array or integer leaf."""
    kids = _children(node)
    if kids is None:
        if _is_leaf(node):
            yield prefix, node
        return
    for key, child in kids:
        yield from _walk(child, f"{prefix}/{key}" if prefix else key)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:      # npz holds no bfloat16: store f32
            t = t.float()
        return t.numpy().copy()
    if isinstance(leaf, int):              # the host step and optimizer count
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def flatten(state: Any) -> dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host array under its checkpoint key."""
    return {path: _to_numpy(leaf) for path, leaf in _walk(state)}


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3, extra: dict | None = None) -> str:
    """Atomic checkpoint write; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten(state)
    tmp = os.path.join(ckpt_dir, f".tmp.{step}.{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": int(step), "time": time.time(), **(extra or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)             # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    _update_manifest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def _update_manifest(ckpt_dir: str, step: int):
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir)
    with os.fdopen(fd, "w") as f:
        json.dump({"latest_step": int(step)}, f)
    os.replace(tmp, os.path.join(ckpt_dir, MANIFEST))


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and os.path.isdir(path) \
                and os.path.exists(os.path.join(path, "arrays.npz")):
            out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    man = os.path.join(ckpt_dir, MANIFEST)
    if os.path.exists(man):
        with open(man) as f:
            step = json.load(f).get("latest_step")
        if step is not None and step in all_steps(ckpt_dir):
            return step
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _rebuild(node: Any, arrays, prefix: str = "") -> Any:
    kids = _children(node)
    if kids is None:
        if not _is_leaf(node):
            return node
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = arrays[prefix]
        if isinstance(node, int):
            return int(arr)
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=node.device, dtype=node.dtype)
        return arr.astype(node.dtype)
    values = {k: _rebuild(v, arrays, f"{prefix}/{k}" if prefix else k) for k, v in kids}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(**values)
    if isinstance(node, dict):
        return {k: values[str(k)] for k in node}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **values)
    return type(node)(values[str(i)] for i in range(len(node)))


def restore(ckpt_dir: str, target_state: Any, step: int | None = None) -> Any:
    """The checkpoint at ``step`` (default: the latest) in the structure,
    dtypes and devices of ``target_state``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")) as arrays:
        return _rebuild(target_state, arrays)
