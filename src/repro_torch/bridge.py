"""Bridge from the JAX package's parameters and SLR state to the port's.

The JAX side hands everything over as numpy arrays (a test flattens its
pytrees with ``np.asarray``), so this module imports neither JAX nor the JAX
package. Objects are read by attribute (``p``, ``vt``, ``s_coo.values``,
...), so a ``BlockSLR`` whose leaves were mapped to numpy, or any object of
that shape, converts.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core import sparse
from .core.admm import BlockSLR, SLRState
from .device import resolve_device

__all__ = ["tensor_from_numpy", "params_from_numpy", "coo_from_numpy",
           "slr_state_from_numpy"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy array -> tensor on ``device``; bfloat16 arrays (ml_dtypes) go
    through float32, which holds them exactly."""
    a = np.asarray(a)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dict/list of numpy arrays (stacked layer axes kept) -> the same
    tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def coo_from_numpy(coo, device=None) -> sparse.CooMatrix:
    return sparse.CooMatrix(
        values=tensor_from_numpy(coo.values, device),
        idx=tensor_from_numpy(np.asarray(coo.idx, np.int32), device),
        shape=tuple(int(d) for d in coo.shape),
    )


def slr_state_from_numpy(state: dict, device=None) -> SLRState:
    """Block name -> BlockSLR-shaped object with numpy leaves, into the
    port's ``SLRState``."""
    out: SLRState = {}
    for name, blk in state.items():
        t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
        out[name] = BlockSLR(
            p=t(blk.p), vt=t(blk.vt), s_vals=t(blk.s_vals),
            s_coo=coo_from_numpy(blk.s_coo, device),
            y=t(blk.y), z=t(blk.z),
            alpha=t(np.asarray(blk.alpha, np.float32)),
            beta=t(np.asarray(blk.beta, np.float32)),
            rho=float(blk.rho),
        )
    return out
