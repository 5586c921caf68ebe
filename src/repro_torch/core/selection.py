"""Block selection: find the SALAAD-managed weight blocks in a parameter
tree (port of ``repro/core/selection.py``).

A leaf is selected when its trailing two dims form a matrix ``(n, m)`` with
both dims ``>= min_dim``; leading dims are stacked block axes. Path-based
rules exclude norms, biases and (by default) the LM head, and mark the
embedding. Leaf names are the '/'-joined dict keys in sorted order, so they
equal the JAX package's (``layers/q``, ``embed/embedding``, ...).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..tree import tree_leaves_with_path

__all__ = ["SelectionConfig", "BlockInfo", "select_blocks", "path_str",
           "total_logical_blocks"]


@dataclass(frozen=True)
class SelectionConfig:
    min_dim: int = 8
    include_embedding: bool = True
    include_lm_head: bool = False
    extra_exclude: tuple[str, ...] = ()
    extra_include: tuple[str, ...] = ()
    embedding_patterns: tuple[str, ...] = ("embed",)
    lm_head_patterns: tuple[str, ...] = ("lm_head", "unembed", "output_head")
    default_exclude: tuple[str, ...] = ("norm", "scale", "bias", "conv", "frontend", "a_log", "dt_")


@dataclass(frozen=True)
class BlockInfo:
    """Static metadata for one selected leaf (possibly a stack of blocks)."""

    path: tuple[Any, ...]          # dict-key path into the parameter tree
    name: str                      # '/'-joined readable path
    shape: tuple[int, ...]
    stack_dims: tuple[int, ...]
    n: int
    m: int
    is_embedding: bool = False

    @property
    def num_blocks(self) -> int:
        return int(np.prod(self.stack_dims)) if self.stack_dims else 1


def path_str(path: tuple[Any, ...]) -> str:
    return "/".join(str(p) for p in path)


def _matches(name: str, patterns: tuple[str, ...]) -> bool:
    low = name.lower()
    return any(re.search(p, low) for p in patterns)


def select_blocks(params: Any, cfg: SelectionConfig = SelectionConfig()) -> list[BlockInfo]:
    """BlockInfo for every selected leaf, sorted by name."""
    out: list[BlockInfo] = []
    for path, leaf in tree_leaves_with_path(params):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) < 2:
            continue
        name = path_str(path)
        n, m = shape[-2], shape[-1]
        if min(n, m) < cfg.min_dim:
            continue
        forced = _matches(name, cfg.extra_include) if cfg.extra_include else False
        if not forced:
            if _matches(name, cfg.default_exclude) or (
                cfg.extra_exclude and _matches(name, cfg.extra_exclude)
            ):
                continue
            if _matches(name, cfg.lm_head_patterns) and not cfg.include_lm_head:
                continue
            is_emb = _matches(name, cfg.embedding_patterns)
            if is_emb and not cfg.include_embedding:
                continue
        else:
            is_emb = _matches(name, cfg.embedding_patterns)
        out.append(BlockInfo(path=path, name=name, shape=shape,
                             stack_dims=shape[:-2], n=n, m=m,
                             is_embedding=is_emb))
    out.sort(key=lambda b: b.name)
    return out


def total_logical_blocks(blocks: list[BlockInfo]) -> int:
    """N in the rho scaling law (Eq. 7): stacked slices count individually."""
    return sum(b.num_blocks for b in blocks)
