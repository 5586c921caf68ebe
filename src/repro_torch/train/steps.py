"""Step functions: the stage-1 train step on the coupled loss and the stage-2
ADMM step (port of the training part of ``repro/train/steps.py``).

Where the JAX package jits a pure function of the state, these run eagerly:
the train step differentiates the coupled loss with ``torch.autograd`` with
respect to detached copies of the parameters, then applies Adam under
``no_grad`` and returns a new state; the state it was given is left as it
was.

Under a mesh (``with mesh:``, ``parallel/sharding.py``) the train step does
what the JAX package's step does under ``with mesh:`` on a data-only mesh:
each data rank takes its rows of the global batch by ``batch_shardings``'
rule (every rank the whole batch where the data size does not divide it),
and where the rows are split the gradients and the metrics are averaged
over the data column, gathered and added in data order, so every rank holds
the same bits and Adam and the ADMM sweep run alike on every rank. A batch
that holds this rank's rows already (``LocalRows``, from
``DevicePrefetcher(shardings=...)``) is taken as it is. Training over the
model axis is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core.admm import SalaadConfig, admm_update, penalty
from ..core.selection import BlockInfo
from ..models import model
from ..optim.adam import AdamConfig, adam_update
from ..optim.schedule import warmup_cosine
from ..parallel.sharding import BatchShard, LocalRows, current_mesh
from ..tree import leaf_by_path, replace_by_path, tree_leaves_with_path
from .state import TrainState

__all__ = ["make_train_step", "make_admm_step", "check_train_mesh"]


def check_train_mesh(mesh) -> None:
    """Training runs on the data axis only."""
    if mesh is not None and mesh.model_size > 1:
        raise ValueError(f"not ported yet: training over the model axis (mesh "
                         f"{mesh.shape}); train data-parallel (model=1)")


def _data_mean(mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over the data column of each tensor (in f32, cast back),
    in one collective per dtype: gathered and added in data order, so every
    rank holds the same bits."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1).float() for i in idx])
        total = mesh.all_reduce_data(flat) / mesh.data_size
        for i, part in zip(idx, torch.split(total, [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape).to(tensors[i].dtype)
    return out


def _batch_to_device(batch: dict, device) -> dict:
    """numpy or tensor batch leaves -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v
                               ).to(device) for k, v in batch.items()}


def make_train_step(arch_cfg, blocks: list[BlockInfo], adam_cfg: AdamConfig = AdamConfig(),
                    schedule: Callable = warmup_cosine, accum_steps: int = 1,
                    aux_weight: float = 0.01):
    """Stage-1 guided learning: ``l_c = task + penalty``, one Adam update.

    ``accum_steps > 1`` splits the batch into that many microbatches along
    its first axis and averages their gradients (a loop where the JAX
    package scans); the returned metrics then carry the loss only.
    """

    def coupled_loss(params, slr, batch, rows):
        task, metrics = model.loss_fn(params, batch, arch_cfg, aux_weight=aux_weight,
                                      rows=rows)
        pen = penalty(params, slr, blocks) if blocks else torch.zeros((), device=task.device)
        return task + pen, {**metrics, "penalty": pen, "task_loss": task}

    def value_and_grad(params, slr, batch, rows):
        leaves = {path: leaf.detach().requires_grad_(True)
                  for path, leaf in tree_leaves_with_path(params)}
        live = replace_by_path(params, lambda path, _: leaves[path])
        with torch.enable_grad():
            loss, metrics = coupled_loss(live, slr, batch, rows)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        by_path = dict(zip(leaves, grads))
        grad_tree = replace_by_path(params, lambda path, _: by_path[path])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad_tree

    def local_step(state: TrainState, batch: dict, rows=None):
        device = next(iter(tree_leaves_with_path(state.params)))[1].device
        batch = _batch_to_device(batch, device)
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(state.params, state.slr, batch, rows)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} does not split into {accum_steps} microbatches")
            size = n // accum_steps
            grads, loss = None, torch.zeros((), device=device)
            for i in range(accum_steps):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_i, _, g_i = value_and_grad(state.params, state.slr, mb, rows)
                if grads is None:
                    grads = replace_by_path(g_i, lambda _, g: g.float())
                else:
                    grads = replace_by_path(grads, lambda path, g: g + leaf_by_path(g_i, path))
                loss = loss + l_i
            grads = replace_by_path(grads, lambda _, g: g / accum_steps)
            loss = loss / accum_steps
            metrics = {}
        return loss, metrics, grads

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        mesh = current_mesh()
        check_train_mesh(mesh)
        if mesh is None or mesh.data_size == 1:
            loss, metrics, grads = local_step(state, batch)
        else:
            n = batch.n if isinstance(batch, LocalRows) \
                else next(iter(batch.values())).shape[0]
            shard = BatchShard(mesh, n)
            if not isinstance(batch, LocalRows):
                batch = {k: shard.select(v) for k, v in batch.items()}
            loss, metrics, grads = local_step(state, batch, rows=shard)
            if shard.spread:
                paths = [p for p, _ in tree_leaves_with_path(grads)]
                names = sorted(metrics)
                means = _data_mean(mesh, [leaf_by_path(grads, p) for p in paths]
                                  + [torch.stack([loss] + [metrics[k].float() for k in names])])
                by_path = dict(zip(paths, means))
                grads = replace_by_path(grads, lambda path, _: by_path[path])
                loss, *vals = means[-1].unbind(0)
                metrics = dict(zip(names, vals))
        new_params, new_opt = adam_update(grads, state.opt, state.params, adam_cfg,
                                          schedule(state.step))
        new_state = TrainState(params=new_params, opt=new_opt, slr=state.slr,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics}

    return train_step


def make_admm_step(salaad_cfg: SalaadConfig, blocks: list[BlockInfo]):
    """Stage 2: the prox sweep and I-controller over every block, keyed by
    the state's step counter."""

    def admm_step(state: TrainState) -> tuple[TrainState, dict[str, Any]]:
        new_slr, stats = admm_update(state.params, state.slr, blocks, salaad_cfg, state.step)
        return state._replace(slr=new_slr), stats

    return admm_step
