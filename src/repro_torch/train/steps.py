"""Step functions: the stage-1 train step on the coupled loss and the stage-2
ADMM step (port of the training part of ``repro/train/steps.py``).

Where the JAX package jits a pure function of the state, these run eagerly:
the train step differentiates the coupled loss with ``torch.autograd`` with
respect to detached copies of the parameters, then applies Adam under
``no_grad`` and returns a new state; the state it was given is left as it
was.
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
from ..tree import leaf_by_path, replace_by_path, tree_leaves_with_path
from .state import TrainState

__all__ = ["make_train_step", "make_admm_step"]


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

    def coupled_loss(params, slr, batch):
        task, metrics = model.loss_fn(params, batch, arch_cfg, aux_weight=aux_weight)
        pen = penalty(params, slr, blocks) if blocks else torch.zeros((), device=task.device)
        return task + pen, {**metrics, "penalty": pen, "task_loss": task}

    def value_and_grad(params, slr, batch):
        leaves = {path: leaf.detach().requires_grad_(True)
                  for path, leaf in tree_leaves_with_path(params)}
        live = replace_by_path(params, lambda path, _: leaves[path])
        with torch.enable_grad():
            loss, metrics = coupled_loss(live, slr, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        by_path = dict(zip(leaves, grads))
        grad_tree = replace_by_path(params, lambda path, _: by_path[path])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad_tree

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        device = next(iter(tree_leaves_with_path(state.params)))[1].device
        batch = _batch_to_device(batch, device)
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(state.params, state.slr, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} does not split into {accum_steps} microbatches")
            size = n // accum_steps
            grads, loss = None, torch.zeros((), device=device)
            for i in range(accum_steps):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_i, _, g_i = value_and_grad(state.params, state.slr, mb)
                if grads is None:
                    grads = replace_by_path(g_i, lambda _, g: g.float())
                else:
                    grads = replace_by_path(grads, lambda path, g: g + leaf_by_path(g_i, path))
                loss = loss + l_i
            grads = replace_by_path(grads, lambda _, g: g / accum_steps)
            loss = loss / accum_steps
            metrics = {}
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
