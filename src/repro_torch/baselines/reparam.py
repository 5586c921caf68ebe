"""Weight-space reparameterizations for the paper's Table 1 baselines (port
of ``repro/baselines/reparam.py``).

Each baseline stores transformed parameters and materializes the model's
weight tree for the forward pass; autograd flows through ``materialize``:

  * FullRank        - identity (the paper's vanilla baseline)
  * LoRAReparam     - W = W0.detach() + (alpha/r) B A; the selected W0
                      receive no gradient (LoRA as a pretraining baseline)
  * SLTrainReparam  - W = B A + scatter(s_values at a fixed random support)
                      (fixed rank and a sparse support fixed before
                      training: the layer-agnostic schedule SALAAD's
                      I-controller replaces)
  * GaLoreAdam      - full-rank W with the Adam moments of the selected
                      leaves in a rank-r projection of the gradient; the
                      projector is refreshed from the gradient's randomized
                      SVD every ``refresh_every`` steps.

Selection is ``core/selection.py``'s, so each baseline touches the blocks
SALAAD would, on any architecture. Every random draw comes from a
``torch.Generator`` on the CPU (the card and the CPU draw the same values),
and each ``init`` also takes values drawn elsewhere (``drawn``: LoRA's
``a``, SLTrain's ``b``, ``a`` and ``support``, GaLore's ``q``), so a test can
start from the JAX package's draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.admm import block_sketches
from ..core.rsvd import randomized_svd
from ..core.selection import SelectionConfig, path_str, select_blocks
from ..optim.adam import AdamConfig, adam_update, init_adam
from ..tree import leaf_by_path, replace_by_path, tree_leaves_with_path

__all__ = ["FullRank", "LoRAReparam", "SLTrainReparam", "GaLoreAdam", "train_baseline"]


def _set_leaf(params: dict, path: tuple, value) -> dict:
    """A copy of the dict tree with the leaf at ``path`` replaced."""
    if not path:
        return value
    out = dict(params)
    out[path[0]] = _set_leaf(params[path[0]], path[1:], value)
    return out


def _numel(tree) -> int:
    return sum(int(leaf.numel()) for _, leaf in tree_leaves_with_path(tree))


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _given(drawn: dict | None, name: str, field: str, shape: tuple, device,
           dtype=torch.float32) -> torch.Tensor | None:
    """``drawn[name][field]`` broadcast to ``shape``, or None when not given."""
    if drawn is None or name not in drawn:
        return None
    v = torch.from_numpy(np.array(drawn[name][field])).to(dtype)
    return v.broadcast_to(shape).to(device)


def _selection(sel: SelectionConfig | None) -> SelectionConfig:
    return sel or SelectionConfig(min_dim=16)


class FullRank:
    name = "full-rank"

    def init(self, params, generator: torch.Generator | None = None, drawn=None) -> dict:
        return {"base": params}

    def materialize(self, t: dict):
        return t["base"]

    def param_count(self, t: dict) -> int:
        return _numel(t["base"])


@dataclass
class LoRAReparam:
    rank: int = 8
    alpha: float = 16.0
    selection: SelectionConfig = None
    name = "lora"

    def init(self, params, generator: torch.Generator | None = None,
             drawn: dict | None = None) -> dict:
        gen = _generator(generator)
        blocks = select_blocks(params, _selection(self.selection))
        adapters = {}
        for info in blocks:
            dev = leaf_by_path(params, info.path).device
            r = min(self.rank, info.n, info.m)
            shape_a = (*info.stack_dims, r, info.m)
            a = _given(drawn, info.name, "a", shape_a, dev)
            if a is None:
                a = (torch.randn(shape_a, generator=gen) * 0.01).to(dev)
            adapters[info.name] = {
                "a": a, "b": torch.zeros((*info.stack_dims, info.n, r), device=dev)}
        return {"base": params, "adapters": adapters, "_blocks": blocks}

    def materialize(self, t: dict):
        params = t["base"]
        for info in t["_blocks"]:
            ad = t["adapters"][info.name]
            w0 = leaf_by_path(params, info.path).detach()
            r = ad["a"].shape[-2]
            w = w0 + (self.alpha / r) * (ad["b"] @ ad["a"]).to(w0.dtype)
            params = _set_leaf(params, info.path, w)
        return params

    def param_count(self, t: dict) -> int:
        # deployable parameters: the adapters merge into the base at deployment
        return _numel(t["base"])


@dataclass
class SLTrainReparam:
    """Fixed rank-r factors plus values on a fixed random support."""

    rank_ratio: float = 0.15
    density: float = 0.05
    selection: SelectionConfig = None
    name = "sltrain"

    def init(self, params, generator: torch.Generator | None = None,
             drawn: dict | None = None) -> dict:
        gen = _generator(generator)
        blocks = select_blocks(params, _selection(self.selection))
        reps, supports = {}, {}
        new_params = params
        for info in blocks:
            dev = leaf_by_path(params, info.path).device
            n, m, stack = info.n, info.m, info.stack_dims
            r = max(2, int(self.rank_ratio * min(n, m)))
            nnz = max(4, int(self.density * n * m))
            idx = _given(drawn, info.name, "support", (*stack, nnz), dev, torch.int32)
            if idx is None:
                idx = torch.randperm(n * m, generator=gen)[:nnz].broadcast_to((*stack, nnz))
            b = _given(drawn, info.name, "b", (*stack, n, r), dev)
            if b is None:
                b = torch.randn((*stack, n, r), generator=gen) / np.sqrt(r)
            a = _given(drawn, info.name, "a", (*stack, r, m), dev)
            if a is None:
                a = torch.randn((*stack, r, m), generator=gen) / np.sqrt(m)
            reps[info.name] = {"b": b.to(dev), "a": a.to(dev),
                               "s_values": torch.zeros((*stack, nnz), device=dev)}
            supports[info.name] = idx.to(dev, torch.int32)
            # the base leaf is replaced at materialize: zeros hold its place
            new_params = _set_leaf(new_params, info.path,
                                   torch.zeros(info.shape, dtype=torch.float32, device=dev))
        return {"base": new_params, "reps": reps, "_blocks": blocks, "_support": supports}

    def materialize(self, t: dict):
        params = t["base"]
        for info in t["_blocks"]:
            rep = t["reps"][info.name]
            n, m, nb = info.n, info.m, info.num_blocks
            low = rep["b"] @ rep["a"]
            vals = rep["s_values"].reshape(nb, -1)
            idx = t["_support"][info.name].detach().reshape(nb, -1).long()
            sparse_part = torch.zeros((nb, n * m), dtype=vals.dtype, device=vals.device)
            sparse_part = sparse_part.scatter_add(1, idx, vals).reshape(low.shape)
            w = (low + sparse_part).to(leaf_by_path(params, info.path).dtype)
            params = _set_leaf(params, info.path, w)
        return params

    def param_count(self, t: dict) -> int:
        covered = {b.name for b in t["_blocks"]}
        total = 0
        for info in t["_blocks"]:
            rep = t["reps"][info.name]
            total += rep["b"].numel() + rep["a"].numel() + 2 * rep["s_values"].numel()
        for path, leaf in tree_leaves_with_path(t["base"]):
            if path_str(path) not in covered:
                total += leaf.numel()
        return int(total)


@dataclass
class GaLoreAdam:
    """Gradient low-rank projection around Adam."""

    rank: int = 16
    refresh_every: int = 50
    selection: SelectionConfig = None
    adam: AdamConfig = None
    name = "galore"

    def init_state(self, params, generator: torch.Generator | None = None,
                   drawn: dict | None = None) -> dict:
        gen = _generator(generator)
        self.blocks = select_blocks(params, _selection(self.selection))
        projectors, moments = {}, {}
        for info in self.blocks:
            dev = leaf_by_path(params, info.path).device
            r = min(self.rank, info.n, info.m)
            shape = (*info.stack_dims, info.n, r)
            q = _given(drawn, info.name, "q", shape, dev)
            if q is None:
                q = torch.linalg.qr(torch.randn((info.n, r), generator=gen))[0]
                q = q.broadcast_to(shape).to(dev)
            projectors[info.name] = q
            zeros = (*info.stack_dims, r, info.m)
            moments[info.name] = {"mu": torch.zeros(zeros, device=dev),
                                  "nu": torch.zeros(zeros, device=dev)}
        return {"proj": projectors, "mom": moments, "dense": init_adam(params), "count": 0}

    @torch.no_grad()
    def update(self, grads, state: dict, params, step: int,
               sketches: dict[str, torch.Tensor] | None = None):
        """One step; returns ``(new_params, new_state)``. At a refresh step
        the projector of leaf i is the top subspace of its gradient from the
        randomized SVD on the sketches ``block_sketches(step, i, ...)``, or on
        ``sketches[name]`` (num_blocks, m, r) when given."""
        cfg = self.adam or AdamConfig()
        count = state["count"] + 1
        f = np.float32                 # host scalars in f32, as JAX computes them
        b1c = float(f(1) - f(cfg.b1) ** f(count))
        b2c = float(f(1) - f(cfg.b2) ** f(count))
        new_params = params
        new_proj, new_mom = dict(state["proj"]), dict(state["mom"])
        for i, info in enumerate(self.blocks):
            g = leaf_by_path(grads, info.path).float()
            p = state["proj"][info.name]
            if step and step % self.refresh_every == 0:
                r, nb = p.shape[-1], info.num_blocks
                if sketches is not None and info.name in sketches:
                    omega = sketches[info.name].to(g.device, torch.float32)
                else:
                    omega = block_sketches(step, i, info, r, 1, g.device)[:, 0]
                u, _, _ = randomized_svd(g.reshape(nb, info.n, info.m), omega.reshape(nb, -1, r))
                p = u.reshape(p.shape)
                new_proj[info.name] = p
            # project, Adam in the rank-r space, project back
            gp = p.transpose(-1, -2) @ g
            mom = state["mom"][info.name]
            mu = cfg.b1 * mom["mu"] + (1 - cfg.b1) * gp
            nu = cfg.b2 * mom["nu"] + (1 - cfg.b2) * gp * gp
            upd = p @ ((mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps))
            w = leaf_by_path(params, info.path)
            new_params = _set_leaf(new_params, info.path,
                                   (w.float() - cfg.lr * upd).to(w.dtype))
            new_mom[info.name] = {"mu": mu, "nu": nu}
        # dense Adam for every other leaf (the selected ones get zero gradients)
        selected = {b.name for b in self.blocks}
        masked = replace_by_path(grads, lambda path, gl: torch.zeros_like(gl)
                                 if path_str(path) in selected else gl)
        dense_params, dense_state = adam_update(masked, state["dense"], new_params, cfg)
        return dense_params, {"proj": new_proj, "mom": new_mom, "dense": dense_state,
                              "count": count}


def _value_and_grad(loss_fn, tree, batch):
    """(loss, gradient tree) of ``loss_fn(tree, batch)`` with respect to every
    tensor leaf of ``tree``; a leaf the loss does not reach gets zeros."""
    leaves = {path: leaf.detach().requires_grad_(True)
              for path, leaf in tree_leaves_with_path(tree)}
    live = replace_by_path(tree, lambda path, _: leaves[path])
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    by_path = {path: torch.zeros_like(leaf) if g is None else g
               for (path, leaf), g in zip(leaves.items(), grads)}
    return loss.detach(), replace_by_path(tree, lambda path, _: by_path[path])


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def train_baseline(method, arch_cfg, data, steps: int, seed: int = 0,
                   adam_cfg: AdamConfig = AdamConfig(lr=1e-3, grad_clip=1.0),
                   eval_batches: int = 4, params: Any = None, drawn: dict | None = None,
                   device=None):
    """Train a baseline from random parameters (``seed``, or the given
    ``params``); returns ``(final eval loss, param count, losses)``. The
    eval loss averages ``eval_batches`` batches from step 50000 on. The
    method's draws come from a generator seeded with ``seed`` unless
    ``drawn`` hands them over."""
    from ..models import model as model_lib

    if params is None:
        params = model_lib.init_params(arch_cfg, seed, device)
    dev = next(iter(tree_leaves_with_path(params)))[1].device
    gen = torch.Generator().manual_seed(seed)

    def evaluate(loss_fn, tree) -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_fn(tree, _to_device(data.batch(50_000 + i), dev)))
                                  for i in range(eval_batches)]))

    if isinstance(method, GaLoreAdam):
        state = method.init_state(params, gen, drawn)

        def loss_fn(p, batch):
            return model_lib.loss_fn(p, batch, arch_cfg)[0]

        losses = []
        for s in range(steps):
            loss, grads = _value_and_grad(loss_fn, params, _to_device(data.batch(s), dev))
            params, state = method.update(grads, state, params, s)
            losses.append(float(loss))
        return evaluate(loss_fn, params), _numel(params), losses

    t = method.init(params, gen, drawn)
    static = {k: t.pop(k) for k in ("_blocks", "_support") if k in t}

    def loss_fn(tp, batch):
        return model_lib.loss_fn(method.materialize({**tp, **static}), batch, arch_cfg)[0]

    opt = init_adam(t)
    losses = []
    for s in range(steps):
        loss, grads = _value_and_grad(loss_fn, t, _to_device(data.batch(s), dev))
        t, opt = adam_update(grads, opt, t, adam_cfg)
        losses.append(float(loss))
    eval_loss = evaluate(loss_fn, t)
    return eval_loss, method.param_count({**t, **static}), losses
