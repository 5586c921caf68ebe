"""The SALAAD trainer: Algorithm 1 end to end, with checkpoints and fault
tolerance (port of ``repro/train/trainer.py``).

Loop (paper Algorithm 1):
    for each outer phase:
        K x  train_step   (stage 1: coupled loss, Adam)
        1 x  admm_step    (stage 2: prox sweep + I-controller)

Deterministic restart: the data batches and the rSVD sketches are pure
functions of the step counter, so a run restored at step s replays the steps
after s exactly.

Every family of ``configs.ARCH_IDS`` trains: the MoE's load-balance loss
enters the coupled loss with weight 0.01, and the VLM and the
encoder-decoder train on tokens-only batches (``SyntheticC4``; the encoder
then reads zero frames). Everything runs on the card unless the trainer is
given ``device='cpu'``.

``mesh`` (a ``parallel.sharding.ServingMesh`` over the ranks of a process
group, as the JAX trainer takes its ``Mesh``) is entered around every step:
with ``data = N`` the train step splits the global batch over the data
ranks and averages the gradients in data order, so each rank holds the same
parameters, Adam moments and SLR state bit for bit (``train/steps.py``).
Only data rank 0 writes checkpoints, then every rank meets at a barrier;
restore loads whole tensors on every rank, so a state saved at one data
size resumes at any other. Training over the model axis is not ported yet.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core.admm import SalaadConfig, surrogate_params
from ..core.hpa import hpa_compress
from ..device import resolve_device
from ..models import model as model_lib
from ..optim.adam import AdamConfig
from ..optim.schedule import warmup_cosine
from . import checkpoint
from .fault import StragglerDetector, Watchdog
from .state import TrainState, init_train_state
from .steps import check_train_mesh, make_admm_step, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 20
    salaad: SalaadConfig | None = field(default_factory=SalaadConfig)
    adam: AdamConfig = field(default_factory=AdamConfig)
    schedule: Callable = warmup_cosine
    accum_steps: int = 1
    step_timeout_s: float = 0.0   # 0 = watchdog off


class Trainer:
    def __init__(self, arch_cfg, tcfg: TrainerConfig, mesh=None, device=None):
        check_train_mesh(mesh)
        if mesh is not None and not mesh.member:
            raise ValueError(f"rank {mesh.rank} lies outside the {mesh.num_devices}-rank mesh")
        self.arch_cfg = arch_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.straggler = StragglerDetector()
        self.metrics_log: list[dict] = []
        self.events: list[str] = []
        self.blocks = []

    # ------------------------------------------------------------ setup ---

    def init(self, seed: int = 0, params: Any = None) -> TrainState:
        """A fresh state: random parameters from ``seed`` (or the given
        ``params``), zero Adam moments and a zero SLR state."""
        if params is None:
            params = model_lib.init_params(self.arch_cfg, seed, self.device)
        state, self.blocks = init_train_state(params, self.tcfg.salaad)
        self._train_step = make_train_step(self.arch_cfg, self.blocks, self.tcfg.adam,
                                           self.tcfg.schedule, self.tcfg.accum_steps)
        self._admm_step = (make_admm_step(self.tcfg.salaad, self.blocks)
                           if self.tcfg.salaad is not None and self.blocks else None)
        return state

    def maybe_restore(self, state: TrainState) -> TrainState:
        if self.tcfg.ckpt_dir:
            step = checkpoint.latest_step(self.tcfg.ckpt_dir)
            if step is not None:
                self.events.append(f"restored step {step}")
                return checkpoint.restore(self.tcfg.ckpt_dir, state)
        return state

    # ------------------------------------------------------------- loop ---

    def _scope(self):
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    def _save(self, step: int, state: TrainState) -> None:
        """Data rank 0 writes (every rank holds the same state), then the
        ranks meet, so none reads a checkpoint before it is complete."""
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save(self.tcfg.ckpt_dir, step, state, keep=self.tcfg.keep_ckpts)
        if self.mesh is not None:
            self.mesh.barrier()

    def fit(self, state: TrainState, data, steps: int | None = None) -> TrainState:
        steps = steps or self.tcfg.total_steps
        k_every = self.tcfg.salaad.update_every if self.tcfg.salaad else 0
        wd = Watchdog(self.tcfg.step_timeout_s) if self.tcfg.step_timeout_s else None

        for step in range(int(state.step), steps):
            batch = data.batch(step) if hasattr(data, "batch") else next(data)
            t0 = time.time()
            if wd:
                wd.arm()
            with self._scope():
                state, metrics = self._train_step(state, batch)
            loss = float(metrics["loss"])          # waits for the step to finish
            if wd:
                wd.disarm()
                if wd.expired:
                    self.events.append(f"watchdog expired at step {step}")
            dt = time.time() - t0
            if self.straggler.update(dt):
                self.events.append(f"straggler: step {step} took {dt:.2f}s")

            if self._admm_step and k_every and (step + 1) % k_every == 0:
                with self._scope():
                    state, admm_stats = self._admm_step(state)
                self.metrics_log.append(
                    {"step": step, "admm_recon_err": float(admm_stats["_mean_recon_err"])})

            if step % self.tcfg.log_every == 0 or step == steps - 1:
                self.metrics_log.append({"step": step, "loss": loss, "sec": dt})

            if self.tcfg.ckpt_dir and self.tcfg.ckpt_every \
                    and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1, state)
        return state

    # ------------------------------------------------------- deployment ---

    def surrogate(self, state: TrainState):
        """Structured surrogate X_hat = L + S (the deployed model)."""
        return surrogate_params(state.params, state.slr, self.blocks)

    def compress(self, state: TrainState, remove_budget: int, kappa: float):
        return hpa_compress(state.slr, self.blocks, remove_budget, kappa)
