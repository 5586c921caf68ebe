"""SALAAD training of every family in the port against the JAX package, at
``.reduced()`` on the CPU.

* The hybrid (``zamba2_2p7b``), the MoE (``qwen3_moe_30b_a3b``) and the SSM LM
  (``mamba2_370m``): JAX's ``make_train_step`` and ``make_admm_step`` (exact
  SVD) against the port's, from one state bridged across, for two train
  steps on the same batches and one ADMM step. Losses within 1e-4
  relative per step; parameters, Adam moments and the SLR state (L as
  ``p @ vt``, S dense, Y, Z, alpha, beta) within 1e-4 of each leaf's largest
  value, S and Z apart from one pair of positions per block that may swap
  at the COO cap's boundary. The MoE's load-balance term is checked on its
  own.
* Every family: the blocks ``init_train_state`` selects (names, shapes,
  stack dims, order) equal JAX's ``select_blocks``, and the SLR state's
  leaves have JAX's shapes.
* The VLM and the encoder-decoder: ``Trainer.fit`` of 4 steps with K = 2 on
  tokens-only batches gives finite losses and ADMM statistics; the train
  launcher runs every id of ``ARCH_IDS``.
* The hybrid: a checkpoint round trip through the JAX package's format, remat
  on and off giving equal numbers, and the chunked scan keeping none of its
  per-chunk tensors for the backward outside the remat boundary.

The JAX side runs under ``jax.jit`` with XLA's CPU optimizations off
(``FAST_COMPILE``): compiling is most of its time. f32, TF32 off; the
learning-rate scale is held at 1 so that both train steps move the weights.
Adam's eps is 1e-3 on both sides: with the default 1e-8 Adam's first step
moves every element by +-lr whatever the size of its gradient, so an element
whose gradient is at rounding level (a zero-initialized norm scale, an
``a_log`` entry) goes either way on two correct implementations and the next
step's gradients follow it; with eps above those gradients the update is
continuous in the gradient, and the comparison holds the gradients themselves.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import sparse as jax_sparse
from repro.core.admm import SalaadConfig as JaxSalaadConfig
from repro.core.admm import init_slr_state as jax_init_slr_state
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.core.selection import select_blocks as jax_select_blocks
from repro.models import model as jax_model
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train.state import abstract_train_state as jax_abstract_train_state
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.steps import make_admm_step as jax_make_admm_step
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import sparse
from repro_torch.core.admm import SalaadConfig
from repro_torch.core.selection import SelectionConfig
from repro_torch.data.synthetic import DataConfig, SyntheticC4
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as model_lib
from repro_torch.optim.adam import AdamConfig
from repro_torch.train import checkpoint
from repro_torch.train.state import init_train_state
from repro_torch.train.steps import make_admm_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaf_by_path, tree_leaves_with_path

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
FAMILIES = {"dense": "salaad_llama_60m", "moe": "qwen3_moe_30b_a3b", "vlm": "internvl2_76b",
            "ssm": "mamba2_370m", "hybrid": "zamba2_2p7b", "encdec": "whisper_small"}
STEPPED = ["zamba2_2p7b", "qwen3_moe_30b_a3b", "mamba2_370m"]
LR, EPS, RHO, SEQ, BATCH = 1e-3, 1e-3, 5.0, 32, 2


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got: torch.Tensor, want, what: str):
    """Within 1e-4 of the leaf's largest value."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=1e-4 * scale,
                               err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def no_tf32_one_thread():
    """TF32 off; one intra-op thread (tiny tensors: under a loaded suite,
    more threads only contend with the other workers)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.set_num_threads(prev[1])


@pytest.fixture(scope="module", params=STEPPED)
def stepped(request):
    """Two train steps and one exact-SVD ADMM step on both sides from one
    JAX initial state, with the per-step metrics."""
    arch = request.param
    jcfg = jax_get_arch(arch).reduced()
    jscfg = JaxSalaadConfig(exact_svd=True, rho_constant=RHO, update_every=2,
                            selection=JaxSelectionConfig(min_dim=16))
    jstate, jblocks = jax_init_train_state(jax_model.init_params(jcfg, jax.random.PRNGKey(0)),
                                           jscfg)
    start = bridge.train_state_from_numpy(to_numpy(jstate), "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, jblocks, JaxAdamConfig(lr=LR, eps=EPS),
                                        lambda s: jnp.ones((), jnp.float32)),
                    compiler_options=FAST_COMPILE)
    jadmm = jax.jit(jax_make_admm_step(jscfg, jblocks), compiler_options=FAST_COMPILE)
    cfg = get_arch(arch).reduced()
    scfg = SalaadConfig(exact_svd=True, rho_constant=RHO, update_every=2,
                        selection=SelectionConfig(min_dim=16))
    _, blocks = init_train_state(start.params, scfg)
    step = make_train_step(cfg, blocks, AdamConfig(lr=LR, eps=EPS), lambda s: 1.0)
    admm = make_admm_step(scfg, blocks)
    data = SyntheticC4(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=2))
    state, jmetrics, metrics = start, [], []
    for s in range(2):
        batch = data.batch(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        jmetrics.append(jax.tree.map(float, jm))
        metrics.append({k: float(v) for k, v in m.items()})
    jstate, jstats = jadmm(jstate)
    state, stats = admm(state)
    return SimpleNamespace(arch=arch, cfg=cfg, jcfg=jcfg, blocks=blocks, jstate=jstate,
                           state=state, jmetrics=jmetrics, metrics=metrics, jstats=jstats,
                           stats=stats, start=start)


def test_train_steps_match_jax(stepped):
    for s, (got, want) in enumerate(zip(stepped.metrics, stepped.jmetrics)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4, err_msg=f"step {s}")
        np.testing.assert_allclose(got["penalty"], want["penalty"], rtol=1e-4)
    assert stepped.state.step == int(stepped.jstate.step) == 2
    assert stepped.state.opt.count == int(stepped.jstate.opt.count) == 2
    for name, tree, jtree in (("params", stepped.state.params, stepped.jstate.params),
                              ("mu", stepped.state.opt.mu, stepped.jstate.opt.mu),
                              ("nu", stepped.state.opt.nu, stepped.jstate.opt.nu)):
        for path, leaf in tree_leaves_with_path(tree):
            close(leaf, leaf_by_path(jtree, path), f"{name}/" + "/".join(map(str, path)))
    # the weights moved: the comparison is not of two copies of the start
    moved = [float((a - leaf_by_path(stepped.start.params, p)).abs().max())
             for p, a in tree_leaves_with_path(stepped.state.params)]
    assert max(moved) > 1e-4


def s_swapped(got: np.ndarray, want: np.ndarray, kept: np.ndarray, tol: float) -> np.ndarray:
    """Positions where dense S differs by more than ``tol``, checked to be
    swaps at the COO cap's boundary (as ``tests/test_torch_train.py``
    allows): S keeps the ``cap`` largest magnitudes of each block, and two
    entries within rounding of the cap-th magnitude may trade places between
    two sweeps that agree to rounding. At most one pair per block; each such
    position is zero on one side and, on the other, within 1e-3 (relative)
    of the smallest magnitude JAX kept in that block."""
    bad = np.abs(got - want) > tol
    cap_kept = np.where(kept > 0, kept, np.inf).min(-1)
    for b in range(got.shape[0]):
        pos = np.argwhere(bad[b])
        assert len(pos) <= 2, (b, len(pos))
        for i, j in pos:
            g, w = got[b, i, j], want[b, i, j]
            assert (g == 0 or w == 0) and \
                abs(abs(g if w == 0 else w) - cap_kept[b]) <= 1e-3 * cap_kept[b], (b, i, j)
    return bad


def test_admm_step_matches_jax(stepped):
    np.testing.assert_allclose(float(stepped.stats["_mean_recon_err"]),
                               float(stepped.jstats["_mean_recon_err"]), rtol=1e-4)
    for info in stepped.blocks:
        g, w = stepped.state.slr[info.name], stepped.jstate.slr[info.name]
        close(g.p @ g.vt, w.p @ w.vt, f"{info.name} L")
        gs = sparse.to_dense(g.s_coo).numpy().reshape(-1, info.n, info.m)
        ws = np.asarray(jax_sparse.to_dense(w.s_coo)).reshape(gs.shape)
        kept = np.abs(np.asarray(w.s_coo.values)).reshape(len(ws), -1)
        swapped = s_swapped(gs, ws, kept, 1e-4 * float(np.abs(ws).max()))
        keep = ~swapped.reshape(g.z.shape)
        close(g.z[torch.from_numpy(keep)], np.asarray(w.z)[keep], f"{info.name} z")
        for f in ("y", "s_vals", "alpha", "beta"):
            close(getattr(g, f), getattr(w, f), f"{info.name} {f}")
        assert g.rho == pytest.approx(float(w.rho), rel=1e-6)


@pytest.mark.parametrize("stepped", ["qwen3_moe_30b_a3b"], indirect=True)
def test_moe_aux_term(stepped):
    """The MoE's load-balance loss enters the coupled loss with weight 0.01:
    its value equals JAX's per step, and loss = ce + 0.01 aux + penalty."""
    assert stepped.cfg.family == "moe"
    for got, want in zip(stepped.metrics, stepped.jmetrics):
        assert got["aux"] > 0
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-4)
        np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-4)
        np.testing.assert_allclose(got["task_loss"], got["ce"] + 0.01 * got["aux"], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], got["task_loss"] + got["penalty"], rtol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_selected_blocks_match_jax(family):
    """Names, shapes, stack dims, matrix dims and the embedding flag, in
    order, and the SLR state's leaf shapes: e.g. the MoE's (L, E, n, m)
    expert stacks, the hybrid's (G, E, n, m) SSM stacks beside its unstacked
    shared block, the encoder's and the decoder's stacks."""
    arch = FAMILIES[family]
    jcfg = jax_get_arch(arch).reduced()
    shapes = jax.eval_shape(lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    jscfg = JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16))
    want = jax_select_blocks(shapes, jscfg.selection)
    jslr = jax.eval_shape(lambda p: jax_init_slr_state(p, jscfg)[0], shapes)
    params = model_lib.init_params(get_arch(arch).reduced(), seed=0, device="cpu")
    state, got = init_train_state(params, SalaadConfig(selection=SelectionConfig(min_dim=16)))
    assert [(b.name, b.shape, b.stack_dims, b.n, b.m, b.is_embedding) for b in got] == \
        [(b.name, b.shape, b.stack_dims, b.n, b.m, b.is_embedding) for b in want]
    assert len(got) >= 2 and any(b.stack_dims for b in got)
    for info in got:
        blk, jblk = state.slr[info.name], jslr[info.name]
        for f in ("p", "vt", "s_vals", "y", "z", "alpha", "beta"):
            assert tuple(getattr(blk, f).shape) == tuple(getattr(jblk, f).shape), (info.name, f)
        assert tuple(blk.s_coo.values.shape) == tuple(jblk.s_coo.values.shape)


@pytest.mark.parametrize("arch", ["internvl2_76b", "whisper_small"])
def test_tokens_only_families_fit(arch):
    """Trainer.fit on ``SyntheticC4`` batches (no patches, no frames): 4
    steps with K = 2, finite losses and reconstruction errors."""
    cfg = get_arch(arch).reduced()
    trainer = Trainer(cfg, TrainerConfig(
        total_steps=4, log_every=1, adam=AdamConfig(lr=1e-3),
        salaad=SalaadConfig(update_every=2, selection=SelectionConfig(min_dim=16))),
        device="cpu")
    state = trainer.fit(trainer.init(seed=0), SyntheticC4(DataConfig(cfg.vocab_size, 16, 2)))
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    recon = [m["admm_recon_err"] for m in trainer.metrics_log if "admm_recon_err" in m]
    assert state.step == 4 and len(losses) == 4 and len(recon) == 2
    assert all(np.isfinite(losses)) and all(np.isfinite(recon))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_launcher_every_arch(arch, capsys):
    """``python -m repro_torch.launch.train`` takes every id: one train step
    and an ADMM sweep, its JSON line with a finite loss and recon error."""
    import json

    train_launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                         "--update-every", "1", "--seq-len", "16", "--batch", "2"])
    line = json.loads(capsys.readouterr().out)
    losses = [m["loss"] for m in line["metrics"] if "loss" in m]
    recon = [m["admm_recon_err"] for m in line["metrics"] if "admm_recon_err" in m]
    assert losses and recon and all(np.isfinite(losses + recon))


def test_hybrid_checkpoint_round_trip_in_jax_format(tmp_path):
    """The hybrid's state after two train steps and an ADMM step, written by
    the port, read by the JAX package, written again by it and read back by
    the port: every leaf equal, step and count kept."""
    cfg = get_arch("zamba2_2p7b").reduced()
    scfg = SalaadConfig(exact_svd=True, selection=SelectionConfig(min_dim=16))
    state, blocks = init_train_state(model_lib.init_params(cfg, seed=1, device="cpu"), scfg)
    step = make_train_step(cfg, blocks, AdamConfig(lr=LR))
    data = SyntheticC4(DataConfig(cfg.vocab_size, 16, 2))
    for s in range(2):
        state, _ = step(state, data.batch(s))
    state, _ = make_admm_step(scfg, blocks)(state)
    checkpoint.save(str(tmp_path / "port"), state.step, state)
    jcfg = jax_get_arch("zamba2_2p7b").reduced()
    target = jax_abstract_train_state(
        jax.eval_shape(lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(3))),
        JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16)))
    jstate = jax_checkpoint.restore(str(tmp_path / "port"), target)
    assert int(jstate.step) == 2 and int(jstate.opt.count) == 2
    jax_checkpoint.save(str(tmp_path / "jax"), 2, jstate)
    fresh, _ = init_train_state(model_lib.init_params(cfg, seed=4, device="cpu"), scfg)
    back = checkpoint.restore(str(tmp_path / "jax"), fresh)
    assert back.step == 2 and back.opt.count == 2
    want, got = checkpoint.flatten(state), checkpoint.flatten(back)
    assert set(got) == set(want) and any(k.startswith("slr/ssm_layers/in_proj") for k in got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def hybrid_loss(remat: bool):
    """Loss and gradients of the reduced hybrid (blockwise attention), and
    the shapes of the tensors autograd saved outside any checkpoint."""
    cfg = dataclasses.replace(get_arch("zamba2_2p7b").reduced(), remat=remat,
                              kernel_impl="blockwise")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    leaves = {"in_proj": params["ssm_layers"]["in_proj"].clone().requires_grad_(True),
              "q": params["shared_attn"]["q"].clone().requires_grad_(True)}
    params = {**params, "ssm_layers": {**params["ssm_layers"], "in_proj": leaves["in_proj"]},
              "shared_attn": {**params["shared_attn"], "q": leaves["q"]}}
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(tuple(x.shape)) or x, lambda x: x):
        loss, _ = model_lib.loss_fn(params, batch, cfg)
    loss.backward()
    return SimpleNamespace(cfg=cfg, loss=float(loss), grads={k: v.grad for k, v in leaves.items()},
                           saved=saved)


@pytest.fixture(scope="module")
def remat_runs():
    return {remat: hybrid_loss(remat) for remat in (False, True)}


def test_hybrid_remat_changes_memory_not_numbers(remat_runs):
    """The same loss and gradients with each SSM layer and each group under
    checkpoint."""
    off, on = remat_runs[False], remat_runs[True]
    assert on.loss == off.loss
    for k in off.grads:
        torch.testing.assert_close(on.grads[k], off.grads[k], rtol=1e-6, atol=1e-7)


def test_hybrid_remat_keeps_no_chunk_tensors(remat_runs):
    """The tensors autograd saves outside the checkpointed regions: without
    remat they include the chunked scan's (.., Q, Q) decay and score blocks;
    with it none of them, and far fewer elements in all (the group inputs,
    the final norm and the head)."""
    q = remat_runs[True].cfg.ssm_chunk

    def chunk_blocks(shapes):
        return [s for s in shapes if len(s) >= 4 and s[-2:] == (q, q)]

    assert chunk_blocks(remat_runs[False].saved) and not chunk_blocks(remat_runs[True].saved)
    n_off, n_on = (sum(int(np.prod(s)) for s in remat_runs[r].saved) for r in (False, True))
    assert n_on < n_off / 4, (n_on, n_off)
