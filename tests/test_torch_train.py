"""SALAAD training in the port against the JAX package, on the CPU at reduced
size: the randomized SVD, the stage-1 penalty and its gradient, the rSVD
ADMM sweep with JAX's sketches handed over, the loss, the flash attention
forward and backward, Adam and its schedule, the synthetic data stream, the
whole ``Trainer.fit`` (exact SVD) from one bridged state, and a bit-exact
restart replay.

Inputs come from numpy seeds or from the JAX package and reach the port as
numpy arrays. Tolerances are stated per test, f32 throughout: the two sides
sum in different orders, so agreement is to rounding, not to the bit.
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
from repro.core.admm import admm_update as jax_admm_update
from repro.core.admm import init_slr_state as jax_init_slr_state
from repro.core.admm import penalty as jax_penalty
from repro.core.admm import slr_param_count as jax_slr_param_count
from repro.core.rsvd import randomized_svd as jax_randomized_svd
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticC4 as JaxSyntheticC4
from repro.models import model as jax_model
from repro.models.flash_vjp import flash_attention_jax
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.optim.adam import adam_update as jax_adam_update
from repro.optim.adam import init_adam as jax_init_adam
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import sparse
from repro_torch.core.admm import SalaadConfig, admm_update, penalty, slr_param_count
from repro_torch.core.rsvd import randomized_svd, sketch
from repro_torch.core.salaad import Salaad
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.data.synthetic import DataConfig, SyntheticC4
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.models.flash_vjp import flash_attention_vjp
from repro_torch.optim.adam import AdamConfig, AdamState, adam_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.checkpoint import flatten
from repro_torch.train.trainer import Trainer, TrainerConfig

TOL = dict(atol=1e-5, rtol=1e-5)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reduced():
    """A reduced Llama on both sides with the same weights, and a JAX SLR
    state after two exact sweeps (non-zero L, S, Y, Z, alpha, beta)."""
    jcfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(rho_constant=5.0, exact_svd=True,
                           selection=JaxSelectionConfig(min_dim=16))
    state, blocks = jax_init_slr_state(params, scfg)
    sweep = jax.jit(lambda p, s, step: jax_admm_update(p, s, blocks, scfg, step))
    for step in range(2):
        state, _ = sweep(params, state, step)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        jcfg=jcfg, cfg=get_arch("salaad_llama_60m").reduced(), params=params, state=state,
        blocks=blocks, tparams=tparams,
        tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams, SelectionConfig(min_dim=16)))


# ------------------------------------------------------------------ core ---


@pytest.mark.parametrize("shape,rank,n_iter", [((40, 24), 8, 2), ((3, 33, 50), 12, 1)])
def test_randomized_svd_matches_jax(shape, rank, n_iter):
    """The same sketch on both sides (JAX's, for its key) gives the same
    factorization; compared through U diag(s) Vt and s, since the QR and SVD
    factors' signs are free. Tolerance 1e-4 relative to the matrix scale."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shape).astype(np.float32)
    *batch, n, m = shape
    mats = a.reshape(-1, n, m)
    keys = [jax.random.PRNGKey(i) for i in range(len(mats))]
    omega = np.stack([np.asarray(jax.random.normal(k, (m, rank), jnp.float32)) for k in keys])
    u, s, vt = randomized_svd(torch.from_numpy(mats), torch.from_numpy(omega), n_iter)
    for b, k in enumerate(keys):
        ju, js, jvt = jax_randomized_svd(jnp.asarray(mats[b]), k, rank, n_iter)
        np.testing.assert_allclose(s[b].numpy(), np.asarray(js), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose((u[b] * s[b]) @ vt[b], np.asarray((ju * js) @ jvt),
                                   atol=1e-4 * np.abs(mats[b]).max(), rtol=0)


def test_prox_matches_jax():
    """SVT, the effective rank ratio of a full-rank and a rank-3 matrix, and
    the density of a thresholded matrix: 1e-5 on the values, equal on the
    counts."""
    from repro.core import prox as jprox
    from repro_torch.core import prox

    rng = np.random.default_rng(6)
    z = rng.standard_normal((24, 17)).astype(np.float32)
    for tau in (0.0, 1.5):
        (gs, gl), (ws, wl) = prox.svt(torch.from_numpy(z), tau), jprox.svt(jnp.asarray(z), tau)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    low = (rng.standard_normal((24, 3)) @ rng.standard_normal((3, 17))).astype(np.float32)
    for m in (z, low):
        assert float(prox.effective_rank_ratio(torch.from_numpy(m))) == \
            float(jprox.effective_rank_ratio(jnp.asarray(m)))
    s = prox.soft_threshold(torch.from_numpy(z), 0.8)
    want = jprox.density(jprox.soft_threshold(jnp.asarray(z), 0.8))
    assert round(float(prox.density(s)) * z.size) == round(float(want) * z.size)


def test_sketch_is_a_pure_function_of_its_key():
    a, b = sketch((3, 1, 0, 0), 16, 4), sketch((3, 1, 0, 0), 16, 4)
    assert torch.equal(a, b) and a.device.type == "cpu" and a.shape == (16, 4)
    assert not torch.equal(a, sketch((3, 1, 1, 0), 16, 4))


def test_penalty_and_grad_match_jax(reduced):
    """sum rho/2 ||X - Z||^2 against the cached Z, and its gradient with
    respect to every parameter (Z detached): rtol 1e-5."""
    want, want_g = jax.value_and_grad(
        lambda p: jax_penalty(p, reduced.state, reduced.blocks))(reduced.params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              [("q", reduced.tparams["layers"]["q"]), ("emb", reduced.tparams["embed"]["embedding"])]}
    params = {**reduced.tparams, "layers": {**reduced.tparams["layers"], "q": leaves["q"]},
              "embed": {"embedding": leaves["emb"]}}
    got = penalty(params, reduced.tstate, reduced.tblocks)
    got.backward()
    assert float(got.detach()) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(leaves["q"].grad.numpy(), np.asarray(want_g["layers"]["q"]),
                               **TOL)
    np.testing.assert_allclose(leaves["emb"].grad.numpy(),
                               np.asarray(want_g["embed"]["embedding"]), **TOL)


def jax_sketches(blocks, state, step: int, sweeps: int) -> dict:
    """The rSVD sketches the JAX package draws inside ``admm_update`` at
    ``step``: fold_in(fold_in(PRNGKey(0), step), i), split per slice, then
    fold_in(key, j) per sweep - as numpy (nb, J, m, r) per block."""
    out = {}
    for i, info in enumerate(blocks):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    jnp.asarray(step, jnp.int32)), i)
        keys = jax.random.split(key, info.num_blocks) if info.stack_dims else [key]
        r = state[info.name].p.shape[-1]
        out[info.name] = torch.from_numpy(np.stack([np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(k, j), (info.m, r), jnp.float32))
            for j in range(sweeps)]) for k in keys]))
    return out


def assert_s_close(got: np.ndarray, want: np.ndarray, cap_kept: np.ndarray, max_swaps: int):
    """Dense S within 1e-4, except for at most ``max_swaps`` pairs of
    positions per block at the COO cap's boundary: S keeps the ``cap``
    largest magnitudes, and two entries within rounding of the cap-th
    magnitude may swap between two SVDs that agree to 1e-6. A swapped
    position is zero on one side and, on the other, within 1e-3 (relative)
    of the smallest magnitude that side kept."""
    bad = ~np.isclose(got, want, atol=1e-4, rtol=1e-4)
    for b in range(got.shape[0]):
        pos = np.argwhere(bad[b])
        assert len(pos) <= 2 * max_swaps, (b, len(pos))
        for i, j in pos:
            g, w = got[b, i, j], want[b, i, j]
            kept = g if w == 0 else w
            assert (g == 0 or w == 0) and abs(abs(kept) - cap_kept[b]) <= 1e-3 * cap_kept[b]


@pytest.mark.parametrize("step", [2, 7])
def test_admm_update_rsvd_matches_jax(reduced, step):
    """One rSVD sweep from the two-sweep state, the port fed JAX's sketches
    for ``step``. L is compared as p @ vt, S through its dense form (allowing
    one swap per block at the cap's boundary, see ``assert_s_close``), Y, Z,
    alpha and beta at 1e-4 (a swap moves Z by the swapped values: Z is
    compared away from them), and the parameter counts exactly."""
    scfg = JaxSalaadConfig(rho_constant=5.0, selection=JaxSelectionConfig(min_dim=16))
    want, want_stats = jax_admm_update(reduced.params, reduced.state, reduced.blocks, scfg, step)
    tcfg = SalaadConfig(rho_constant=5.0, selection=SelectionConfig(min_dim=16))
    got, stats = admm_update(reduced.tparams, reduced.tstate, reduced.tblocks, tcfg, step,
                             sketches=jax_sketches(reduced.blocks, reduced.state, step, 1))
    tol = dict(atol=1e-4, rtol=1e-4)
    for info in reduced.tblocks:
        g, w = got[info.name], want[info.name]
        np.testing.assert_allclose((g.p @ g.vt).numpy(), np.asarray(w.p @ w.vt), **tol)
        gs = sparse.to_dense(g.s_coo).numpy().reshape(-1, info.n, info.m)
        ws = np.asarray(jax_sparse.to_dense(w.s_coo)).reshape(-1, info.n, info.m)
        kept = np.abs(np.asarray(w.s_coo.values)).reshape(len(ws), -1)
        assert_s_close(gs, ws, np.where(kept > 0, kept, np.inf).min(-1), max_swaps=1)
        same = np.isclose(gs, ws, atol=1e-4, rtol=1e-4).reshape(g.z.shape)
        np.testing.assert_allclose(g.z.numpy()[same], np.asarray(w.z)[same], **tol)
        for f in ("s_vals", "y", "alpha", "beta"):
            np.testing.assert_allclose(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                       err_msg=f, **tol)
    np.testing.assert_allclose(float(stats["_mean_recon_err"]),
                               float(want_stats["_mean_recon_err"]), rtol=1e-3)
    assert slr_param_count(got, reduced.tblocks) == jax_slr_param_count(want, reduced.blocks)


def test_admm_update_draws_its_own_sketches(reduced, monkeypatch):
    """Without handed-in sketches the sweep draws them from (step, block,
    slice, sweep) keys: the same step twice is bit-equal, another step not.
    The S-update of every selected leaf goes through ``ops.soft_threshold``
    once per sweep, with one threshold per slice."""
    calls = []
    shrink = ops.soft_threshold
    monkeypatch.setattr(ops, "soft_threshold",
                        lambda x, tau: calls.append((x.shape, tau.shape)) or shrink(x, tau))
    tcfg = SalaadConfig(rho_constant=5.0, selection=SelectionConfig(min_dim=16))
    a, _ = admm_update(reduced.tparams, reduced.tstate, reduced.tblocks, tcfg, 4)
    assert [c[1][0] for c in calls] == [b.num_blocks for b in reduced.tblocks]
    assert [c[0][0] for c in calls] == [b.num_blocks for b in reduced.tblocks]
    b, _ = admm_update(reduced.tparams, reduced.tstate, reduced.tblocks, tcfg, 4)
    c, _ = admm_update(reduced.tparams, reduced.tstate, reduced.tblocks, tcfg, 5)
    name = "layers/q"
    assert torch.equal(a[name].p, b[name].p) and torch.equal(a[name].y, b[name].y)
    assert not torch.equal(a[name].p, c[name].p)


def test_salaad_api(reduced):
    sal = Salaad(SalaadConfig(rho_constant=5.0, exact_svd=True,
                              selection=SelectionConfig(min_dim=16)))
    with pytest.raises(RuntimeError, match="init"):
        sal.penalty(reduced.tparams, reduced.tstate)
    state = sal.init(reduced.tparams)
    assert [b.name for b in sal.blocks] == [b.name for b in reduced.tblocks]
    assert float(sal.penalty(reduced.tparams, state)) > 0           # Z = 0
    state, stats = sal.update(reduced.tparams, state, 0)
    assert sal.param_count(state)["_total"] > 0
    small, report = sal.compress(state, sal.param_count(state)["_total"] // 2, 0.7)
    assert report["params_after"] < report["params_before"]
    assert sal.surrogate(reduced.tparams, small)["layers"]["q"].shape == (
        reduced.tparams["layers"]["q"].shape)


# ---------------------------------------------------------------- models ---


def test_cross_entropy_and_loss_match_jax(reduced):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = model_lib.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if m is None else torch.from_numpy(m))
        want = jax_model.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    batch = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 256, (2, 16)).astype(np.int32)}
    for impl in ("dense", "blockwise"):
        cfg = dataclasses.replace(reduced.cfg, kernel_impl=impl)
        jcfg = dataclasses.replace(reduced.jcfg, kernel_impl=impl)
        got, gm = model_lib.loss_fn(reduced.tparams, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()}, cfg)
        want, wm = jax_model.loss_fn(reduced.params, {k: jnp.asarray(v)
                                                      for k, v in batch.items()}, jcfg)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("b,hq,hkv,t,d,causal,blocks", [
    (2, 4, 2, 37, 16, True, (16, 8)),      # GQA, T ragged against both blocks
    (1, 2, 2, 24, 8, True, (32, 64)),      # one block each way
    (2, 2, 1, 19, 8, False, (8, 16)),      # non-causal, ragged
])
def test_flash_vjp_matches_jax(b, hq, hkv, t, d, causal, blocks):
    """Forward and the gradients of a random linear functional of the output
    with respect to q, k and v, against JAX's custom VJP: atol/rtol 1e-5."""
    rng = np.random.default_rng(t)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d), (b, hq, t, d)))
    qb, kb = blocks

    def jf(q_, k_, v_):
        return jnp.sum(flash_attention_jax(q_, k_, v_, causal, qb, kb) * w)

    want_out = flash_attention_jax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, qb, kb)
    want_g = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_vjp(tq, tk, tv, causal, qb, kb)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pallas_attention_refuses_gradients(reduced):
    cfg = dataclasses.replace(reduced.cfg, kernel_impl="pallas")
    params = {**reduced.tparams, "layers": {**reduced.tparams["layers"],
                                            "q": reduced.tparams["layers"]["q"].clone()
                                            .requires_grad_(True)}}
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="no backward"):
        model_lib.loss_fn(params, batch, cfg)


def test_remat_changes_memory_not_numbers(reduced):
    """The same loss and gradients with every layer under checkpoint."""
    batch = {"tokens": torch.arange(32).reshape(2, 16) % 256,
             "labels": torch.arange(1, 33).reshape(2, 16) % 256}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(reduced.cfg, remat=remat, kernel_impl="blockwise")
        q = reduced.tparams["layers"]["q"].clone().requires_grad_(True)
        params = {**reduced.tparams, "layers": {**reduced.tparams["layers"], "q": q}}
        loss, _ = model_lib.loss_fn(params, batch, cfg)
        loss.backward()
        grads.append((float(loss), q.grad))
    assert grads[0][0] == grads[1][0]
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- optim ---


def test_adam_and_schedule_match_jax():
    """Three clipped Adam updates (the first gradient above the clip norm)
    with a warmup-cosine scale: params and moments at 1e-6."""
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    cfg = dict(lr=1e-2, grad_clip=1.0)
    jp, jst = jax.tree.map(jnp.asarray, params), jax_init_adam(params)
    tp = bridge.params_from_numpy(params, "cpu")
    tst = AdamState(*[bridge.params_from_numpy(to_numpy(x), "cpu") for x in (jst.mu, jst.nu)],
                    count=0)
    for step in range(3):
        g = {"a": rng.standard_normal((4, 5)).astype(np.float32) * (3.0 if step == 0 else 0.1),
             "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
        scale = warmup_cosine(step + 7, warmup=5, total=20)
        np.testing.assert_allclose(scale, float(jax_warmup_cosine(step + 7, warmup=5, total=20)),
                                   rtol=1e-7)
        jp, jst = jax_adam_update(jax.tree.map(jnp.asarray, g), jst, jp, JaxAdamConfig(**cfg),
                                  scale)
        tp, tst = adam_update(bridge.params_from_numpy(g, "cpu"), tst, tp, AdamConfig(**cfg),
                              scale)
    assert tst.count == int(jst.count) == 3
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]),
                                   rtol=1e-6, atol=1e-7)
    for s in (0, 50, 100, 5000, 10000, 20000):
        np.testing.assert_allclose(warmup_cosine(s), float(jax_warmup_cosine(s)), rtol=1e-7)


def test_synthetic_c4_batches_equal_jax():
    got = SyntheticC4(DataConfig(256, 33, 4, seed=3))
    want = JaxSyntheticC4(JaxDataConfig(256, 33, 4, seed=3))
    for step in (0, 1, 17):
        for host in ((0, 1), (1, 2)):
            g, w = got.batch(step, *host), want.batch(step, *host)
            for k in ("tokens", "labels"):
                assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()


# --------------------------------------------------------------- trainer ---


STEPS, K = 10, 5


@pytest.fixture(scope="module")
def fitted():
    """The JAX Trainer and the port's Trainer (exact SVD, K = 5) run 10 steps
    from one state, bridged across, on the same batches."""
    jcfg = jax_get_arch("salaad_llama_60m").reduced()
    data_cfg = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4, seed=1)
    jtrainer = JaxTrainer(jcfg, JaxTrainerConfig(
        total_steps=STEPS, log_every=1, adam=JaxAdamConfig(lr=1e-2),
        salaad=JaxSalaadConfig(exact_svd=True, update_every=K, rho_constant=5.0,
                               selection=JaxSelectionConfig(min_dim=16))))
    jstate0 = jtrainer.init(jax.random.PRNGKey(0))
    start = bridge.train_state_from_numpy(to_numpy(jstate0), "cpu")
    jstate = jtrainer.fit(jstate0, JaxSyntheticC4(JaxDataConfig(**data_cfg)))
    trainer = Trainer(get_arch("salaad_llama_60m").reduced(), TrainerConfig(
        total_steps=STEPS, log_every=1, adam=AdamConfig(lr=1e-2),
        salaad=SalaadConfig(exact_svd=True, update_every=K, rho_constant=5.0,
                            selection=SelectionConfig(min_dim=16))), device="cpu")
    trainer.init(params=start.params)
    ops.reset_launch_counts()
    state = trainer.fit(start, SyntheticC4(DataConfig(**data_cfg)))
    return SimpleNamespace(jtrainer=jtrainer, jstate=jstate, trainer=trainer, state=state,
                           jcfg=jcfg, start=start)


def test_trainer_fit_matches_jax(fitted):
    """Per-step losses at 1e-5 relative, the ADMM phases' mean reconstruction
    error at 1e-4, the final parameters at atol 1e-4. The parameter bound is
    absolute and looser than rounding: after an ADMM phase an embedding row
    that no batch touched gets only the penalty's gradient rho (x - Z), a
    difference of nearly equal numbers, and Adam scales that rounding noise
    up to a step of lr x schedule (up to 9e-4 here) whose sign either side
    may flip; 1.2e-5 was seen."""
    got, want = fitted.trainer.metrics_log, fitted.jtrainer.metrics_log
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    losses = [(g["loss"], w["loss"]) for g, w in zip(got, want) if "loss" in g]
    recon = [(g["admm_recon_err"], w["admm_recon_err"]) for g, w in zip(got, want)
             if "admm_recon_err" in g]
    assert len(losses) == STEPS and len(recon) == STEPS // K
    np.testing.assert_allclose(*zip(*losses), rtol=1e-5)
    np.testing.assert_allclose(*zip(*recon), rtol=1e-4)
    assert losses[-1][0] < losses[0][0]
    assert fitted.state.step == int(fitted.jstate.step) == STEPS
    assert fitted.state.opt.count == int(fitted.jstate.opt.count) == STEPS
    jp = to_numpy(fitted.jstate.params)
    for name in ("q", "gate", "down"):
        np.testing.assert_allclose(fitted.state.params["layers"][name].numpy(),
                                   jp["layers"][name], atol=1e-4, rtol=0)
    np.testing.assert_allclose(fitted.state.params["embed"]["embedding"].numpy(),
                               jp["embed"]["embedding"], atol=1e-4, rtol=0)
    for name, blk in fitted.state.slr.items():
        w = fitted.jstate.slr[name]
        np.testing.assert_allclose((blk.p @ blk.vt).numpy(), np.asarray(w.p @ w.vt),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(blk.alpha.numpy(), np.asarray(w.alpha), atol=1e-6)


def test_restart_replays_bit_for_bit(tmp_path):
    """rSVD path: save at step 5, restore in a fresh trainer, continue to 10;
    equal to an uninterrupted run to the bit (batches and sketches are keyed
    by the step)."""
    cfg = get_arch("salaad_llama_60m").reduced()
    data = SyntheticC4(DataConfig(cfg.vocab_size, 16, 4, seed=2))

    def trainer(ckpt_dir=None):
        return Trainer(cfg, TrainerConfig(
            total_steps=STEPS, log_every=1, ckpt_dir=ckpt_dir, ckpt_every=K,
            adam=AdamConfig(lr=1e-2),
            salaad=SalaadConfig(update_every=K, selection=SelectionConfig(min_dim=16))),
            device="cpu")

    ref_tr = trainer()
    ref = ref_tr.fit(ref_tr.init(seed=3), data)
    first = trainer(str(tmp_path))
    first.fit(first.init(seed=3), data, steps=K)
    second = trainer(str(tmp_path))
    state = second.maybe_restore(second.init(seed=99))
    assert second.events == [f"restored step {K}"] and state.step == K
    state = second.fit(state, data)
    assert [m for m in second.metrics_log if "loss" in m][-1]["loss"] == \
        [m for m in ref_tr.metrics_log if "loss" in m][-1]["loss"]
    got, want = flatten(state), flatten(ref)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert state.opt.count == ref.opt.count and state.step == ref.step
