"""Data-parallel SALAAD training in the port (``train/steps.py`` and
``train/trainer.py`` under a ``ServingMesh`` with ``data = N``), on four gloo
ranks on the CPU, against one process on the same global batch.

* The reduced Llama-60m, 3 train steps and then an exact-SVD ADMM step, at
  ``data=2`` and ``data=4``: every rank's parameters, Adam moments and SLR
  state are equal bit for bit; the losses are within 2e-3 of one process's
  and the embedding sum within 1e-3 relative (the JAX package's bounds,
  ``tests/test_distributed.py:80-82``), and within the tighter bounds
  ``LOSS_TOL`` and ``EMBED_TOL`` that the port reaches.
* A dropless reduced ``qwen3_moe_30b_a3b`` at ``data=2`` against JAX's
  ``make_train_step`` on the whole batch (global capacity and the global
  load-balance loss, whose gradient crosses the data ranks): losses of two
  steps within 1e-5 relative (Adam's eps 1e-3 on both sides, as
  ``tests/test_torch_train_families.py`` explains).
* Elastic restore: a checkpoint written by data rank 0 at ``data=2`` resumes
  here at ``data=1`` with the ranks' state bit for bit, and its next step's
  loss equals theirs within ``LOSS_TOL``.
* ``DevicePrefetcher(shardings=batch_shardings(...))`` places each rank's
  rows, and a train step on them equals one on the whole batch bit for bit.
* ``repro_torch.launch.train --distributed`` on the ranks' group: rank 0
  alone prints the JSON line, whose losses match a one-process run.
* ``Trainer`` over the model axis still raises "not ported yet".

The ranks (``launch/mesh.py::RankPool``, started once for the file, one torch
thread each) run functions of this module that import no JAX.
"""
import contextlib
import hashlib
import io
import json
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

SEQ, BATCH, STEPS, LR = 16, 4, 3, 1e-3
LOSS_TOL, EMBED_TOL = 1e-5, 1e-6
MOE_EPS = 1e-3
LAUNCH = ["--arch", "salaad_llama_60m", "--reduced", "--device", "cpu", "--steps", "2",
          "--update-every", "2", "--seq-len", str(SEQ), "--batch", str(BATCH), "--lr", "1e-3"]


def _llama():
    from repro_torch.configs import get_arch

    return get_arch("salaad_llama_60m").reduced()


def _trainer(mesh=None, **kw):
    from repro_torch.core.admm import SalaadConfig
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    salaad = SalaadConfig(selection=SelectionConfig(min_dim=16), update_every=STEPS,
                          exact_svd=True)
    return Trainer(_llama(), TrainerConfig(total_steps=STEPS, log_every=1, salaad=salaad,
                                           adam=AdamConfig(lr=LR), **kw),
                   mesh=mesh, device="cpu")


def _data():
    from repro_torch.data.synthetic import DataConfig, SyntheticC4

    return SyntheticC4(DataConfig(_llama().vocab_size, SEQ, BATCH, seed=0))


def _digest(state) -> str:
    """sha256 over every tensor of the state in checkpoint order."""
    from repro_torch.train import checkpoint

    h = hashlib.sha256()
    for key, arr in checkpoint.flatten(state).items():
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _fit(trainer, digest_at=None):
    """The trainer's run from seed 0; with ``digest_at``, the run stops
    there once (it checkpoints there), records the state's digest and goes
    on to the end, as one uninterrupted fit would."""
    state, at = trainer.init(seed=0), None
    if digest_at:
        state = trainer.fit(state, _data(), steps=digest_at)
        at = _digest(state)
    state = trainer.fit(state, _data())
    return {"losses": [m["loss"] for m in trainer.metrics_log if "loss" in m],
            "recon": [m["admm_recon_err"] for m in trainer.metrics_log
                      if "admm_recon_err" in m],
            "embed_sum": float(state.params["embed"]["embedding"].double().sum()),
            "digest": _digest(state), "digest_at": at}


# ------------------------------------------------------------ rank side ---


def _rank_train(rank, ckpt_dir, moe_weights, moe_batches):
    from repro_torch.launch import train as train_launcher
    from repro_torch.parallel.sharding import ServingMesh

    out = {}
    for data in (2, 4):
        mesh = ServingMesh.create(data=data)
        if not mesh.member:
            out[data] = None
            continue
        kw = dict(ckpt_dir=ckpt_dir, ckpt_every=2) if data == 2 else {}
        out[data] = _fit(_trainer(mesh, **kw), digest_at=2 if data == 2 else None)
    out["moe"] = _rank_moe_steps(moe_weights, moe_batches)
    out["prefetch"] = _rank_prefetch()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_launcher.main([*LAUNCH, "--distributed"])
    out["launcher"] = buf.getvalue()
    return out


def _rank_moe_steps(weights, batches):
    """Two train steps of the reduced MoE at ``data=2`` from the bridged
    JAX parameters, without SALAAD, the learning-rate scale held at 1."""
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.parallel.sharding import ServingMesh
    from repro_torch.train.state import init_train_state
    from repro_torch.train.steps import make_train_step

    mesh = ServingMesh.create(data=2)
    if not mesh.member:
        return None
    cfg = get_arch("qwen3_moe_30b_a3b").reduced()
    state, _ = init_train_state(bridge.params_from_numpy(weights, "cpu"), None)
    step = make_train_step(cfg, [], AdamConfig(lr=LR, eps=MOE_EPS), lambda s: 1.0)
    losses = []
    with mesh:
        for b in batches:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
    return {"losses": losses, "digest": _digest(state)}


def _rank_prefetch():
    """One train step on the whole batch and one on the prefetcher's rows."""
    from repro_torch.data.pipeline import DevicePrefetcher
    from repro_torch.parallel.sharding import LocalRows, ServingMesh, batch_shardings

    mesh = ServingMesh.create(data=2)
    if not mesh.member:
        return None
    src = _data()
    trainer = _trainer(mesh)
    state = trainer.init(seed=0)
    pf = DevicePrefetcher(src, shardings=batch_shardings(src.batch(0), mesh), device="cpu",
                          depth=1)
    try:
        local = pf.batch(0)
    finally:
        pf.close()
    with mesh:
        whole, _ = trainer._train_step(state, src.batch(0))
        placed, _ = trainer._train_step(state, local)
    lo = mesh.data_index * BATCH // 2
    return {"local_rows": isinstance(local, LocalRows) and local.n == BATCH,
            "rows": torch.equal(local["tokens"],
                                torch.from_numpy(src.batch(0)["tokens"][lo:lo + BATCH // 2])),
            "equal": _digest(whole) == _digest(placed)}


# ------------------------------------------------------------- JAX side ---


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_moe_run():
    """The reduced MoE's parameters and two batches, and JAX's losses of two
    train steps on the whole batch."""
    import jax

    from repro.configs.base import get_arch as jax_get_arch
    from repro.models import model as jax_model
    from repro.optim.adam import AdamConfig as JaxAdamConfig
    from repro.train.state import init_train_state as jax_init_train_state
    from repro.train.steps import make_train_step as jax_make_train_step

    cfg = jax_get_arch("qwen3_moe_30b_a3b").reduced()
    params = jax.jit(jax_model.init_params, static_argnums=0,
                     compiler_options=FAST_COMPILE)(cfg, jax.random.PRNGKey(0))
    weights = jax.tree_util.tree_map(np.asarray, params)
    state, _ = jax_init_train_state(params, None)
    step = jax.jit(jax_make_train_step(cfg, [], JaxAdamConfig(lr=LR, eps=MOE_EPS),
                                       lambda s: 1.0), compiler_options=FAST_COMPILE)
    rng = np.random.default_rng(5)
    batches, losses = [], []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batches.append(b)
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return weights, batches, losses


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import RankPool

    from repro_torch.launch import train as train_launcher

    ckpt = tempfile.TemporaryDirectory(prefix="dp_ckpt_")
    pool = RankPool(4, "cpu", threads=1)
    try:
        moe_weights, moe_batches, jax_losses = jax_moe_run()
        pool.submit(_rank_train, ckpt.name, moe_weights, moe_batches)
        single = _fit(_trainer())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_launcher.main(LAUNCH)
        ranks = pool.collect(timeout=300)
        resumed = _resume(ckpt)
    finally:
        pool.close()
    ckpt.cleanup()
    return SimpleNamespace(ranks=ranks, single=single, resumed=resumed,
                           jax_losses=jax_losses, launcher=buf.getvalue())


def _resume(ckpt):
    """The ranks' step-2 checkpoint restored at data=1, then its third step."""
    trainer = _trainer(ckpt_dir=ckpt.name, ckpt_every=0)
    state = trainer.maybe_restore(trainer.init(seed=0))
    restored = _digest(state)
    trainer.fit(state, _data())
    return {"step": int(state.step), "digest": restored,
            "losses": [m["loss"] for m in trainer.metrics_log if "loss" in m]}


def members(runs, key):
    got = [r[key] for r in runs.ranks if r[key] is not None]
    assert got, key
    return got


# ------------------------------------------------------------------ tests ---


@pytest.mark.parametrize("data", [2, 4])
def test_data_parallel_matches_one_process(runs, data):
    """Every rank holds the same state bit for bit; losses and the embedding
    sum match one process on the same global batch."""
    recs = members(runs, data)
    assert len(recs) == data
    assert len({r["digest"] for r in recs}) == 1
    ref = runs.single
    for rec in recs:
        assert len(rec["losses"]) == STEPS and len(rec["recon"]) == 1
        gap = max(abs(a - b) for a, b in zip(rec["losses"], ref["losses"]))
        assert gap < 2e-3 and gap < LOSS_TOL, gap
        rel = abs(rec["embed_sum"] - ref["embed_sum"]) / abs(ref["embed_sum"])
        assert rel < 1e-3 and rel < EMBED_TOL, rel
        assert abs(rec["recon"][0] - ref["recon"][0]) <= LOSS_TOL * abs(ref["recon"][0])


def test_moe_data_parallel_matches_jax_global_loss(runs):
    """The dropless reduced MoE at ``data=2``: both ranks equal bit for bit,
    losses of two steps within 1e-5 relative of JAX's whole-batch losses."""
    recs = members(runs, "moe")
    assert len(recs) == 2 and recs[0]["digest"] == recs[1]["digest"]
    for got, want in zip(recs[0]["losses"], runs.jax_losses):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_elastic_restore_two_to_one(runs):
    """Data rank 0's step-2 checkpoint of the ``data=2`` run resumes in one
    process: the restored state is the ranks' at step 2 bit for bit (the
    third step's loss, from it, matches theirs)."""
    assert runs.resumed is not None and runs.resumed["step"] == 2
    at_two = {r["digest_at"] for r in members(runs, 2)}
    assert at_two == {runs.resumed["digest"]}
    ranks_loss = members(runs, 2)[0]["losses"][2]
    assert runs.resumed["losses"] == [pytest.approx(ranks_loss, abs=LOSS_TOL)]


def test_device_prefetcher_shardings(runs):
    for rec in members(runs, "prefetch"):
        assert rec["local_rows"] and rec["rows"] and rec["equal"]


def test_train_launcher_distributed(runs):
    """``--distributed`` joins the ranks' group and trains over all four;
    rank 0 alone prints, and its losses match the one-process launcher's."""
    outs = [r["launcher"] for r in runs.ranks]
    assert all(not o.strip() for o in outs[1:])
    got = json.loads(outs[0])["metrics"]
    want = json.loads(runs.launcher)["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        for key in set(w) - {"sec"}:
            assert g[key] == pytest.approx(w[key], rel=1e-5, abs=1e-6), key


def test_trainer_over_the_model_axis_is_not_ported_yet():
    from repro_torch.parallel.sharding import ServingMesh

    with pytest.raises(ValueError, match="not ported yet: training over the model axis"):
        _trainer(ServingMesh(1, 2))
