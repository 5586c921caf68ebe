"""The Table 1 baselines in the port (``baselines/reparam.py``) against the
JAX package's on the reduced ``salaad_llama_60m``: ``materialize`` and
``param_count`` of the three reparameterizations, given JAX's drawn values
(LoRA's A, SLTrain's factors and support) and equal non-zero trainable
values on both sides; one ``GaLoreAdam.update`` with a projector refresh,
given JAX's projectors and its refresh sketches; and ``train_baseline`` for 3
steps of each of the four methods from JAX's initial parameters and draws.

f32 throughout, TF32 off. Tolerances: materialized weights within 1e-6 of
each leaf's largest value; GaLore's parameters within 1e-5 of each leaf's
largest value, the refreshed subspace through ``P P^T`` within 1e-4 and the
second moments within 1e-4 of their largest value (the SVD's column signs
are free, and neither the first update nor the second moments depend on them);
losses within 1e-4 relative.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import reparam as jax_reparam
from repro.configs.base import get_arch as jax_get_arch
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticC4 as JaxSyntheticC4
from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.baselines import FullRank, GaLoreAdam, LoRAReparam, SLTrainReparam
from repro_torch.baselines import train_baseline
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import DataConfig, SyntheticC4
from repro_torch.tree import leaf_by_path, tree_leaves_with_path

PORT = {"full-rank": FullRank, "lora": LoRAReparam, "sltrain": SLTrainReparam,
        "galore": GaLoreAdam}
JAX = {"full-rank": jax_reparam.FullRank, "lora": jax_reparam.LoRAReparam,
       "sltrain": jax_reparam.SLTrainReparam, "galore": jax_reparam.GaLoreAdam}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)        # tiny tensors: more threads only contend in a loaded suite
    jcfg = jax_get_arch("salaad_llama_60m").reduced()
    key = jax.random.PRNGKey(0)
    params = jax_model.init_params(jcfg, key)
    yield SimpleNamespace(jcfg=jcfg, cfg=get_arch("salaad_llama_60m").reduced(), key=key,
                          params=params, inits={},
                          tparams=bridge.params_from_numpy(to_numpy(params), "cpu"))
    torch.backends.cuda.matmul.allow_tf32 = prev[0]
    torch.set_num_threads(prev[1])


def jax_init(setup, name: str):
    """JAX's init of a method, drawn once per module (SLTrain's draw of its
    support compiles a permutation per leaf shape)."""
    if name not in setup.inits:
        setup.inits[name] = JAX[name]().init(setup.params, setup.key)
    return setup.inits[name]


def drawn_values(name: str, jt) -> dict | None:
    """The values JAX's init drew, as numpy, in the port's ``drawn`` form."""
    if name == "lora":
        return {k: {"a": np.asarray(v["a"])} for k, v in jt["adapters"].items()}
    if name == "sltrain":
        return {k: {"a": np.asarray(v["a"]), "b": np.asarray(v["b"]),
                    "support": np.asarray(jt["_support"][k])} for k, v in jt["reps"].items()}
    return None


@pytest.mark.parametrize("name", ["full-rank", "lora", "sltrain"])
def test_materialize_and_param_count_match_jax(setup, name):
    jt = dict(jax_init(setup, name))
    method = PORT[name]()
    t = method.init(setup.tparams, drawn=drawn_values(name, jt))
    # give every zero-initialized trainable table the same random values on
    # both sides, so materialize has work to do
    rng = np.random.default_rng(7)
    group = {"lora": ("adapters", "b"), "sltrain": ("reps", "s_values")}.get(name)
    if group:
        jt[group[0]] = {k: dict(v) for k, v in jt[group[0]].items()}   # the cached draw stays
        for blk_name, blk in jt[group[0]].items():
            vals = (rng.standard_normal(blk[group[1]].shape) * 0.1).astype(np.float32)
            blk[group[1]] = jnp.asarray(vals)
            t[group[0]][blk_name][group[1]] = torch.from_numpy(vals)
    want = JAX[name]().materialize(jt)
    got = method.materialize(t)
    for path, leaf in tree_leaves_with_path(got):
        w = np.asarray(leaf_by_path(want, path))
        np.testing.assert_allclose(leaf.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg="/".join(map(str, path)))
    assert method.param_count(t) == JAX[name]().param_count(jt)


def test_galore_refresh_update_matches_jax(setup):
    """One update at step 2 with ``refresh_every=2`` from the initial state:
    the projectors refreshed from the gradient's randomized SVD on JAX's
    sketches (``PRNGKey(step)``, split per slice of a stacked leaf), the
    selected leaves updated in the projected space, every other leaf by
    dense Adam."""
    jm = jax_reparam.GaLoreAdam(rank=4, refresh_every=2)
    jstate = jm.init_state(setup.params, setup.key)
    rng = np.random.default_rng(11)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), to_numpy(setup.params))
    update = jax.jit(lambda g, st, p: jm.update(g, st, p, 2),
                     compiler_options={"xla_backend_optimization_level": 0,
                                       "xla_llvm_disable_expensive_passes": True})
    want_p, want_s = update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, setup.params)
    method = GaLoreAdam(rank=4, refresh_every=2)
    state = method.init_state(setup.tparams, drawn={
        k: {"q": np.asarray(v)} for k, v in jstate["proj"].items()})
    sketches = {}
    for info in method.blocks:
        r = state["proj"][info.name].shape[-1]
        keys = (jax.random.split(jax.random.PRNGKey(2), info.num_blocks) if info.stack_dims
                else [jax.random.PRNGKey(2)])
        sketches[info.name] = torch.from_numpy(np.stack(
            [np.asarray(jax.random.normal(k, (info.m, r), jnp.float32)) for k in keys]))
    got_p, got_s = method.update(bridge.params_from_numpy(grads, "cpu"), state,
                                 setup.tparams, 2, sketches=sketches)
    assert got_s["count"] == int(want_s["count"]) == 1
    for path, leaf in tree_leaves_with_path(got_p):
        w = np.asarray(leaf_by_path(want_p, path))
        np.testing.assert_allclose(leaf.numpy(), w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg="/".join(map(str, path)))
    for name, p in got_s["proj"].items():
        wp = np.asarray(want_s["proj"][name])
        np.testing.assert_allclose((p @ p.transpose(-1, -2)).numpy(),
                                   wp @ np.swapaxes(wp, -1, -2), atol=1e-4, rtol=0)
        want_nu = np.asarray(want_s["mom"][name]["nu"])
        np.testing.assert_allclose(got_s["mom"][name]["nu"].numpy(), want_nu, rtol=0,
                                   atol=1e-4 * float(want_nu.max()))


@pytest.mark.parametrize("name", ["full-rank", "lora", "sltrain", "galore"])
def test_train_baseline_matches_jax(setup, name):
    """3 steps from JAX's initial parameters and draws, on the same batches:
    per-step losses, the eval loss (one batch) and the parameter count."""
    data = dict(vocab_size=setup.jcfg.vocab_size, seq_len=16, global_batch=2, seed=1)
    want_eval, want_n, want_losses = jax_reparam.train_baseline(
        JAX[name](), setup.jcfg, JaxSyntheticC4(JaxDataConfig(**data)), 3, setup.key,
        eval_batches=1)
    if name == "galore":
        jstate = jax_reparam.GaLoreAdam().init_state(setup.params, setup.key)
        drawn = {k: {"q": np.asarray(v)} for k, v in jstate["proj"].items()}
    else:
        drawn = drawn_values(name, jax_init(setup, name))
    got_eval, got_n, got_losses = train_baseline(
        PORT[name](), setup.cfg, SyntheticC4(DataConfig(**data)), 3,
        params=setup.tparams, drawn=drawn, eval_batches=1)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-4)
    assert got_n == want_n
