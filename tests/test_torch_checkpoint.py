"""Checkpoints cross between the JAX package and the port in both directions:
the port's ``train/checkpoint.py`` writes the JAX package's format (one
``arrays.npz`` of path-keyed leaves per step, ``meta.json``, a
``manifest.json``, keep-last-k) and reads what the JAX package writes, with
equal keys and equal leaves (f32 leaves exactly; bfloat16 is stored as f32).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.admm import SalaadConfig as JaxSalaadConfig
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.models import model as jax_model
from repro.train import checkpoint as jax_checkpoint
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.steps import make_admm_step as jax_make_admm_step
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.admm import SalaadConfig
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.models import model as model_lib
from repro_torch.train import checkpoint
from repro_torch.train.state import init_train_state
from repro_torch.train.steps import make_admm_step


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainState with every kind of leaf non-trivial: parameters, Adam
    moments and count, an SLR state after one ADMM step, a step counter."""
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(1))
    scfg = JaxSalaadConfig(exact_svd=True, selection=JaxSelectionConfig(min_dim=16))
    state, blocks = jax_init_train_state(params, scfg)
    rng = np.random.default_rng(0)
    fill = lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    state = state._replace(
        opt=state.opt._replace(mu=jax.tree.map(fill, state.opt.mu),
                               nu=jax.tree.map(lambda x: jnp.abs(fill(x)), state.opt.nu),
                               count=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(7, jnp.int32))
    state, _ = jax.jit(jax_make_admm_step(scfg, blocks))(state)
    return state


def port_target(seed: int = 5):
    """A fresh port TrainState of the same structure (other values)."""
    cfg = get_arch("salaad_llama_60m").reduced()
    params = model_lib.init_params(cfg, seed, "cpu")
    return init_train_state(params, SalaadConfig(selection=SelectionConfig(min_dim=16)))[0]


def npz_keys(path) -> dict:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_jax_checkpoint_restores_in_port(jax_state, tmp_path):
    path = jax_checkpoint.save(str(tmp_path), 7, jax_state)
    written = npz_keys(path)
    assert {"params/layers/q", "opt/mu/layers/q", "opt/count", "step",
            "slr/layers/q/s_coo/values", "slr/embed/embedding/alpha"} <= set(written)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    target = port_target()
    got = checkpoint.restore(str(tmp_path), target)
    assert got.step == 7 and got.opt.count == 7
    flat = checkpoint.flatten(got)
    assert set(flat) == set(written)
    for key, want in written.items():
        np.testing.assert_array_equal(flat[key], want, err_msg=key)
        assert flat[key].dtype == want.dtype, key
    blk, want_blk = got.slr["layers/q"], jax_state.slr["layers/q"]
    assert blk.rho == want_blk.rho and blk.s_coo.shape == want_blk.s_coo.shape


def test_port_checkpoint_restores_in_jax(jax_state, tmp_path):
    """The port saves a state (the JAX one bridged across, then stepped on by
    one port ADMM sweep); the JAX package restores it leaf for leaf."""
    state = bridge.train_state_from_numpy(to_numpy(jax_state), "cpu")
    blocks = select_blocks(state.params, SelectionConfig(min_dim=16))
    state, _ = make_admm_step(SalaadConfig(selection=SelectionConfig(min_dim=16)), blocks)(state)
    path = checkpoint.save(str(tmp_path), int(state.step), state)
    written = npz_keys(path)
    want_keys = set(npz_keys(jax_checkpoint.save(str(tmp_path / "jax"), 7, jax_state)))
    assert set(written) == want_keys
    restored = jax_checkpoint.restore(str(tmp_path), jax_state)
    flat = checkpoint.flatten(state)
    for (kp, leaf) in jax.tree_util.tree_leaves_with_path(restored):
        key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                       for p in kp)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key], err_msg=key)
    assert int(restored.step) == 7 and int(restored.opt.count) == 7


def test_manifest_keep_last_and_errors(tmp_path):
    state = port_target()
    for step in (5, 10, 15, 20):
        checkpoint.save(str(tmp_path), step, state._replace(step=step), keep=2)
    assert sorted(checkpoint.all_steps(str(tmp_path))) == [15, 20]
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f) == {"latest_step": 20}
    with open(tmp_path / "step_0000000020" / "meta.json") as f:
        assert json.load(f)["step"] == 20
    assert checkpoint.restore(str(tmp_path), state, step=15).step == 15
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), state)
    missing = dict(npz_keys(tmp_path / "step_0000000020"))
    missing.pop("opt/count")
    np.savez(tmp_path / "step_0000000020" / "arrays.npz", **missing)
    with pytest.raises(KeyError, match="opt/count"):
        checkpoint.restore(str(tmp_path), state)


def test_bf16_stored_as_f32_and_no_alias(tmp_path):
    """A bfloat16 leaf is written as float32 and restored into the target's
    bfloat16; the saved arrays are copies, not views of live parameters."""
    state = port_target()
    params = {**state.params, "lm_head": {"w": state.params["lm_head"]["w"].bfloat16()}}
    state = state._replace(params=params)
    flat = checkpoint.flatten(state)
    assert flat["params/lm_head/w"].dtype == np.float32
    assert not np.shares_memory(flat["params/layers/q"], state.params["layers"]["q"].numpy())
    checkpoint.save(str(tmp_path), 3, state)
    before = state.params["layers"]["q"].clone()
    state.params["layers"]["q"].add_(1.0)          # a live update after the save
    got = checkpoint.restore(str(tmp_path), state)
    assert got.params["lm_head"]["w"].dtype == torch.bfloat16
    assert torch.equal(got.params["lm_head"]["w"], params["lm_head"]["w"])
    assert torch.equal(got.params["layers"]["q"], before)
