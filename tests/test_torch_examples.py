"""The port's examples (``repro_torch.examples``) run on the CPU at the JAX
examples' reduced configs with a few steps, and ``deploy_params`` against the
JAX package's on one SLR state.

Five steps, not the JAX examples' 40-120: with ``update_every=5`` the fifth
step runs the one ADMM sweep that gives the state live factors and S (the
serving demos then have SLR weights to serve). The training restart of
``train_100m_e2e`` (``--tiny``, three steps, a checkpoint at step 2) carried
on from its checkpoint must reach the uninterrupted run's state exactly: the
batches and sketches are pure functions of the step.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.examples import (
    elastic_deploy,
    multi_tenant_adapters,
    quickstart,
    serve_slr,
    train_100m_e2e,
)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart():
    out = quickstart.main(CPU, steps=5)
    assert set(out.losses) == {"dense", "surrogate", "hpa60"}
    assert all(math.isfinite(v) for v in out.losses.values())
    assert out.hpa["params_after"] > 0 and int(out.state.step) == 5


def test_elastic_deploy():
    out = elastic_deploy.main(CPU, steps=5)
    assert len(out.bank) == 3 and out.bank.shared_base_bytes() > 0
    assert sorted(r.tier for r in out.done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 6 for r in out.done)
    assert out.engine.stats_snapshot()["jit_retraces"] == 0
    params = [p for p, _ in out.sweep.values()]
    assert params == sorted(params, reverse=True)


def test_multi_tenant_adapters():
    out = multi_tenant_adapters.main(CPU, steps=5)
    assert [sorted(w) for w in out.waves] == [[0, 1, 2, 3], [2, 3, 4, 5]]
    assert all(len(t) == 6 for w in out.waves for t in w.values())
    assert out.report["swaps"] >= 3 and out.report["registered"] == 6
    assert out.engine.metrics.retraces() == 0


def test_serve_slr():
    out = serve_slr.main(CPU, steps=5)
    assert len(out.done) == 4 and len(out.spec_done) == 4
    assert all(len(r.out_tokens) == 6 for r in out.done + out.spec_done)
    assert out.kernel_err < 1e-5


def test_train_100m_e2e_restart_carries_on_exactly(tmp_path):
    out = train_100m_e2e.main(["--tiny", *CPU, "--ckpt-dir", str(tmp_path)], steps=3,
                              ckpt_every=2)
    assert int(out.state.step) == 3 and int(out.state2.step) == 2
    resumed = out.trainer2.fit(out.state2, out.data)
    assert int(resumed.step) == 3
    for name, a in out.state.params["layers"].items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, resumed.params["layers"][name]), name
    for name, blk in out.state.slr.items():
        assert torch.equal(blk.p, resumed.slr[name].p), name


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def test_deploy_params_matches_jax():
    """The dense ``X_hat = L + S`` params from one SLR state (a port ADMM
    sweep, handed to the JAX package as its own ``BlockSLR``), the JAX
    package's and the port's; other formats are refused in both."""
    import jax.numpy as jnp

    from repro.core import sparse as jax_sparse
    from repro.core.admm import BlockSLR as JaxBlockSLR
    from repro.core.selection import SelectionConfig as JaxSelectionConfig
    from repro.core.selection import select_blocks as jax_select_blocks
    from repro.serving.slr_params import deploy_params as jax_deploy_params
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.models import model as model_lib
    from repro_torch.serving.slr_params import deploy_params
    from repro_torch.tree import tree_leaves_with_path

    cfg = get_arch("salaad_llama_60m").reduced()
    params = model_lib.init_params(cfg, 0, "cpu")
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), rho_constant=5.0,
                        exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    state, _ = admm_update(params, state, blocks, scfg, 0)
    got = deploy_params(params, state, blocks)

    def j(t):
        return jnp.asarray(t.numpy())

    jstate = {name: JaxBlockSLR(
        p=j(b.p), vt=j(b.vt), s_vals=j(b.s_vals),
        s_coo=jax_sparse.CooMatrix(j(b.s_coo.values), j(b.s_coo.idx), b.s_coo.shape),
        y=j(b.y), z=j(b.z), alpha=j(b.alpha), beta=j(b.beta), rho=b.rho)
        for name, b in state.items()}
    jparams = _map(j, params)
    jblocks = jax_select_blocks(jparams, JaxSelectionConfig(min_dim=16))
    assert [b.name for b in jblocks] == [b.name for b in blocks]
    assert any(int((b.s_coo.idx >= 0).sum()) for b in state.values())
    want = dict(tree_leaves_with_path(_map(np.asarray, jax_deploy_params(jparams, jstate,
                                                                          jblocks))))
    have = dict(tree_leaves_with_path(got))
    assert sorted(have) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(have[path].numpy(), w, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="dense format only"):
        deploy_params(params, state, blocks, fmt="factored")
    with pytest.raises(AssertionError):
        jax_deploy_params(jparams, jstate, jblocks, fmt="factored")
