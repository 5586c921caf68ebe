"""Full-width salaad_llama_60m: the port's ``fused`` forward (plain versions
of the kernels, on the CPU) against the JAX package's ``factored``
``DeployedModel.forward`` (the XLA path, held equal to ``fused`` by
tests/test_fused_slr.py), on the same weights and SLR state.

The state is drawn from a numpy seed at the shapes ``init_slr_state`` gives
(rank cap 128, S at the 15% COO capacity with a few empty slots) rather than
trained, which keeps the test to seconds. The embedding is left out of the
selection on both sides for the same reason. Tolerance: f32 atol/rtol 1e-3,
since 8 layers of 512-wide sums in different orders accumulate more rounding
than the reduced model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.admm import SalaadConfig as JaxSalaadConfig
from repro.core.admm import init_slr_state as jax_init_slr_state
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.models import model as jax_model
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.serving.deployed import DeployedModel


def random_state(state, rng):
    """Fill a zero JAX SLR state with seeded values of its own shapes."""
    out = {}
    for name, blk in state.items():
        p, vt, cap = blk.p.shape, blk.vt.shape, blk.s_coo.values.shape
        n, m = blk.s_coo.shape
        idx = np.stack([rng.permutation(n * m)[: cap[-1]] for _ in range(cap[0])])
        idx[:, ::97] = -1                                   # some empty slots
        vals = np.where(idx >= 0, rng.standard_normal(cap) * 0.02, 0).astype(np.float32)
        s_vals = np.sort(rng.random(p[:-2] + p[-1:]), axis=-1)[..., ::-1].astype(np.float32)
        out[name] = dataclasses.replace(
            blk,
            p=jnp.asarray(rng.standard_normal(p).astype(np.float32) * 0.05),
            vt=jnp.asarray(rng.standard_normal(vt).astype(np.float32) * 0.05),
            s_vals=jnp.asarray(s_vals),
            s_coo=dataclasses.replace(blk.s_coo, values=jnp.asarray(vals),
                                      idx=jnp.asarray(idx.astype(np.int32))),
        )
    return out


def test_fused_forward_matches_jax_factored_at_full_width():
    cfg = jax_get_arch("salaad_llama_60m")
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (8, 512, 1376, 32000)
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(exact_svd=True,
                           selection=JaxSelectionConfig(include_embedding=False))
    state, blocks = jax_init_slr_state(params, scfg)
    state = random_state(state, np.random.default_rng(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = JaxDeployedModel.build(cfg, params, state, blocks, fmt="factored")
    want = np.asarray(want.forward(jnp.asarray(toks)))

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    tparams = bridge.params_from_numpy(to_np(params), "cpu")
    tstate = bridge.slr_state_from_numpy(to_np(state), "cpu")
    tblocks = select_blocks(tparams, SelectionConfig(include_embedding=False))
    assert [b.name for b in tblocks] == [b.name for b in blocks]
    dm = DeployedModel.build(get_arch("salaad_llama_60m"), tparams, tstate, tblocks,
                             fmt="fused")
    gate = dm.params["layers"]["gate"]
    assert gate.fuse and gate.s_stack.block_size == 32 and gate.p.shape[-1] == 128
    got = dm.forward(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).all()
