"""The port's hybrid family (Mamba2 + one shared attention block, reduced
``zamba2_2p7b``) against the JAX package: SSM blocks, the hybrid forward
with and without a cache, selection, the rSVD sweep on (G, E) stacks, HPA,
the four deployment formats and ``ReferenceEngine`` serving a two-tier fused
bank.

Inputs come from numpy seeds (or JAX's own init, handed over through
``repro_torch.bridge`` as numpy arrays). The JAX side's Pallas kernels run in
interpret mode. Tolerances: the SSM blocks 1e-5 (f32, the same op order up
to einsum contraction order); logits and SLR factors 1e-4 (f32, longer sums
in other orders); the prefill + decode check 5e-2, as JAX's own
``test_decode_consistency`` (the prefill cache is bf16); token streams, block
lists, reports and byte counts exactly.
"""
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
from repro.core.hpa import hpa_keep_ratio as jax_hpa_keep_ratio
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.models import hybrid as jax_hybrid
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ReferenceEngine as JaxReferenceEngine
from repro.serving.slr_params import deployment_report as jax_deployment_report
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import sparse
from repro_torch.core.admm import SalaadConfig, admm_update
from repro_torch.core.hpa import hpa_keep_ratio
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.models import model as model_lib
from repro_torch.models import ssm
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
)
from repro_torch.serving.slr_params import SLRLinear, deployment_report

TOL = dict(atol=1e-4, rtol=1e-4)
SSM_TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "zamba2_2p7b"
PROMPTS = [[5, 7, 11], [3, 1], list(range(2, 20)), [8, 8, 2], [1, 2, 3, 4, 5, 6]]


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hyb():
    """Reduced zamba2 (12 layers = 2 groups of 6) with JAX's init and two
    exact-SVD sweeps, both sides; selection min_dim 16, as the launchers."""
    cfg = jax_get_arch(ARCH).reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16), exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    sweep = jax.jit(lambda p, s, step: jax_admm_update(p, s, blocks, scfg, step))
    for step in range(2):
        state, _ = sweep(params, state, step)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        cfg=cfg, tcfg=get_arch(ARCH).reduced(), params=params, state=state, blocks=blocks,
        tparams=tparams, tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams, SelectionConfig(min_dim=16)))


def test_reduced_config_matches_jax():
    got, want = get_arch(ARCH).reduced(), jax_get_arch(ARCH).reduced()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_chunk",
              "attn_every", "mlp_type", "norm_type", "rope_theta", "attn_q_block",
              "attn_kv_block", "kernel_impl"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.num_layers == 12 and got.param_dtype == torch.float32
    full = get_arch(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.ssm_state, full.attn_every,
            full.param_dtype) == (54, 2560, 10240, 64, 6, torch.bfloat16)


# ------------------------------------------------------------------- ssm ---


def ssm_inputs(seed, b=2, l=32, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, l, h, p), dtype=np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((b, l, h), dtype=np.float32) - 2)),
        a=-np.exp(rng.standard_normal(h).astype(np.float32) * 0.3),
        b_in=rng.standard_normal((b, l, n), dtype=np.float32),
        c_in=rng.standard_normal((b, l, n), dtype=np.float32),
        init=rng.standard_normal((b, h, p, n), dtype=np.float32),
    )


@pytest.mark.parametrize("chunk,init", [(8, False), (16, True), (32, True)])
def test_ssd_chunked_matches_jax(chunk, init):
    i = ssm_inputs(chunk)
    args = [i[k] for k in ("x", "dt", "a", "b_in", "c_in")]
    y, s = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                           init_state=torch.from_numpy(i["init"]) if init else None)
    wy, ws = jax_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                                 init_state=jnp.asarray(i["init"]) if init else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SSM_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), **SSM_TOL)


def test_ssd_chunked_rejects_a_ragged_chunk():
    i = ssm_inputs(0, l=24)
    with pytest.raises(ValueError, match="must divide chunk"):
        ssm.ssd_chunked(*(torch.from_numpy(i[k]) for k in ("x", "dt", "a", "b_in", "c_in")),
                        chunk=16)


@pytest.mark.parametrize("mode", ["chunked", "chunked_from_state", "recurrent"])
def test_ssm_block_matches_jax(mode):
    """The whole Mamba2 block: without a cache (chunked), from a cache's state
    and conv window (chunked), and one recurrent decode token."""
    d_model, expand, hd, n = 32, 2, 16, 16
    jparams = jax_ssm.init_ssm_layer(jax.random.PRNGKey(3), d_model, expand, hd, n,
                                     jnp.float32)
    jparams = {**jparams, "a_log": jnp.linspace(-0.5, 0.5, 4, dtype=jnp.float32),
               "norm_scale": jnp.linspace(-0.2, 0.2, 2 * d_model, dtype=jnp.float32)}
    tparams = bridge.params_from_numpy(to_numpy(jparams), "cpu")
    rng = np.random.default_rng(1)
    l = 1 if mode == "recurrent" else 32
    u = rng.standard_normal((2, l, d_model), dtype=np.float32)
    kw = dict(expand=expand, head_dim=hd, d_state=n, chunk=16)
    jcache = tcache = None
    if mode != "chunked":
        _, nh, conv_dim = ssm.ssm_dims(d_model, expand, hd, n)
        st = rng.standard_normal((2, nh, hd, n), dtype=np.float32)
        cv = rng.standard_normal((2, 3, conv_dim), dtype=np.float32)
        jcache = jax_ssm.SSMCache(jnp.asarray(st), jnp.asarray(cv), jnp.asarray(5, jnp.int32))
        tcache = ssm.SSMCache(torch.from_numpy(st), torch.from_numpy(cv), 5)
    y, c = ssm.ssm_block(tparams, torch.from_numpy(u), cache=tcache, **kw)
    wy, wc = jax_ssm.ssm_block(jparams, jnp.asarray(u), cache=jcache, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SSM_TOL)
    np.testing.assert_allclose(c.state.numpy(), np.asarray(wc.state), **SSM_TOL)
    np.testing.assert_allclose(c.conv.numpy(), np.asarray(wc.conv), **SSM_TOL)
    assert c.length == int(wc.length)


# ---------------------------------------------------------------- hybrid ---


def test_hybrid_forward_matches_jax(hyb):
    """No cache, then a 16-token prefill into a cache and four decode steps
    on it; the caches' states, windows and KV agree too."""
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    got, _ = model_lib._forward(hyb.tparams, {"tokens": torch.from_numpy(toks)}, hyb.tcfg)
    want, _, _ = jax_model._forward(hyb.params, {"tokens": jnp.asarray(toks)}, hyb.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    got, tc = model_lib.prefill(hyb.tparams, {"tokens": torch.from_numpy(toks[:, :16])},
                                hyb.tcfg, max_len=24, cache_dtype=torch.float32)
    jc = jax_hybrid.init_hybrid_cache(hyb.cfg, 2, 24, dtype=jnp.float32)
    want, jc, _ = jax_hybrid.forward(hyb.params, jnp.asarray(toks[:, :16]), hyb.cfg, cache=jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(16, 20):
        got, tc = model_lib.decode_step(hyb.tparams, torch.from_numpy(toks[:, i:i + 1]), tc,
                                        hyb.tcfg)
        want, jc = jax_model.decode_step(hyb.params, jnp.asarray(toks[:, i:i + 1]), jc, hyb.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for f in ("ssm_state", "conv", "k", "v"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   err_msg=f, **TOL)
    assert tc.length == int(jc.length) == 20


def test_prefill_then_decode_matches_forward(hyb):
    """JAX's ``test_decode_consistency`` on the port: prefill(T-1) into the
    default bf16 cache, the cache made f32, one decode step against the full
    forward's last token."""
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int64))
    full, _ = model_lib._forward(hyb.tparams, {"tokens": toks}, hyb.tcfg)
    _, cache = model_lib.prefill(hyb.tparams, {"tokens": toks[:, :15]}, hyb.tcfg, max_len=32)
    assert cache.k.dtype == torch.bfloat16
    cache = cache._replace(**{f: getattr(cache, f).float()
                              for f in ("ssm_state", "conv", "k", "v")})
    step, _ = model_lib.decode_step(hyb.tparams, toks[:, 15:], cache, hyb.tcfg)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(), atol=5e-2, rtol=5e-2)


def test_paged_entries_raise_for_the_hybrid(hyb):
    with pytest.raises(ValueError, match="KV-cache family"):
        model_lib.init_paged_cache(hyb.tcfg, 2, 8, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="KV-cache family"):
        model_lib.chunk_prefill_step(hyb.tparams, torch.zeros((1, 4), dtype=torch.long),
                                     torch.ones(1, dtype=torch.int32), None, hyb.tcfg)


# ------------------------------------------------------------- SALAAD core ---


def test_selection_matches_jax(hyb):
    got = [(b.name, b.shape, b.stack_dims, b.is_embedding) for b in hyb.tblocks]
    want = [(b.name, tuple(b.shape), tuple(b.stack_dims), b.is_embedding) for b in hyb.blocks]
    assert got == want
    names = {b.name: b.stack_dims for b in hyb.tblocks}
    assert names["ssm_layers/in_proj"] == (2, 6) and names["shared_attn/q"] == ()


def jax_sketches(blocks, state, step: int) -> dict:
    """The sketches JAX's ``admm_update`` draws at ``step`` (one sweep):
    fold_in(fold_in(PRNGKey(0), step), i), split per slice, fold_in(key, 0)."""
    out = {}
    for i, info in enumerate(blocks):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    jnp.asarray(step, jnp.int32)), i)
        keys = jax.random.split(key, info.num_blocks) if info.stack_dims else [key]
        r = state[info.name].p.shape[-1]
        out[info.name] = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(k, 0), (info.m, r), jnp.float32))
            [None] for k in keys]))
    return out


def test_rsvd_admm_update_matches_jax(hyb):
    """One randomized-SVD sweep from the two-sweep state, the port fed JAX's
    sketches, over the (2, 6) SSM stacks and the 2-D shared block: L as
    p @ vt, S dense (away from at most one swap per block at the COO cap's
    boundary), Y, alpha and beta."""
    jcfg = JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16))
    want, _ = jax_admm_update(hyb.params, hyb.state, hyb.blocks, jcfg, 2)
    got, _ = admm_update(hyb.tparams, hyb.tstate, hyb.tblocks,
                         SalaadConfig(selection=SelectionConfig(min_dim=16)), 2,
                         sketches=jax_sketches(hyb.blocks, hyb.state, 2))
    for info in hyb.tblocks:
        g, w = got[info.name], want[info.name]
        assert g.p.shape == tuple(w.p.shape)
        np.testing.assert_allclose((g.p @ g.vt).numpy(), np.asarray(w.p @ w.vt),
                                   err_msg=info.name, **TOL)
        gs = sparse.to_dense(g.s_coo).numpy().reshape(-1, info.n * info.m)
        ws = np.asarray(jax_sparse.to_dense(w.s_coo)).reshape(-1, info.n * info.m)
        bad = ~np.isclose(gs, ws, **TOL)
        assert bad.sum(axis=-1).max() <= 2, info.name
        for f in ("y", "alpha", "beta"):
            np.testing.assert_allclose(getattr(g, f).numpy(), np.asarray(getattr(w, f)),
                                       err_msg=f"{info.name} {f}", **TOL)


def test_sweep_in_slice_chunks_equals_one_batch(hyb, monkeypatch):
    """A stacked leaf swept in chunks of whole slices gives what one batch
    gives: the slices are independent blocks."""
    from repro_torch.core import admm as admm_mod

    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), exact_svd=True)
    whole, _ = admm_update(hyb.tparams, hyb.tstate, hyb.tblocks, scfg, 2)
    info = next(b for b in hyb.tblocks if b.name == "ssm_layers/in_proj")
    monkeypatch.setattr(admm_mod, "SWEEP_ELEMS", 5 * info.n * info.m)   # 3 chunks of 12
    chunked, _ = admm_update(hyb.tparams, hyb.tstate, hyb.tblocks, scfg, 2)
    for name in ("ssm_layers/in_proj", "ssm_layers/out_proj", "shared_attn/q"):
        a, b = whole[name], chunked[name]
        for f in ("p", "vt", "s_vals", "y", "z", "alpha", "beta"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(sparse.to_dense(a.s_coo), sparse.to_dense(b.s_coo),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_hpa_and_deployment_match_jax(hyb, keep):
    """HPA reports and truncated states, the deployment report, and every
    format's param_bytes and forward equal the JAX package's."""
    jstate, jrep = jax_hpa_keep_ratio(hyb.state, hyb.blocks, keep, 0.7)
    tstate, trep = hpa_keep_ratio(hyb.tstate, hyb.tblocks, keep, 0.7)
    assert trep == jrep
    for info in hyb.tblocks:
        np.testing.assert_array_equal(tstate[info.name].s_coo.idx.numpy(),
                                      np.asarray(jstate[info.name].s_coo.idx))
    assert deployment_report(hyb.tparams, tstate, hyb.tblocks) == \
        jax_deployment_report(hyb.params, jstate, hyb.blocks)
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3]], np.int32)
    for fmt in ("dense", "factored", "bsr", "fused"):
        got = DeployedModel.build(hyb.tcfg, hyb.tparams, tstate, hyb.tblocks, fmt=fmt,
                                  bsr_block=32)
        want = JaxDeployedModel.build(hyb.cfg, hyb.params, jstate, hyb.blocks, fmt=fmt,
                                      bsr_block=32)
        assert got.param_bytes() == want.param_bytes(), fmt
        np.testing.assert_allclose(got.forward(torch.from_numpy(toks)).numpy(),
                                   np.asarray(want.forward(jnp.asarray(toks))),
                                   err_msg=fmt, **TOL)


def test_fused_hybrid_sites(hyb):
    """The fused format serves the shared block's seven 2-D weights as
    per-matrix fused weights with both parts live, and materializes the
    (G, E) SSM projections."""
    dm = DeployedModel.build(hyb.tcfg, hyb.tparams, hyb.tstate, hyb.tblocks, fmt="fused",
                             bsr_block=32)
    shared = dm.params["shared_attn"]
    for k in ("q", "k", "v", "o", "gate", "up", "down"):
        lin = shared[k]
        assert isinstance(lin, SLRLinear) and lin.fuse and lin.s_stack is None
        assert lin.p.dim() == 2 and lin.p.shape[-1] > 0 and not lin.s_bsr.empty
    for k in ("in_proj", "out_proj"):
        leaf = dm.params["ssm_layers"][k]
        assert isinstance(leaf, torch.Tensor) and leaf.shape[:2] == (2, 6)


# --------------------------------------------------------------- serving ---


@pytest.fixture(scope="module")
def banks(hyb):
    return (JaxModelBank.build(hyb.cfg, hyb.params, hyb.state, hyb.blocks, (1.0, 0.5),
                               fmt="fused"),
            ModelBank.build(hyb.tcfg, hyb.tparams, hyb.tstate, hyb.tblocks, (1.0, 0.5),
                            fmt="fused"))


def serve(engine, prompts, max_new=6):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=max_new, tier=i % 2)
    return {r.uid: r.out_tokens for r in engine.run()}, engine.decode_calls


def test_reference_engine_streams_match_jax(banks):
    """Two tiers round-robin on two slots: token-identical greedy streams and
    equal decode-call counts; both tiers ran the unstacked SLR sites."""
    jbank, tbank = banks
    want = serve(JaxReferenceEngine(jbank, JaxEngineConfig(max_slots=2, max_len=32)), PROMPTS)
    got = serve(ReferenceEngine(tbank, EngineConfig(max_slots=2, max_len=32)), PROMPTS)
    assert got == want
    assert got[1] == sum(len(p) - 1 + 6 for p in PROMPTS)


@pytest.mark.parametrize("kw", [dict(kv_dtype="bfloat16"), dict(prefill_chunk=16),
                                dict(tier_policy="pressure"), dict(prefix_cache=True)])
def test_reference_engine_capability_errors_match_jax(banks, kw):
    """The same EngineConfigs fail in both packages' constructors, naming the
    same missing feature."""
    jbank, tbank = banks
    with pytest.raises(EngineCapabilityError) as got:
        ReferenceEngine(tbank, EngineConfig(**kw))
    with pytest.raises(Exception) as want:
        JaxReferenceEngine(jbank, JaxEngineConfig(**kw))
    assert type(want.value).__name__ == "EngineCapabilityError"

    def missing(e):
        return str(e.value).split("unavailable: ")[1].split(". Engine capabilities")[0]

    assert missing(got) == missing(want)
    assert '"engine": "ReferenceEngine"' in str(got.value)


def test_paged_engine_refuses_the_hybrid(banks):
    with pytest.raises(ValueError, match="use ReferenceEngine for ssm/hybrid/encdec"):
        PagedServingEngine(banks[1], EngineConfig())
