"""The port's slot-padded ``ServingEngine`` (``serving/engine.py``) and its
per-slot contiguous cache (``models/attention.py::contiguous_insert``)
against the JAX package, on the reduced Llama-60m.

The SLR state is the fixture pattern of ``tests/test_torch_serving.py``
(``init_slr_state`` plus exact-SVD ``admm_update`` sweeps on the JAX side),
bridged to the port as numpy arrays; the adapter bank's tenants are the
states after sweeps 1, 2 and 3, adapterized onto the first. Pallas kernels on
the JAX side run in interpret mode, or through their plain reference where
the JAX dispatcher takes it off the TPU.

Tolerances: f32 atol/rtol 1e-4 for logits and cache rows (the frameworks sum
in different orders); token streams, lengths, admission order, engine
counters and error messages must be equal exactly.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.admm import SalaadConfig as JaxSalaadConfig
from repro.core.admm import admm_update as jax_admm_update
from repro.core.admm import init_slr_state as jax_init_slr_state
from repro.models import model as jax_model
from repro.serving.adapters import AdapterBank as JaxAdapterBank
from repro.serving.adapters import adapterize as jax_adapterize
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineCapabilityError as JaxEngineCapabilityError
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.selection import select_blocks
from repro_torch.models import model as model_lib
from repro_torch.models.attention import KVCache, contiguous_insert
from repro_torch.serving.adapters import AdapterBank, adapterize
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    ServingEngine,
)

TOL = dict(atol=1e-4, rtol=1e-4)
BUDGETS = (1.0, 0.6, 0.3)
PROMPTS = [[5, 7, 11], [3, 1], list(range(2, 30)), [8, 8, 2], [1, 2, 3, 4, 5, 6],
           list(range(40, 53)), [9], [4, 4, 4, 4, 4, 4, 4, 4, 4]]
ECFG = dict(max_slots=3, max_len=64)
COUNTERS = ("evictions", "tier_switches", "downshift_ticks", "decode_calls", "prefill_calls")


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    sweep = jax.jit(lambda p, s, step: jax_admm_update(p, s, blocks, scfg, step))
    states = []
    for step in range(3):
        state, _ = sweep(params, state, step)
        states.append(state)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    tstates = [bridge.slr_state_from_numpy(to_numpy(s), "cpu") for s in states]
    tcfg = get_arch("salaad_llama_60m").reduced()
    tblocks = select_blocks(tparams)
    jm = [JaxDeployedModel.build(cfg, params, s, blocks, fmt="fused", bsr_block=32)
          for s in states]
    tm = [DeployedModel.build(tcfg, tparams, s, tblocks, fmt="fused", bsr_block=32)
          for s in tstates]
    return SimpleNamespace(
        cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
        bank=ModelBank.build(tcfg, tparams, tstates[-1], tblocks, BUDGETS, fmt="fused",
                             bsr_block=32),
        jbank=JaxModelBank.build(cfg, params, states[-1], blocks, BUDGETS, fmt="fused",
                                 bsr_block=32),
        base=tm[0], adapters=[adapterize(tm[0], m) for m in tm],
        jbase=jm[0], jadapters=[jax_adapterize(jm[0], m) for m in jm],
    )


def run(engine, prompts=PROMPTS, tiers=(None,), adapters=(None,), max_new=6,
        deadlines=None):
    """Submit every prompt (tiers and adapters round-robin), drive the engine
    to the end; the streams in submit order and the uids in finishing
    order."""
    uids = [engine.submit(p, max_new_tokens=max_new, tier=tiers[i % len(tiers)],
                          adapter=adapters[i % len(adapters)],
                          deadline=None if deadlines is None else deadlines[i])
            for i, p in enumerate(prompts)]
    done = engine.run()
    by_uid = {r.uid: list(r.out_tokens) for r in done}
    return [by_uid[u] for u in uids], [r.uid for r in done]


# ------------------------------------------------------------ the engine ---


def test_streams_match_jax_on_the_fused_bank(trained):
    """Three tiers of one fused bank, requests round-robin over them: the
    same streams, finishing order and counters as JAX's ServingEngine, and
    one prefill per tier group and one decode per active tier."""
    eng = ServingEngine(trained.bank, EngineConfig(**ECFG))
    jeng = JaxServingEngine(trained.jbank, JaxEngineConfig(**ECFG))
    tiers = tuple(range(len(BUDGETS)))
    got, order = run(eng, tiers=tiers)
    want, jorder = run(jeng, tiers=tiers)
    assert got == want and order == jorder
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.cache.k.shape == tuple(jeng.cache.k.shape)
    assert eng.cache.length.shape == (ECFG["max_slots"],)
    assert all(len(s) == 6 for s in got)


@pytest.mark.parametrize("mode", ["batched", "grouped"])
def test_adapter_bank_matches_jax(trained, mode):
    """An AdapterBank of three tenants over one base, two pool rows (LRU
    swaps): the same streams, swaps and tokens by adapter as JAX's
    ServingEngine, in both adapter modes."""
    kw = dict(ECFG, adapters=True, max_resident_adapters=2)
    eng = ServingEngine(AdapterBank(trained.base, trained.adapters, mode=mode),
                        EngineConfig(**kw))
    jeng = JaxServingEngine(JaxAdapterBank(trained.jbase, trained.jadapters, mode=mode),
                            JaxEngineConfig(**kw))
    assign = (0, 1, 2)
    got, _ = run(eng, adapters=assign)
    want, _ = run(jeng, adapters=assign)
    assert got == want
    assert eng.adapter_swaps == int(jeng.metrics.counter_value(jeng.metrics.adapter_swaps)) > 0
    for aid in assign:
        assert eng.adapter_tokens[aid] == int(jeng.metrics.counter_value(
            jeng.metrics.adapter_tokens, str(aid)))
    assert eng.decode_calls == jeng.decode_calls and eng.prefill_calls == jeng.prefill_calls


def test_streams_match_the_paged_engine(trained):
    """The port's two batched engines on one bank (static tiers, no prefix
    cache): token for token the same streams, on the CPU."""
    tiers = tuple(range(len(BUDGETS)))
    got, _ = run(ServingEngine(trained.bank, EngineConfig(**ECFG)), tiers=tiers)
    want, _ = run(PagedServingEngine(trained.bank, EngineConfig(**ECFG, block_size=8)),
                  tiers=tiers)
    assert got == want


def test_edf_admission_order_matches_jax(trained):
    """One slot, deadlines out of submit order (and none for some): both
    engines admit earliest deadline first, then FIFO, and finish in the
    same order."""
    dm, jdm = trained.bank, trained.jbank
    deadlines = [None, 5e9, 1e9, None, 3e9, 2e9, None, 4e9]
    kw = dict(max_slots=1, max_len=64)
    _, order = run(ServingEngine(dm, EngineConfig(**kw)), max_new=2, deadlines=deadlines)
    _, jorder = run(JaxServingEngine(jdm, JaxEngineConfig(**kw)), max_new=2,
                    deadlines=deadlines)
    assert order == jorder == [3, 6, 5, 8, 2, 1, 4, 7]


@pytest.mark.parametrize("kw", [dict(prefill_chunk=16), dict(prefix_cache=True),
                                dict(tier_policy="pressure"), dict(spec_k=2)],
                         ids=["prefill_chunk", "prefix_cache", "pressure", "spec_k"])
def test_capability_errors_match_jax(trained, kw):
    """What the slot-padded engine cannot give raises EngineCapabilityError
    with the JAX engine's message, up to the capabilities it appends (the
    port serves fewer families and no mesh)."""
    with pytest.raises(EngineCapabilityError) as got:
        ServingEngine(trained.bank, EngineConfig(**kw))
    with pytest.raises(JaxEngineCapabilityError) as want:
        JaxServingEngine(trained.jbank, JaxEngineConfig(**kw))
    head = str(got.value).split("Engine capabilities:")[0]
    assert head == str(want.value).split("Engine capabilities:")[0]
    assert '"engine": "ServingEngine"' in str(got.value)


def test_int8_and_hybrid_raise_as_in_jax(trained):
    """int8 KV needs the paged engine; a family without per-slot lengths
    needs the reference engine: the JAX engine's ValueErrors."""
    with pytest.raises(ValueError) as got:
        ServingEngine(trained.bank, EngineConfig(kv_dtype="int8"))
    with pytest.raises(ValueError) as want:
        JaxServingEngine(trained.jbank, JaxEngineConfig(kv_dtype="int8"))
    assert str(got.value) == str(want.value)
    hcfg = get_arch("zamba2_2p7b").reduced()
    hybrid = ModelBank.single(hcfg, model_lib.init_params(hcfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="KV-cache family"):
        ServingEngine(hybrid, EngineConfig())


# ------------------------------------------------------ per-slot cache ---


def _caches(trained, lens, s_len=16, seed=0):
    """The same random per-slot cache on both sides."""
    cfg = trained.cfg
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, len(lens), cfg.num_kv_heads, s_len, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jc = jax_model.init_cache(cfg, len(lens), s_len, dtype=jnp.float32)._replace(
        k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(lens))
    tc = model_lib.init_cache(trained.tcfg, len(lens), s_len, dtype=torch.float32,
                              device="cpu", per_slot=True)
    tc.k.copy_(torch.from_numpy(k))
    tc.v.copy_(torch.from_numpy(v))
    tc.length.copy_(torch.from_numpy(lens))
    return jc, tc


def test_per_slot_decode_matches_jax(trained):
    """Two decode steps over a per-slot cache whose rows sit at 3, 15 (its
    second write is dropped), 16 = max_len (both dropped) and 0: logits,
    rows and lengths as JAX's ``decode_step``; a dropped write leaves the
    row as it was."""
    jc, tc = _caches(trained, [3, 15, 16, 0])
    rng = np.random.default_rng(1)
    before = tc.k.clone()
    for _ in range(2):
        tok = rng.integers(0, trained.cfg.vocab_size, (4, 1)).astype(np.int32)
        jl, jc = jax_model.decode_step(trained.params, jnp.asarray(tok), jc, trained.cfg)
        tl, tc = model_lib.decode_step(trained.tparams, torch.from_numpy(tok).long(), tc,
                                       trained.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    np.testing.assert_array_equal(tc.length.numpy(), [5, 17, 18, 2])
    assert torch.equal(tc.k[:, 2], before[:, 2])
    assert torch.equal(tc.k[:, 1, :, :15], before[:, 1, :, :15])


def test_per_slot_multi_token_insert_matches_jax(trained):
    """Three tokens per row at once (rows at 2, 14: one kept, two dropped,
    13: the last position written, 16: all dropped): the forward's logits
    and rows as JAX's per-slot insert (``mode='drop'``) and attention."""
    jc, tc = _caches(trained, [2, 14, 13, 16], seed=2)
    tok = np.random.default_rng(3).integers(0, trained.cfg.vocab_size, (4, 3)).astype(np.int32)
    jl, jn, _ = jax_model._forward(trained.params, {"tokens": jnp.asarray(tok)}, trained.cfg,
                                   cache=jc, position_offset=jc.length)
    tl, tn = model_lib._forward(trained.tparams, {"tokens": torch.from_numpy(tok).long()},
                                trained.tcfg, cache=tc, position_offset=tc.length.long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tn.k.numpy(), np.asarray(jn.k), **TOL)
    np.testing.assert_allclose(tn.v.numpy(), np.asarray(jn.v), **TOL)
    np.testing.assert_array_equal(tn.length.numpy(), np.asarray(jn.length))


def test_contiguous_insert_drops_past_the_buffer():
    """The insert on its own: kept positions hold the new rows, dropped ones
    leave nothing behind, and a row whose last position is written keeps
    that write, however the dropped positions were aimed."""
    k = torch.zeros(4, 2, 8, 3)
    v = torch.zeros(4, 2, 8, 3)
    new = torch.arange(1, 4 * 2 * 3 * 3 + 1, dtype=torch.float32).reshape(4, 2, 3, 3)
    out = contiguous_insert(KVCache(k, v, torch.tensor([0, 6, 7, 8], dtype=torch.int32)),
                            new, -new)
    assert out.length.tolist() == [3, 9, 10, 11]
    want = torch.zeros(4, 2, 8, 3)
    want[0, :, 0:3] = new[0]
    want[1, :, 6:8] = new[1, :, :2]
    want[2, :, 7] = new[2, :, 0]
    assert torch.equal(k, want) and torch.equal(v, -want)


def test_prefill_rows_match_jax(trained):
    """One prefill call of a two-request group into slots 2 and 0, padded to
    three rows (the padded row carries slot_id == max_slots): the slots'
    rows and lengths as JAX's prefill program writes them, slot 1 untouched,
    and the same first tokens."""
    eng = ServingEngine(trained.bank, EngineConfig(**ECFG))
    jeng = JaxServingEngine(trained.jbank, JaxEngineConfig(**ECFG))
    eng.cache.k.normal_()
    jeng.cache = jeng.cache._replace(k=jnp.asarray(eng.cache.k.numpy()),
                                     length=jnp.asarray([0, 9, 0], jnp.int32))
    eng.cache.length.copy_(torch.tensor([0, 9, 0], dtype=torch.int32))
    tokens = np.zeros((3, 16), np.int32)
    tokens[0, :11] = np.arange(3, 14)
    tokens[1, :4] = [7, 1, 5, 2]
    lengths = np.array([11, 4, 1], np.int32)
    slot_ids = np.array([2, 0, 3], np.int32)
    rows = np.zeros((3,), np.int32)
    first = eng._prefill_call(0, tokens, lengths, slot_ids, rows)
    jfirst, jcache = jeng._prefill(jeng._tier_params[0], jnp.asarray(tokens),
                                   jnp.asarray(lengths), jnp.asarray(slot_ids), jeng.cache,
                                   jnp.asarray(1, jnp.int32))
    np.testing.assert_array_equal(first, np.asarray(jfirst))
    np.testing.assert_array_equal(eng.cache.length.numpy(), [4, 9, 11])
    np.testing.assert_array_equal(eng.cache.length.numpy(), np.asarray(jcache.length))
    np.testing.assert_allclose(eng.cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(eng.cache.v.numpy(), np.asarray(jcache.v), **TOL)
