"""Multi-tenant adapter serving of the port (``serving/adapters.py`` and the
engine's adapter paths) against the JAX package, on the reduced Llama-60m.

Three adapters come from one SLR state after 2, 3 and 4 exact-SVD
``admm_update`` sweeps (the fixture pattern of ``tests/test_adapters.py``),
deployed on both sides from the same bridged parameters and states and
adapterized onto the first. The JAX side runs its Pallas kernels in interpret
mode, or its plain reference where the JAX dispatcher takes it off the TPU.

Exact: adapter reports, pool bytes, pool tables other than the truncated
factors, token streams and the swap, prefix-hit and tokens-by-adapter
counters. Tolerances: truncated factors f32 1e-4 (the HPA pass orders sums
differently); a one-adapter bank's logits against its ModelBank tier 1e-5
relative to the largest logit.
"""
from types import SimpleNamespace

import jax
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
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.selection import select_blocks
from repro_torch.models import model as model_lib
from repro_torch.serving.adapters import (
    AdapterBank,
    AdapterError,
    AdapterizedLinear,
    AdapterRegistry,
    adapterize,
)
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank, format_capability_table
from repro_torch.serving.engine import EngineConfig, PagedServingEngine, RequestRejected

FMTS = ("fused", "factored", "dense")
SHARED = [(7 * i + 3) % 256 for i in range(16)]          # a two-page system prompt
PROMPTS = [SHARED + [5, 7, 11], SHARED + [3, 1, 9, 4], [8, 8, 2, 6, 4],
           SHARED + [1, 2], SHARED + [5, 7, 11, 13, 17], [9, 9, 3]]
ASSIGN = [0, 1, 2, 0, 1, 2]


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
    for step in range(4):
        state, _ = sweep(params, state, step)
        if step >= 1:
            states.append(state)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    tstates = [bridge.slr_state_from_numpy(to_numpy(s), "cpu") for s in states]
    tcfg = get_arch("salaad_llama_60m").reduced()
    tblocks = select_blocks(tparams)
    deployed = {}
    for fmt in FMTS:
        jm = [JaxDeployedModel.build(cfg, params, s, blocks, fmt=fmt, bsr_block=32)
              for s in states]
        tm = [DeployedModel.build(tcfg, tparams, s, tblocks, fmt=fmt, bsr_block=32)
              for s in tstates]
        deployed[fmt] = SimpleNamespace(
            base=tm[0], adapters=[adapterize(tm[0], m) for m in tm],
            jbase=jm[0], jadapters=[jax_adapterize(jm[0], m) for m in jm])
    return SimpleNamespace(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                           states=states, tstates=tstates, blocks=blocks,
                           tblocks=tblocks, deployed=deployed)


def engines(d, kw, mode=None, max_resident=None):
    """The same AdapterBank on both sides, each behind its paged engine."""
    ecfg = dict(kw, adapters=True, max_resident_adapters=max_resident)
    eng = PagedServingEngine(AdapterBank(d.base, d.adapters, mode=mode), EngineConfig(**ecfg))
    jeng = JaxPagedServingEngine(JaxAdapterBank(d.jbase, d.jadapters, mode=mode),
                                 JaxEngineConfig(**ecfg, telemetry=True))
    return eng, jeng


def run(engine, prompts=PROMPTS, assign=ASSIGN, max_new=6):
    uids = [engine.submit(p, max_new_tokens=max_new, adapter=a)
            for p, a in zip(prompts, assign)]
    by_uid = {r.uid: list(r.out_tokens) for r in engine.run()}
    return [by_uid[u] for u in uids]


def run_single(cfg, model, prompts, max_new=6, **kw):
    eng = PagedServingEngine(ModelBank.single(cfg, model), EngineConfig(**kw))
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    by_uid = {r.uid: list(r.out_tokens) for r in eng.run()}
    return [by_uid[u] for u in uids]


def pooled_sites(tree):
    """(path, pooled site) pairs of a JAX or port tree, in path order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif type(node).__name__ == "AdapterizedLinear":
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


# ----------------------------------------------------------------- pool ---


@pytest.mark.parametrize("fmt", FMTS)
def test_pool_report_and_tables_match_jax(trained, fmt):
    """Materialized at two rows of three: reports, bytes and the pooled
    tables equal the JAX bank's."""
    d = trained.deployed[fmt]
    bank = AdapterBank(d.base, d.adapters, max_resident=2).materialize()
    jbank = JaxAdapterBank(d.jbase, d.jadapters, max_resident=2).materialize()
    assert bank.adapter_report() == jbank.adapter_report()
    assert bank.report() == jbank.report()
    n_sites = 8 if fmt == "dense" else 7        # dense pools the LM head too
    assert bank.adapter_report()["sites"] == n_sites and bank.adapter_report()["pool_bytes"] > 0
    got, want = pooled_sites(bank.params(0)), pooled_sites(jbank.params(0))
    assert len(got) == len(want) == n_sites
    for (_, lin), (_, jlin) in zip(got, want):
        assert (lin.fmt, lin.mode, lin.stacked, lin.layers, lin.shape) == \
            (jlin.fmt, jlin.mode, jlin.stacked, jlin.layers, tuple(jlin.shape))
        for field in ("w", "p", "vt"):
            a, b = getattr(lin, field), getattr(jlin, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype)
                tol = dict(atol=1e-4, rtol=1e-4) if field != "w" else dict(atol=1e-5, rtol=1e-5)
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        if fmt == "fused":
            for field in ("counts", "rows", "vals"):
                np.testing.assert_array_equal(getattr(lin.s_stack, field).numpy(),
                                              np.asarray(getattr(jlin.s_stack, field)))
        if fmt == "factored":
            np.testing.assert_array_equal(lin.s_coo.idx.numpy(), np.asarray(jlin.s_coo.idx))
            np.testing.assert_array_equal(lin.s_coo.values.numpy(),
                                          np.asarray(jlin.s_coo.values))


def test_adapterize_shares_the_base(trained):
    d = trained.deployed["fused"]
    a = d.adapters[2]
    assert a.params["embed"]["embedding"] is d.base.params["embed"]["embedding"]
    assert a.params["layers"]["q"] is not d.base.params["layers"]["q"]
    registry = AdapterRegistry(d.base)
    assert registry.name(registry.register(a)) == "adapter0"
    assert registry.site_paths == [f"layers/{k}" for k in
                                   ("down", "gate", "k", "o", "q", "up", "v")]
    with pytest.raises(AdapterError, match="non-site leaf"):
        registry.register(DeployedModel(d.base.cfg, {**a.params, "final_norm": {
            "norm_scale": a.params["final_norm"]["norm_scale"] + 1.0}}, "fused"))


# --------------------------------------------------------------- streams ---


@pytest.mark.parametrize("fmt,mode", [("fused", "batched"), ("fused", "grouped"),
                                      ("factored", "grouped")])
def test_mixed_streams_match_jax(trained, fmt, mode):
    """Three adapters over two pool rows with the prefix cache on: streams,
    swaps, prefix hits and tokens by adapter equal the JAX engine's."""
    d = trained.deployed[fmt]
    kw = dict(max_slots=4, max_len=64, block_size=8, prefix_cache=True)
    eng, jeng = engines(d, kw, mode=mode, max_resident=2)
    got, want = run(eng), run(jeng)
    assert got == want
    assert eng.bank.swaps == jeng.bank.swaps >= 1
    assert eng.adapter_swaps == int(jeng.metrics.counter_value(jeng.metrics.adapter_swaps))
    assert eng.prefix_hits == jeng.prefix_hits >= 1
    for aid in range(3):
        assert eng.adapter_tokens[aid] == int(jeng.metrics.counter_value(
            jeng.metrics.adapter_tokens, str(aid))) == 6 * ASSIGN.count(aid)
    assert eng.resident_adapters == 2
    assert set(eng._prefix_caches) == {0, 1, 2}
    if mode == "batched":                        # one decode call covers every adapter
        assert 0 < eng.decode_calls <= eng._steps


def test_chunked_prefill_streams_match_jax(trained):
    """Batched mode with chunked prefill (slot-indexed chunk calls)."""
    d = trained.deployed["fused"]
    kw = dict(max_slots=3, max_len=64, block_size=8, prefill_chunk=8)
    eng, jeng = engines(d, kw)
    prompts = [list(range(1, 20)), list(range(3, 15)), [4, 4, 4], list(range(30, 52))]
    assert run(eng, prompts, [2, 0, 1, 2]) == run(jeng, prompts, [2, 0, 1, 2])
    assert eng.chunk_calls > 0


@pytest.mark.parametrize("fmt", FMTS)
def test_single_adapter_bank_matches_modelbank_tier(trained, fmt):
    """A one-adapter bank serves its adapter's ModelBank tier: token-identical
    streams, and a forward's logits within 1e-5 of the tier's."""
    d = trained.deployed[fmt]
    kw = dict(max_slots=2, max_len=64, block_size=8)
    bank = AdapterBank(d.base, [d.adapters[1]])
    eng = PagedServingEngine(bank, EngineConfig(adapters=True, **kw))
    assert run(eng, PROMPTS[:3], [0, 0, 0]) == run_single(trained.tcfg, d.adapters[1],
                                                          PROMPTS[:3], **kw)
    tokens = torch.tensor([PROMPTS[0][:12], PROMPTS[1][:12]])
    params = bank.bind(np.zeros(2, np.int32) if bank.mode == "batched" else 0)
    got = model_lib._forward(params, {"tokens": tokens}, trained.tcfg)[0]
    want = model_lib._forward(d.adapters[1].params, {"tokens": tokens}, trained.tcfg)[0]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------------------- residency ---


def test_lru_swap_under_tight_capacity(trained):
    d = trained.deployed["fused"]
    bank = AdapterBank(d.base, d.adapters, max_resident=2).materialize()
    assert bank.capacity == 2 and bank.resident == [0, 1]
    q_pool = pooled_sites(bank.params(0))[4][1]
    before = q_pool.p.data_ptr()
    row, swapped = bank.acquire(2)
    assert swapped and bank.swaps == 1 and row == 0
    assert 2 in bank.resident and 0 not in bank.resident       # LRU victim: 0
    assert q_pool.p.data_ptr() == before                        # swapped in place
    want = AdapterBank(d.base, [d.adapters[2]]).materialize()
    torch.testing.assert_close(q_pool.p[:q_pool.layers],
                               pooled_sites(want.params(0))[4][1].p, rtol=0, atol=0)


def test_pinned_adapter_never_evicted(trained):
    d = trained.deployed["fused"]
    bank = AdapterBank(d.base, d.adapters, max_resident=2).materialize()
    bank.pin(0)
    bank.acquire(2)                      # evicts 1, not the pinned 0
    assert 0 in bank.resident and 1 not in bank.resident
    bank.pin(2)
    assert bank.acquire(1) == (None, False)     # every row pinned: defer
    bank.unpin(0)
    row, swapped = bank.acquire(1)
    assert row is not None and swapped


def test_engine_serves_more_adapters_than_rows(trained):
    """Three adapters in flight over two rows: the overflow request waits for
    a row and every stream equals its adapter's single-tenant run."""
    d = trained.deployed["fused"]
    kw = dict(max_slots=2, max_len=64, block_size=8)
    bank = AdapterBank(d.base, d.adapters)
    eng = PagedServingEngine(bank, EngineConfig(adapters=True, max_resident_adapters=2, **kw))
    got = run(eng, PROMPTS[:3], [0, 1, 2])
    assert bank.swaps >= 1
    for i in range(3):
        assert [got[i]] == run_single(trained.tcfg, d.adapters[i], [PROMPTS[i]], **kw)


def test_unregister_while_streaming_rejected(trained):
    d = trained.deployed["fused"]
    bank = AdapterBank(d.base, d.adapters)
    eng = PagedServingEngine(bank, EngineConfig(adapters=True, max_slots=2, max_len=32,
                                                block_size=8))
    eng.submit([1, 2, 3], max_new_tokens=8, adapter=1)
    eng.step()                                   # admitted: adapter 1 pinned
    with pytest.raises(AdapterError, match="streaming"):
        bank.unregister(1)
    eng.run()                                    # drained: unpinned
    bank.unregister(1)
    assert 1 not in bank.registry and 1 not in bank.resident


def test_unknown_adapter_rejected_after_unregister(trained):
    d = trained.deployed["fused"]
    bank = AdapterBank(d.base, d.adapters)
    eng = PagedServingEngine(bank, EngineConfig(adapters=True, max_slots=2, max_len=32,
                                                block_size=8))
    eng.submit([4, 5], max_new_tokens=3, adapter=2)
    bank.unregister(2)
    with pytest.raises(RequestRejected, match="unknown adapter"):
        eng.submit([1, 2], max_new_tokens=2, adapter=2)
    (gone,) = eng.run()                          # submitted before: finishes rejected
    assert gone.done and gone.out_tokens == []


def test_allocator_balanced_across_adapter_switches(trained):
    d = trained.deployed["fused"]
    eng = PagedServingEngine(AdapterBank(d.base, d.adapters), EngineConfig(
        adapters=True, max_slots=4, max_len=64, block_size=8, prefix_cache=True))
    total = eng.allocator.free_blocks
    for _ in range(2):
        run(eng)
        cached = sum(pc.pages for pc in eng._all_prefixes())
        assert eng.allocator.free_blocks + cached == total
    assert set(eng._prefix_caches) == set(ASSIGN)


# ------------------------------------------------------------ validation ---


def test_registry_rejects_bsr(trained):
    bsr = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstates[0],
                              trained.tblocks, fmt="bsr", bsr_block=32)
    with pytest.raises(AdapterError, match="bsr"):
        AdapterRegistry(bsr)
    with pytest.raises(AdapterError, match="batched"):
        AdapterBank(trained.deployed["factored"].base, mode="batched")


@pytest.mark.parametrize("kw", [dict(max_resident_adapters=4),
                                dict(adapters=True, max_resident_adapters=0)])
def test_config_validation(kw):
    with pytest.raises(ValueError, match="max_resident_adapters"):
        EngineConfig(**kw)


def test_bank_and_flag_must_agree(trained):
    d = trained.deployed["fused"]
    with pytest.raises(ValueError, match="AdapterBank"):
        PagedServingEngine(AdapterBank(d.base, d.adapters),
                           EngineConfig(max_slots=2, max_len=32, block_size=8))
    with pytest.raises(ValueError, match="AdapterBank"):
        PagedServingEngine(ModelBank.single(trained.tcfg, d.base),
                           EngineConfig(adapters=True, max_slots=2, max_len=32))


def test_adapter_kwarg_without_bank_rejected(trained):
    eng = PagedServingEngine(ModelBank.single(trained.tcfg, trained.deployed["fused"].base),
                             EngineConfig(max_slots=2, max_len=32))
    with pytest.raises(RequestRejected, match="AdapterBank"):
        eng.submit([1, 2], max_new_tokens=2, adapter=0)
    caps = PagedServingEngine.capabilities()["features"]
    assert caps["multi_tenant_adapters"] is True
    assert "multi_tenant_adapters" in format_capability_table({"paged": PagedServingEngine})


def test_pooled_site_needs_a_bind(trained):
    d = trained.deployed["fused"]
    bank = AdapterBank(d.base, d.adapters).materialize()
    lin = pooled_sites(bank.params(0))[0][1]
    assert isinstance(lin, AdapterizedLinear) and lin.sel is None
    with pytest.raises(RuntimeError, match="bind"):
        lin.at_layer(0).apply(torch.zeros((1, 1, lin.shape[0])))
