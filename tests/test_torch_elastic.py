"""HPA tiers, the ModelBank, the tier controller, the prefix cache and the
paged engine's tier, pressure and prefix paths of the port, against the JAX
package on the reduced Llama-60m.

The SLR state is the fixture pattern of ``tests/test_torch_serving.py``
(``init_slr_state`` plus two exact-SVD ``admm_update`` sweeps on the JAX
side), bridged to the port as numpy arrays. Pallas kernels on the JAX side run
in interpret mode, as the JAX package's own tests run them.

Tolerances: f32 atol/rtol 1e-4 for truncated factors (the two sides multiply
in different orders); reports, byte counts, controller trajectories, token
streams and engine counters must be equal exactly.
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
from repro.core.hpa import hpa_keep_ratio as jax_hpa_keep_ratio
from repro.models import model as jax_model
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.elastic import TierController as JaxTierController
from repro.serving.elastic import TierControllerConfig as JaxTierControllerConfig
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import ReferenceEngine as JaxReferenceEngine
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serving.engine import BlockAllocator as JaxBlockAllocator
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import sparse
from repro_torch.core.hpa import hpa_keep_ratio
from repro_torch.core.selection import select_blocks
from repro_torch.serving.elastic import ModelBank, TierController, TierControllerConfig
from repro_torch.serving.engine import (
    BlockAllocator,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    RequestRejected,
)
from repro_torch.serving.prefix_cache import PrefixCache

TOL = dict(atol=1e-4, rtol=1e-4)
BUDGETS = (1.0, 0.6, 0.3)
COUNTERS = ("evictions", "tier_switches", "downshift_ticks", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "reattached_pages")


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    sweep = jax.jit(lambda p, s, step: jax_admm_update(p, s, blocks, scfg, step))
    for step in range(2):
        state, _ = sweep(params, state, step)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        cfg=cfg, tcfg=get_arch("salaad_llama_60m").reduced(), params=params,
        state=state, blocks=blocks, tparams=tparams,
        tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams),
    )


def banks(trained, fmt, kernel_impl="dense", budgets=BUDGETS):
    tcfg = dataclasses.replace(trained.tcfg, kernel_impl=kernel_impl)
    jcfg = dataclasses.replace(trained.cfg, kernel_impl=kernel_impl)
    bank = ModelBank.build(tcfg, trained.tparams, trained.tstate, trained.tblocks,
                           budgets, fmt=fmt, bsr_block=32)
    jbank = JaxModelBank.build(jcfg, trained.params, trained.state, trained.blocks,
                               budgets, fmt=fmt, bsr_block=32)
    return bank, jbank


# -------------------------------------------------------------------- HPA ---


@pytest.mark.parametrize("keep", BUDGETS)
def test_hpa_keep_ratio_matches_jax(trained, keep):
    got, rep = hpa_keep_ratio(trained.tstate, trained.tblocks, keep, 0.7)
    want, jrep = jax_hpa_keep_ratio(trained.state, trained.blocks, keep, 0.7)
    assert rep == jrep
    for info in trained.tblocks:
        g, w = got[info.name], want[info.name]
        np.testing.assert_allclose((g.p @ g.vt).numpy(), np.asarray(w.p @ w.vt), **TOL)
        np.testing.assert_array_equal(sparse.to_dense(g.s_coo).numpy(),
                                      np.asarray(jax_sparse.to_dense(w.s_coo)))
        np.testing.assert_array_equal(g.s_vals.numpy(), np.asarray(w.s_vals))
    if keep < 1.0:
        assert rep["removed"] > 0


# ------------------------------------------------------------------- bank ---


@pytest.mark.parametrize("fmt", ["fused", "factored", "bsr"])
def test_bank_report_matches_jax(trained, fmt):
    bank, jbank = banks(trained, fmt)
    assert bank.report() == jbank.report()
    for tier, jtier in zip(bank, jbank):
        assert tier.model.param_bytes() == jtier.model.param_bytes()
    assert bank.shared_base_bytes() > 0
    # untouched leaves are one tensor object in every tier
    heads = {id(t.params["lm_head"]["w"]) for t in bank}
    assert len(heads) == 1


def test_bank_resolves_tiers_like_jax(trained):
    bank, jbank = banks(trained, "factored")
    for t in (0, 2, -1, -3):
        assert bank.resolve(t) == jbank.resolve(t)
    for t in (3, -4):
        with pytest.raises(ValueError, match="out of range"):
            bank.resolve(t)
    with pytest.raises(ValueError, match="duplicate"):
        ModelBank.build(trained.tcfg, trained.tparams, trained.tstate, trained.tblocks,
                        (0.5, 0.5))
    assert len(ModelBank.single(trained.tcfg, trained.tparams)) == 1


def test_tier_controller_trajectory_matches_jax():
    frees = [0.9, 0.5, 0.2, 0.05, 0.0, 0.0, 0.0, 0.1, 0.3, 0.6, 0.8, 0.9, 0.95, 0.95, 0.4]
    for cfg in (dict(), dict(target_free_frac=0.4, gain=2.0, ema=0.2)):
        ctl = TierController(3, TierControllerConfig(**cfg))
        jctl = JaxTierController(3, JaxTierControllerConfig(**cfg))
        got = [ctl.update(f) for f in frees]
        assert got == [jctl.update(f) for f in frees]
        assert got[0] == 0 and max(got) == 2 and got[-1] < 2


def test_prefix_cache_matches_jax():
    """The copied radix index against the JAX one: match, publish with
    duplicates, reclaim order and the reclaimable count."""
    alloc, jalloc = BlockAllocator(12), JaxBlockAllocator(12)
    pc, jpc = PrefixCache(alloc, 2), JaxPrefixCache(jalloc, 2)
    for a, c in ((alloc, pc), (jalloc, jpc)):
        c.publish([1, 2, 3, 4, 5, 6], a.alloc(3))
        c.publish([1, 2, 3, 4, 9, 9], a.alloc(3))     # two duplicates released
        held = a.alloc(1)
        c.publish([7, 7], held)
        a.share(held)                                 # attached elsewhere
    for tokens in ([1, 2, 3, 4, 5, 6, 8], [1, 2, 9], [7, 7], [3]):
        assert pc.match(tokens) == jpc.match(tokens)
    assert (pc.pages, pc.reclaimable_pages) == (jpc.pages, jpc.reclaimable_pages)
    assert pc.reclaim(2) == jpc.reclaim(2)
    assert (alloc.free_blocks, pc.pages) == (jalloc.free_blocks, jpc.pages)
    assert pc.reclaim(10) == jpc.reclaim(10)
    assert pc.match([7, 7]) == jpc.match([7, 7])


# ----------------------------------------------------------------- engine ---


def run_both(trained, fmt, kernel_impl, kw, requests, max_new, budgets=BUDGETS):
    """The same bank and requests through the port's engine and the JAX
    engine; returns both engines after checking streams and counters."""
    bank, jbank = banks(trained, fmt, kernel_impl, budgets)
    eng = PagedServingEngine(bank, EngineConfig(**kw))
    jeng = JaxPagedServingEngine(jbank, JaxEngineConfig(**kw))
    streams = []
    for e in (eng, jeng):
        for prompt, tier in requests:
            e.submit(prompt, max_new_tokens=max_new, tier=tier)
        streams.append({r.uid: (r.tier, r.out_tokens) for r in e.run()})
    assert streams[0] == streams[1]
    assert len(streams[0]) == len(requests)
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.allocator.used_blocks == jeng.allocator.used_blocks
    return eng, jeng, streams[0]


def prompts(seed, lens, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(0, 256, n).tolist() for n in lens]


def test_pinned_tier_streams_match_jax(trained):
    """Requests pinned to each tier of a three-tier bank, chunked prefill:
    each tier decodes in its own call over the shared cache."""
    reqs = [(p, i % 3) for i, p in enumerate(prompts(0, [5, 30, 12, 3, 21, 9]))]
    kw = dict(max_slots=4, max_len=64, block_size=8, prefill_chunk=16)
    eng, _, streams = run_both(trained, "factored", "dense", kw, reqs, 6)
    assert eng.tier_switches == 0 and eng.chunk_calls > 0
    assert {tier for tier, _ in streams.values()} == {0, 1, 2}


def test_pressure_policy_matches_jax(trained):
    """Round-robin tiers on a tight pool under tier_policy='pressure': the
    controller downshifts (and switches slots' tiers) before eviction."""
    reqs = [(p, i % 3) for i, p in enumerate(prompts(1, [14, 6, 22, 9, 17, 4, 11]))]
    kw = dict(max_slots=3, max_len=48, block_size=4, num_blocks=20, prefill_chunk=8,
              tier_policy="pressure")
    eng, _, _ = run_both(trained, "factored", "dense", kw, reqs, 12)
    assert eng.downshift_ticks > 0 and eng.tier_switches > 0


def test_prefix_cache_streams_match_jax_and_cache_off(trained):
    """A shared two-page prefix, an exact repeat of a page-aligned prompt
    (copy-on-write) and a pool tight enough to evict, so a resumed request
    reattaches its published pages. Streams equal the JAX engine's, and the
    same engine with the cache off."""
    shared = prompts(2, [16])[0]
    ps = prompts(3, [12, 16, 2], prefix=shared)
    reqs = [(p, 0) for p in ps] + [(ps[1], 0)]     # ps[1] is 32 tokens: page-aligned
    kw = dict(max_slots=2, max_len=64, block_size=8, num_blocks=9, decode_reserve=1,
              prefix_cache=True)
    eng, _, streams = run_both(trained, "factored", "dense", kw, reqs, 12)
    assert eng.prefix_hits > 0 and eng.cow_copies > 0
    assert eng.reattached_pages > 0 and eng.evictions > 0
    off = PagedServingEngine(banks(trained, "factored", budgets=(1.0,))[0],
                             EngineConfig(**{**kw, "prefix_cache": False}))
    for p, tier in reqs:
        off.submit(p, max_new_tokens=12, tier=tier)
    assert {r.uid: (r.tier, r.out_tokens) for r in off.run()} == streams


def test_oneshot_pallas_prefill_matches_jax(trained):
    """One-shot prefill under kernel_impl='pallas' (the flash attention path)
    with the prefix cache on, over a fused two-tier bank; the JAX side runs
    the Pallas kernels in interpret mode."""
    shared = prompts(4, [16])[0]
    ps = prompts(5, [7, 16, 2], prefix=shared)
    reqs = [(p, i % 2) for i, p in enumerate(ps + [ps[1]])]
    kw = dict(max_slots=2, max_len=64, block_size=8, prefix_cache=True)
    bank, jbank = banks(trained, "fused", "pallas", budgets=(1.0, 0.5))
    eng = PagedServingEngine(bank, EngineConfig(**kw))
    jeng = JaxPagedServingEngine(jbank, JaxEngineConfig(**kw))
    streams = []
    for e in (eng, jeng):
        for prompt, tier in reqs:
            e.submit(prompt, max_new_tokens=5, tier=tier)
        streams.append({r.uid: r.out_tokens for r in e.run()})
    assert streams[0] == streams[1]
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.prefill_calls > 0 and eng.chunk_calls > 0 and eng.cow_copies > 0


def test_bsr_streams_match_jax(trained):
    """The bsr format (unrolled layers, low-rank + block-CSC kernels on the
    JAX side in interpret mode) with chunked prefill, on a one-tier bank:
    tiers are format-blind and tested above."""
    reqs = [(p, 0) for p in prompts(6, [6, 19, 3])]
    kw = dict(max_slots=3, max_len=48, block_size=8, prefill_chunk=16)
    eng, _, _ = run_both(trained, "bsr", "pallas", kw, reqs, 4, budgets=(0.6,))
    assert isinstance(eng.params["layers"], list)


def test_submit_rejects_unknown_tier(trained):
    bank, _ = banks(trained, "factored")
    eng = PagedServingEngine(bank, EngineConfig(max_slots=2, max_len=32, block_size=8))
    with pytest.raises(RequestRejected, match="out of range"):
        eng.submit([1, 2], tier=3)
    eng.submit([1, 2], tier=-1)                   # counts from the cheap end
    assert eng._queue[-1].tier == 2
    with pytest.raises(TypeError, match="ModelBank"):
        PagedServingEngine(trained.tparams)


# ------------------------------------------------------------ tier knobs ---


@pytest.mark.parametrize("default_tier", [1, -1])
@pytest.mark.parametrize("engine", ["paged", "reference"])
def test_default_tier_streams_match_jax(trained, engine, default_tier):
    """``EngineConfig(default_tier=...)``: requests submitted with tier=None
    serve on that tier, explicit tiers keep theirs; streams, request tiers
    and the engines' counters equal the JAX engine's."""
    reqs = [(p, None if i % 3 else 0) for i, p in enumerate(prompts(7, [5, 13, 8, 3, 10]))]
    kw = dict(max_slots=2, max_len=48, block_size=8, default_tier=default_tier)
    bank, jbank = banks(trained, "factored")
    if engine == "paged":
        eng = PagedServingEngine(bank, EngineConfig(**kw))
        jeng = JaxPagedServingEngine(jbank, JaxEngineConfig(**kw))
        counters = COUNTERS + ("decode_calls", "prefill_calls")
    else:
        eng = ReferenceEngine(bank, EngineConfig(**kw))
        jeng = JaxReferenceEngine(jbank, JaxEngineConfig(**kw))
        counters = ("decode_calls",)
    streams = []
    for e in (eng, jeng):
        for prompt, tier in reqs:
            e.submit(prompt, max_new_tokens=5, tier=tier)
        streams.append({r.uid: (r.tier, r.out_tokens) for r in e.run()})
    assert streams[0] == streams[1]
    want_default = bank.resolve(default_tier)
    assert [streams[0][i + 1][0] for i in range(len(reqs))] == [
        want_default if tier is None else tier for _, tier in reqs]
    for name in counters:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.params is eng._tier_params[want_default]


def test_pressure_gain_and_ema_match_jax(trained):
    """The pressure controller built from ``tier_target_free``, ``tier_gain``
    and ``tier_ema`` (the JAX package's own tight-pool case): downshift
    ticks, tier switches, streams and the controller's state equal JAX's."""
    reqs = [([1 + i, 2, 3], 0) for i in range(3)]
    kw = dict(max_slots=3, max_len=64, block_size=8, num_blocks=9, tier_policy="pressure",
              tier_target_free=0.4, tier_gain=8.0, tier_ema=0.0)
    eng, jeng, _ = run_both(trained, "factored", "dense", kw, reqs, 10)
    assert eng.tier_controller.cfg == TierControllerConfig(
        target_free_frac=0.4, gain=8.0, ema=0.0)
    assert eng.downshift_ticks > 0 and eng.tier_switches > 0
    assert (eng.tier_controller.shift_f, eng.tier_controller.free_ema) == (
        jeng.tier_controller.shift_f, jeng.tier_controller.free_ema)


@pytest.mark.parametrize("kw,field", [
    (dict(tier_gain=0.0), "tier_gain"),
    (dict(tier_ema=1.0), "tier_ema"),
    (dict(tier_target_free=1.0), "tier_target_free"),
    (dict(default_tier=3), "default_tier"),
])
def test_tier_knob_validation_matches_jax(trained, kw, field):
    """Bad tier knobs raise a ValueError naming the field, as in JAX: the
    controller's at ``EngineConfig`` construction, a default tier the bank
    does not have at the engine's (both engines)."""
    bank, jbank = banks(trained, "factored")
    errors = []
    for config, engines, b in (
            (EngineConfig, (PagedServingEngine, ReferenceEngine), bank),
            (JaxEngineConfig, (JaxPagedServingEngine, JaxReferenceEngine), jbank)):
        for engine in engines:
            with pytest.raises(ValueError, match=field) as info:
                engine(b, config(max_slots=2, max_len=32, block_size=8, **kw))
            errors.append(str(info.value))
    assert errors[:2] == errors[2:]
