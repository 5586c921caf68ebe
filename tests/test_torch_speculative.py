"""Elastic self-speculative decoding in the port (``serving/speculative.py``)
against the JAX package, on the reduced Llama-60m: the target is the JAX
package's ``init_params`` at seed 0, the draft either the same weights
(identical) or seed 7's (independent, agreeing with the target on almost
nothing), both carried across by ``repro_torch.bridge``.

Greedy streams must equal the port's non-speculative paged engine's and the
JAX ``SpeculativeEngine``'s token for token, with the same decode calls and
accepted tokens. Rejection sampling is held by distribution with fixed keys
(20000 keyed draws, 0.01 absolute per class).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as jax_model
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.speculative import SpecController as JaxSpecController
from repro.serving.speculative import SpeculativeEngine as JaxSpeculativeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.serving.adapters import AdapterBank, adapterize
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    gumbel_argmax,
)
from repro_torch.serving.speculative import SpecController, SpeculativeEngine, rejection_sample

PROMPTS = [[5, 7, 11], [3, 1], [2, 9, 4, 6], [8, 8, 2], [1, 2, 3, 4, 5, 6], [9, 1]]
BASE = dict(max_slots=2, max_len=32, block_size=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    other = jax_model.init_params(jcfg, jax.random.PRNGKey(7))
    to_t = lambda p: bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")  # noqa: E731
    return dict(jcfg=jcfg, tcfg=get_arch("salaad_llama_60m").reduced(),
                jax={"target": params, "identical": params, "independent": other},
                torch={"target": to_t(params), "identical": None, "independent": to_t(other)})


def _bank(tiny, draft, cfg=None):
    t = tiny["torch"]
    return ModelBank(cfg or tiny["tcfg"], [t["target"], t[draft] or t["target"]])


def _streams(engine, prompts=PROMPTS, max_new=5):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    return {r.uid: r.out_tokens for r in engine.run()}


@pytest.fixture(scope="module")
def paged_streams(tiny):
    return _streams(PagedServingEngine(ModelBank.single(tiny["tcfg"], tiny["torch"]["target"]),
                                       EngineConfig(**BASE)))


# ------------------------------------------------------- rejection sampling ---


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identical_dists_accept_all(seed):
    rng = np.random.default_rng(seed)
    s, k, v = 6, 4, 16
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((s, k, v), dtype=np.float32)), -1)
    drafts = torch.from_numpy(rng.integers(0, v, (s, k)))
    out, a = rejection_sample((seed, 3, 6), drafts, probs, probs)
    assert torch.equal(a, torch.full((s,), k))
    assert torch.equal(out, drafts)


def test_prefix_structure():
    """``out[:, :a]`` are the drafts, ``out[:, a]`` the corrective token, zeros
    past it; a draft that q gives no mass is always rejected."""
    rng = np.random.default_rng(4)
    s, k, v = 64, 4, 8
    p = torch.softmax(torch.from_numpy(rng.standard_normal((s, k, v), dtype=np.float32)), -1)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((s, k, v), dtype=np.float32)), -1)
    drafts = torch.from_numpy(rng.integers(0, v, (s, k)))
    q[torch.arange(s), 2, drafts[:, 2]] = 0.0          # position 2 can never accept
    out, a = rejection_sample((0, 1, 6), drafts, p, q)
    assert int(a.max()) <= 2 and int(a.min()) >= 0
    for i in range(s):
        n = int(a[i])
        assert torch.equal(out[i, :n], drafts[i, :n])
        assert bool((out[i, n + 1:] == 0).all())
        assert 0 <= int(out[i, n]) < v


def test_emitted_matches_target_distribution():
    """A draft p far from q (95% of its mass on a class q rarely picks),
    proposals drawn from p: the first emitted token's frequencies over 20000
    slots match q within 0.01."""
    v, n = 8, 20000
    q = torch.softmax(torch.tensor([1.5, -0.3, 0.0, 2.2, -1.7, 0.8, 0.4, -0.9]), -1)
    p = torch.softmax(torch.tensor([-2.0, -2.0, -2.0, -2.0, 3.0, -2.0, -2.0, -2.0]), -1)
    drafts = torch.stack([gumbel_argmax(p.log().expand(n, v), 1.0, (5, 1, i), torch.arange(n))
                          for i in range(2)], dim=1)
    out, _ = rejection_sample((0, 9, 4), drafts, p.expand(n, 2, v), q.expand(n, 2, v))
    freq = torch.bincount(out[:, 0], minlength=v).float() / n
    assert float((freq - q).abs().max()) <= 0.01


def test_spec_controller_follows_jax():
    seq = [1.0, 0.9, 0.2, 0.0, 0.0, 0.5, 1.0, 1.0, 0.1, 0.7, 0.3, 0.0, 0.0, 0.0, 1.0]
    for k_init, k_max, k_min in ((4, 8, 1), (6, 6, 2), (3, 3, 1)):
        got, want = SpecController(k_init, k_max, k_min), JaxSpecController(k_init, k_max, k_min)
        for rate in seq:
            assert got.update(rate) == want.update(rate)
            assert got.k_f == want.k_f and got.accept_ema == want.accept_ema


# ----------------------------------------------------------------- engine ---


@pytest.mark.parametrize("draft", ["identical", "independent"])
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_greedy_streams_match_paged_and_jax(tiny, paged_streams, mode, draft):
    """Both schedules, both drafts, mid-stream admissions (six requests over
    two slots): the streams equal the paged engine's and JAX's speculative
    engine's, with JAX's decode calls and accepted tokens; the sequential
    schedule accepts every token of an identical draft."""
    kw = dict(BASE, spec_k=4, spec_draft_mode=mode)
    eng = SpeculativeEngine(_bank(tiny, draft), EngineConfig(**kw))
    got = _streams(eng)
    j = tiny["jax"]
    jeng = JaxSpeculativeEngine(JaxModelBank(tiny["jcfg"], [j["target"], j[draft]]),
                                JaxEngineConfig(**kw))
    assert got == paged_streams == _streams(jeng)
    assert eng.decode_calls == jeng.decode_calls
    assert eng.accepted_tokens == jeng.accepted_tokens
    assert eng.drafted_tokens == jeng.drafted_tokens
    assert eng.allocator.used_blocks == 0
    if mode == "sequential" and draft == "identical":
        assert eng.acceptance_rate == 1.0
        assert eng.decode_calls < sum(map(len, got.values())) / 2
    if draft == "independent":
        assert eng.acceptance_rate < 0.3


@pytest.mark.parametrize("policy", ["longest_remaining", "lru"])
def test_eviction_preserves_streams(tiny, policy):
    """A pool that forces evictions: the resume re-prefills both caches and
    the streams equal the paged engine's; every block comes back."""
    prompts = [[5, 7, 11], [3, 1, 4]]
    ref = _streams(PagedServingEngine(ModelBank.single(tiny["tcfg"], tiny["torch"]["target"]),
                                      EngineConfig(max_slots=2, max_len=16, block_size=4)),
                   prompts, 10)
    eng = SpeculativeEngine(_bank(tiny, "independent"), EngineConfig(
        max_slots=2, max_len=16, block_size=4, num_blocks=4, decode_reserve=1,
        evict_policy=policy, spec_k=3))
    assert _streams(eng, prompts, 10) == ref
    assert eng.evictions >= 1
    assert eng.allocator.used_blocks == 0


@pytest.mark.parametrize("pools", [dict(kv_dtype="int8"),
                                   dict(kv_dtype="int8", spec_draft_kv_dtype="int8"),
                                   dict(spec_draft_kv_dtype="int8")],
                         ids=["int8-target", "int8-both", "int8-draft"])
def test_int8_pages(tiny, pools):
    """Int8 target pages: the streams equal the int8 paged engine's; int8
    draft pools (with their scale pools) change nothing greedy emits."""
    kv = pools.get("kv_dtype", "float32")
    ref = _streams(PagedServingEngine(ModelBank.single(tiny["tcfg"], tiny["torch"]["target"]),
                                      EngineConfig(**BASE, kv_dtype=kv)))
    eng = SpeculativeEngine(_bank(tiny, "independent"), EngineConfig(**BASE, spec_k=4, **pools))
    assert (eng.cache.k.dtype == torch.int8) == (kv == "int8")
    dk, _, dks, _ = eng._dpools
    assert (dk.dtype == torch.int8) == (dks is not None)
    assert _streams(eng) == ref


def test_chunked_prefill_and_prefix_cache(tiny):
    """Chunked prefill and the prefix cache (a repeat of a page-aligned
    prompt copies target and draft pages on write): greedy streams equal the
    paged engine's under the same config."""
    kw = dict(max_slots=2, max_len=48, block_size=4, prefill_chunk=8, prefix_cache=True)
    prompts = PROMPTS + [list(range(2, 10))] * 3
    ref = _streams(PagedServingEngine(ModelBank.single(tiny["tcfg"], tiny["torch"]["target"]),
                                      EngineConfig(**kw)), prompts)
    eng = SpeculativeEngine(_bank(tiny, "independent"), EngineConfig(**kw, spec_k=3))
    assert _streams(eng, prompts) == ref
    assert eng.cow_copies >= 1 and eng.chunk_calls > 0


def test_pallas_path_matches_dense(tiny):
    """kernel_impl='pallas' with bf16 draft pools under the f32 model takes
    the paged kernels' route (their plain versions on the CPU) and emits the
    dense path's tokens."""
    out = {}
    for impl in ("dense", "pallas"):
        cfg = dataclasses.replace(tiny["tcfg"], kernel_impl=impl)
        eng = SpeculativeEngine(_bank(tiny, "independent", cfg),
                                EngineConfig(**BASE, spec_k=3))
        out[impl] = _streams(eng, PROMPTS[:2], 4)
    assert out["dense"] == out["pallas"]


def test_sampled_sequential_emits_max_new(tiny):
    eng = SpeculativeEngine(_bank(tiny, "independent"),
                            EngineConfig(**BASE, spec_k=4, greedy=False, temperature=1.0))
    assert not eng._parallel
    done = _streams(eng, max_new=6)
    assert all(len(t) == 6 for t in done.values())
    assert 0.0 <= eng.acceptance_rate <= 1.0 and eng.spec_ticks == eng.decode_calls


def test_adaptive_k_shrinks_on_rejection(tiny):
    bad = SpeculativeEngine(_bank(tiny, "independent"), EngineConfig(
        max_slots=2, max_len=64, block_size=8, spec_k=6, spec_adaptive=True))
    bad.submit(list(range(1, 5)), max_new_tokens=40)
    bad.run()
    assert bad._k < 6 and bad.controller.k_min == 2
    good = SpeculativeEngine(_bank(tiny, "identical"), EngineConfig(
        max_slots=2, max_len=64, block_size=8, spec_k=4, spec_adaptive=True,
        spec_draft_mode="sequential"))
    good.submit(list(range(1, 5)), max_new_tokens=24)
    good.run()
    assert good._k == 4


def test_capability_errors(tiny):
    bank = _bank(tiny, "identical")
    single = ModelBank.single(tiny["tcfg"], tiny["torch"]["target"])
    with pytest.raises(ValueError, match="spec_k >= 1"):
        SpeculativeEngine(bank, EngineConfig(spec_k=0))
    with pytest.raises(EngineCapabilityError, match="pressure"):
        SpeculativeEngine(bank, EngineConfig(spec_k=4, tier_policy="pressure"))
    with pytest.raises(ValueError, match="sampling"):
        SpeculativeEngine(bank, EngineConfig(spec_k=4, greedy=False,
                                             spec_draft_mode="parallel"))
    with pytest.raises(ValueError, match="spec_k >= 2"):
        SpeculativeEngine(bank, EngineConfig(spec_k=1, spec_draft_mode="parallel"))
    assert not SpeculativeEngine(bank, EngineConfig(spec_k=1))._parallel   # auto, k = 1
    assert SpeculativeEngine(bank, EngineConfig(spec_k=2))._parallel       # auto, greedy
    eng = SpeculativeEngine(bank, EngineConfig(spec_k=2))
    with pytest.raises(EngineCapabilityError, match="target tier"):
        eng.submit([1, 2], max_new_tokens=2, tier=1)
    eng.submit([1, 2], max_new_tokens=2, tier=0)
    for cls in (PagedServingEngine, ReferenceEngine):
        with pytest.raises(EngineCapabilityError, match="spec"):
            cls(single, EngineConfig(spec_k=4))
    dm = DeployedModel(tiny["tcfg"], tiny["torch"]["target"], fmt="dense")
    with pytest.raises(EngineCapabilityError, match="AdapterBank"):
        SpeculativeEngine(AdapterBank(dm, [adapterize(dm, dm)]),
                          EngineConfig(spec_k=2, adapters=True))
    with pytest.raises(ValueError, match="spec_draft_mode"):
        EngineConfig(spec_k=2, spec_draft_mode="tree")
    with pytest.raises(ValueError, match="spec_k"):
        EngineConfig(spec_k=-1)
