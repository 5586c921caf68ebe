"""The port's core, model and serving modules against the JAX package, on the
reduced Llama-60m.

The JAX side builds a non-trivial SLR state (``init_slr_state`` plus exact-SVD
``admm_update`` steps, the fixture pattern of ``tests/test_serving_slr.py``);
its parameters and states reach the port through ``repro_torch.bridge`` as
numpy arrays. Pallas kernels on the JAX side run in interpret mode.

Tolerances: f32 atol/rtol 1e-4 for logits and SLR factors (summation order
differs between the frameworks); token streams, block names, byte reports
and allocator state must be equal exactly.
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
from repro.core.admm import surrogate_params as jax_surrogate_params
from repro.models import model as jax_model
from repro.models.attention import PagedLayerCache as JaxPagedLayerCache
from repro.models.attention import paged_insert as jax_paged_insert
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import ReferenceEngine as JaxReferenceEngine
from repro.serving.slr_params import deployment_report as jax_deployment_report
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import sparse
from repro_torch.core.admm import SalaadConfig, admm_update, surrogate_params
from repro_torch.core.selection import select_blocks
from repro_torch.models import model as model_lib
from repro_torch.models.attention import PagedLayerCache, paged_insert
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank as TorchModelBank
from repro_torch.serving.engine import (
    BlockAllocator,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    RequestRejected,
)
from repro_torch.serving.slr_params import deployment_report

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = [[5, 7, 11], [3, 1], list(range(2, 40)), [8, 8, 2], [1, 2, 3, 4, 5, 6]]


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    states = [state]
    sweep = jax.jit(lambda p, s, step: jax_admm_update(p, s, blocks, scfg, step))
    for step in range(2):
        state, _ = sweep(params, state, step)
        states.append(state)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        cfg=cfg, tcfg=get_arch("salaad_llama_60m").reduced(), params=params,
        states=states, state=state, blocks=blocks, tparams=tparams,
        tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams),
    )


# ------------------------------------------------------------------ core ---


def test_selection_matches_jax(trained):
    got = [(b.name, b.shape, b.stack_dims, b.is_embedding) for b in trained.tblocks]
    want = [(b.name, tuple(b.shape), tuple(b.stack_dims), b.is_embedding)
            for b in trained.blocks]
    assert got == want
    assert "layers/q" in [b.name for b in trained.tblocks]


@pytest.mark.parametrize("step", [0, 1])
def test_admm_update_matches_jax(trained, step):
    """One exact-SVD sweep from the same bridged state. L is compared as
    p @ vt (the SVD's signs are free), S as its dense scatter."""
    before = bridge.slr_state_from_numpy(to_numpy(trained.states[step]), "cpu")
    scfg = SalaadConfig(rho_constant=5.0, exact_svd=True)
    got, _ = admm_update(trained.tparams, before, trained.tblocks, scfg, step)
    want = trained.states[step + 1]
    for info in trained.tblocks:
        g, w = got[info.name], want[info.name]
        np.testing.assert_allclose((g.p @ g.vt).numpy(), np.asarray(w.p @ w.vt), **TOL)
        np.testing.assert_allclose(sparse.to_dense(g.s_coo).numpy(),
                                   np.asarray(jax_sparse.to_dense(w.s_coo)), **TOL)
        np.testing.assert_allclose(g.s_vals.numpy(), np.asarray(w.s_vals), **TOL)
        np.testing.assert_allclose(g.y.numpy(), np.asarray(w.y), **TOL)
        np.testing.assert_allclose(g.alpha.numpy(), np.asarray(w.alpha), **TOL)
        np.testing.assert_allclose(g.beta.numpy(), np.asarray(w.beta), **TOL)


def test_exact_svd_is_required():
    """The exact SVD is no longer required: the randomized SVD is ported, and
    ``SalaadConfig()`` selects it with the JAX package's defaults."""
    cfg, jcfg = SalaadConfig(), JaxSalaadConfig()
    assert not cfg.exact_svd and not jcfg.exact_svd
    for f in ("rsvd_iters", "update_every", "admm_inner_steps", "rank_cap_ratio",
              "coo_cap_density", "rho_constant"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_surrogate_params_match_jax(trained):
    got = surrogate_params(trained.tparams, trained.tstate, trained.tblocks)
    want = jax_surrogate_params(trained.params, trained.state, trained.blocks)
    np.testing.assert_allclose(got["layers"]["gate"].numpy(),
                               np.asarray(want["layers"]["gate"]), **TOL)


# ------------------------------------------------------------ deployment ---


def test_deployment_report_equal(trained):
    assert deployment_report(trained.tparams, trained.tstate, trained.tblocks) == \
        jax_deployment_report(trained.params, trained.state, trained.blocks)


@pytest.mark.parametrize("fmt", ["dense", "factored", "fused", "bsr"])
def test_deployed_forward_matches_jax(trained, fmt):
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3]], np.int32)
    got = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate,
                              trained.tblocks, fmt=fmt, bsr_block=32)
    want = JaxDeployedModel.build(trained.cfg, trained.params, trained.state,
                                  trained.blocks, fmt=fmt, bsr_block=32)
    np.testing.assert_allclose(got.forward(torch.from_numpy(toks)).numpy(),
                               np.asarray(want.forward(jnp.asarray(toks))), **TOL)
    assert got.param_bytes() == want.param_bytes()


def test_bsr_format_is_a_later_slice(trained):
    """The bsr format builds (per-layer weights on the low-rank and block-CSC
    kernels); a fused weight outside a layer stack with both parts live (one
    layer's tables of a stacked one) applies through the unstacked kernel and
    equals the stacked layer's apply."""
    dm = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate,
                             trained.tblocks, fmt="bsr", bsr_block=32)
    layers = dm.params["layers"]
    assert isinstance(layers, list) and len(layers) == trained.tcfg.num_layers
    assert layers[0]["q"].use_kernel and layers[0]["q"].s_bsr.block_size == 32
    gate = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate,
                               trained.tblocks, fmt="fused").params["layers"]["gate"]
    unstacked = dataclasses.replace(gate.at_layer(0).lin, s_stack=None,
                                    s_bsr=gate.s_stack.at_layer(0), p=gate.p[0],
                                    vt=gate.vt[0])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, gate.shape[0]), dtype=np.float32))
    np.testing.assert_allclose(unstacked.apply(x).numpy(), gate.at_layer(0).apply(x).numpy(),
                               **TOL)


# ---------------------------------------------------------------- models ---


def test_paged_insert_drops_like_jax():
    """Writes to unmapped pages and past the table's capacity drop."""
    rng = np.random.default_rng(0)
    n, hkv, bs, d, nb = 6, 2, 4, 8, 3
    k = rng.standard_normal((n, hkv, bs, d), dtype=np.float32)
    v = rng.standard_normal((n, hkv, bs, d), dtype=np.float32)
    table = np.array([[0, 1, n], [2, 3, 4], [n, n, n]], np.int32)
    lengths = np.array([6, 10, 0], np.int32)      # slot 1 runs past capacity
    kh = rng.standard_normal((3, hkv, 5, d), dtype=np.float32)
    vh = rng.standard_normal((3, hkv, 5, d), dtype=np.float32)
    want = jax_paged_insert(JaxPagedLayerCache(*map(jnp.asarray, (k, v, table, lengths))),
                            jnp.asarray(kh), jnp.asarray(vh))
    got = paged_insert(PagedLayerCache(*map(torch.from_numpy, (k.copy(), v.copy(), table,
                                                               lengths))),
                       torch.from_numpy(kh), torch.from_numpy(vh))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))


def test_chunk_and_decode_logits_match_jax(trained):
    """A ragged chunk then a decode step over a paged cache: the port's fused
    weights on the kernel path against JAX's factored weights on the gather
    path (held equal to fused by tests/test_fused_slr.py)."""
    tcfg = dataclasses.replace(trained.tcfg, kernel_impl="pallas")
    dm = DeployedModel.build(tcfg, trained.tparams, trained.tstate, trained.tblocks,
                             fmt="fused", bsr_block=32)
    jdm = JaxDeployedModel.build(trained.cfg, trained.params, trained.state,
                                 trained.blocks, fmt="factored")
    slots, bs, nb = 3, 8, 4
    table = np.arange(slots * nb, dtype=np.int32).reshape(slots, nb)
    table[2, 2:] = slots * nb                     # unmapped tail
    counts = np.array([16, 5, 11], np.int32)
    toks = np.random.default_rng(0).integers(0, 256, (slots, 16)).astype(np.int32)
    tcache = model_lib.init_paged_cache(tcfg, slots, slots * nb, bs, nb, device="cpu")
    tcache = tcache._replace(block_table=torch.from_numpy(table))
    jcache = jax_model.init_paged_cache(trained.cfg, slots, slots * nb, bs, nb,
                                        dtype=jnp.float32)
    jcache = jcache._replace(block_table=jnp.asarray(table))
    got, tcache = model_lib.chunk_prefill_step(dm.params, torch.from_numpy(toks),
                                               torch.from_numpy(counts), tcache, tcfg)
    want, jcache = jax_model.chunk_prefill_step(jdm.params, jnp.asarray(toks),
                                                jnp.asarray(counts), jcache, trained.cfg)
    for b, c in enumerate(counts):
        np.testing.assert_allclose(got[b, :c].numpy(), np.asarray(want[b, :c]), **TOL)
    nxt = np.array([[7], [9], [11]], np.int32)
    got, _ = model_lib.decode_step(dm.params, torch.from_numpy(nxt), tcache, tcfg)
    want, _ = jax_model.decode_step(jdm.params, jnp.asarray(nxt), jcache, trained.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- engine ---


def run_streams(engine, prompts, max_new):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    return {r.uid: r.out_tokens for r in engine.run()}


@pytest.mark.parametrize("case", ["roomy", "evicting"])
def test_engine_streams_match_jax(trained, case):
    """Greedy streams of the fused format on the kernel path with chunked
    prefill are token-identical to the JAX engine's (fused, Pallas kernels in
    interpret mode). The evicting pool forces an eviction and a chunked
    re-prefill resume."""
    kw = {
        "roomy": dict(max_slots=3, max_len=64, block_size=8, prefill_chunk=16),
        "evicting": dict(max_slots=2, max_len=48, block_size=4, num_blocks=12,
                         decode_reserve=1, prefill_chunk=8),
    }[case]
    tcfg = dataclasses.replace(trained.tcfg, kernel_impl="pallas")
    jcfg = dataclasses.replace(trained.cfg, kernel_impl="pallas")
    dm = DeployedModel.build(tcfg, trained.tparams, trained.tstate, trained.tblocks,
                             fmt="fused", bsr_block=32)
    jdm = JaxDeployedModel.build(jcfg, trained.params, trained.state, trained.blocks,
                                 fmt="fused", bsr_block=32)
    eng = PagedServingEngine(dm, EngineConfig(**kw))
    got = run_streams(eng, PROMPTS, 6)
    jeng = JaxPagedServingEngine(ModelBank.single(jcfg, jdm), JaxEngineConfig(**kw))
    assert got == run_streams(jeng, PROMPTS, 6)
    assert eng.chunk_calls > 0 and eng.prefill_calls == 0
    assert eng.evictions == jeng.evictions
    assert (eng.evictions >= 1) == (case == "evicting")
    assert eng.allocator.used_blocks == 0


@pytest.mark.parametrize("fmt", ["fused", "factored"])
def test_reference_engine_streams_match_jax(trained, fmt):
    """The dense Llama through ReferenceEngine (contiguous f32 cache, prompts
    fed token by token): a two-tier bank's greedy streams and decode-call
    count equal the JAX ReferenceEngine's."""
    jbank = JaxModelBank.build(trained.cfg, trained.params, trained.state, trained.blocks,
                               (1.0, 0.5), fmt=fmt, bsr_block=32)
    tbank = TorchModelBank.build(trained.tcfg, trained.tparams, trained.tstate,
                                 trained.tblocks, (1.0, 0.5), fmt=fmt, bsr_block=32)
    runs = []
    for eng in (ReferenceEngine(tbank, EngineConfig(max_slots=2, max_len=48)),
                JaxReferenceEngine(jbank, JaxEngineConfig(max_slots=2, max_len=48))):
        for i, prompt in enumerate(PROMPTS):
            eng.submit(prompt, max_new_tokens=5, tier=i % 2)
        runs.append(({r.uid: r.out_tokens for r in eng.run()}, eng.decode_calls))
    assert runs[0] == runs[1]
    assert runs[0][1] == sum(len(p) - 1 + 5 for p in PROMPTS)


def test_reference_engine_rejects_adapters_and_bad_requests(trained):
    """Like the JAX engine: an adapter request or an oversized prompt is a
    RequestRejected, and an AdapterBank a capability error at construction."""
    from repro_torch.serving.adapters import AdapterBank, adapterize
    from repro_torch.serving.engine import EngineCapabilityError

    dm = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate, trained.tblocks,
                             fmt="fused")
    eng = ReferenceEngine(dm, EngineConfig(max_slots=1, max_len=16))
    with pytest.raises(RequestRejected, match="adapter"):
        eng.submit([1, 2], max_new_tokens=4, adapter=0)
    with pytest.raises(RequestRejected, match="exceeds cache capacity"):
        eng.submit(list(range(12)), max_new_tokens=8)
    with pytest.raises(RequestRejected, match="tier"):
        eng.submit([1, 2], max_new_tokens=4, tier=3)
    with pytest.raises(EngineCapabilityError, match="multi-tenant adapters"):
        ReferenceEngine(AdapterBank(dm, [adapterize(dm, dm)]), EngineConfig(adapters=True))


def test_oneshot_prefill_streams_match_jax(trained):
    """Without prefill_chunk (dense attention, factored weights) admission
    prefills whole prompts and scatters whole pages."""
    kw = dict(max_slots=2, max_len=64, block_size=8)
    dm = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate,
                             trained.tblocks, fmt="factored")
    jdm = JaxDeployedModel.build(trained.cfg, trained.params, trained.state,
                                 trained.blocks, fmt="factored")
    eng = PagedServingEngine(dm, EngineConfig(**kw))
    got = run_streams(eng, PROMPTS, 5)
    assert got == run_streams(JaxPagedServingEngine(ModelBank.single(trained.cfg, jdm),
                                                    JaxEngineConfig(**kw)), PROMPTS, 5)
    assert eng.prefill_calls > 0 and eng.chunk_calls == 0


def test_pallas_needs_chunked_prefill(trained):
    """Under kernel_impl='pallas' one-shot prefill now runs the flash kernel,
    so chunked prefill is no longer needed; the paged kernels take pages in
    the model's dtype or bf16 pages under the f32 model (f32 queries over
    bf16 pages), and refuse f32 pages under a bf16 model by name."""
    tcfg = dataclasses.replace(trained.tcfg, kernel_impl="pallas")
    dm = DeployedModel.build(tcfg, trained.tparams, trained.tstate, trained.tblocks,
                             fmt="factored")
    eng = PagedServingEngine(dm, EngineConfig(max_slots=2, max_len=64, block_size=8))
    eng.submit([3, 1, 4], max_new_tokens=2)
    assert len(eng.run()) == 1 and eng.prefill_calls == 1 and eng.chunk_calls == 0
    bf16 = PagedServingEngine(dm, EngineConfig(max_slots=2, max_len=64, block_size=8,
                                               kv_dtype="bfloat16"))
    assert bf16.cache.k.dtype == torch.bfloat16
    bf16.submit([3, 1, 4], max_new_tokens=2)
    assert len(bf16.run()) == 1
    with pytest.raises(TypeError, match="kv_dtype='float32'"):
        PagedServingEngine(DeployedModel(dataclasses.replace(tcfg, param_dtype=torch.bfloat16),
                                         trained.tparams, fmt="dense"), EngineConfig())


@pytest.mark.parametrize("field,value,name", [
    ("greedy", False, "sampling"), ("spec_k", 3, "speculative"),
    ("mesh", "model=2", "tensor-parallel"),
    ("telemetry", True, "telemetry"), ("trace", True, "tracer"),
    ("kv_dtype", "int8", "int8"),
])
def test_later_slice_features_raise(trained, field, value, name):
    """Features the config takes raise, naming themselves, in an engine that
    cannot give them: sampling, speculation, int8 pages and the mesh (a
    parallel draft schedule cannot sample, the paged engine does not
    speculate, the reference engine keeps an f32 cache and serves on one
    device, as the JAX package's lists them; a malformed mesh spec raises at
    ``EngineConfig``). The
    telemetry registry and the tracer are ported: every engine builds its
    registry (a no-op one with ``telemetry=False``) and, with ``trace=True``,
    its tracer."""
    from repro_torch.serving.speculative import SpeculativeEngine
    from repro_torch.serving.telemetry import EngineTelemetry, NullTelemetry
    from repro_torch.serving.trace import RequestTracer

    if field == "mesh":
        with pytest.raises(ValueError, match="mesh="):
            EngineConfig(mesh="tp=2")
    dm = DeployedModel(trained.tcfg, trained.tparams, fmt="dense")
    if field in ("telemetry", "trace"):
        for cls in (PagedServingEngine, ReferenceEngine):
            on = cls(dm, EngineConfig(**{field: value}))
            off = cls(dm, EngineConfig(telemetry=False))
            assert type(on.metrics) is EngineTelemetry and on.metrics.enabled
            assert type(off.metrics) is NullTelemetry and off.tracer is None
            if field == "trace":
                assert isinstance(on.tracer, RequestTracer) and on.metrics.tracer is on.tracer
        return
    EngineConfig(**{field: value})
    with pytest.raises(ValueError, match=name):
        if field == "greedy":
            SpeculativeEngine(dm, EngineConfig(greedy=False, spec_k=2,
                                               spec_draft_mode="parallel"))
        elif field == "spec_k":
            PagedServingEngine(dm, EngineConfig(spec_k=value))
        else:
            ReferenceEngine(dm, EngineConfig(**{field: value}))


@pytest.mark.parametrize("kw", [dict(max_slots=0), dict(block_size=8, prefill_chunk=12),
                                dict(num_blocks=0), dict(evict_policy="fifo"),
                                dict(kv_dtype="float16"), dict(decode_reserve=0),
                                dict(prefix_min_hit_pages=0), dict(tier_policy="fifo")])
def test_engine_config_rejects_bad_values(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw)


def test_submit_rejects_oversized_requests(trained):
    dm = DeployedModel.build(trained.tcfg, trained.tparams, trained.tstate,
                             trained.tblocks, fmt="factored")
    eng = PagedServingEngine(dm, EngineConfig(max_slots=2, max_len=32, block_size=4,
                                              num_blocks=4))
    with pytest.raises(RequestRejected):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(RequestRejected):
        eng.submit(list(range(30)), max_new_tokens=8)
    with pytest.raises(RequestRejected):
        eng.submit(list(range(10)), max_new_tokens=10)   # 5 pages > pool of 4


# ------------------------------------------------------------- allocator ---


class TestBlockAllocator:
    """The property tests of tests/test_paged_kv.py, on the port's allocator."""

    def test_alloc_free_roundtrip(self):
        a = BlockAllocator(8)
        pages = a.alloc(5)
        assert len(pages) == 5 and len(set(pages)) == 5
        assert a.free_blocks == 3 and a.used_blocks == 5
        a.free(pages[:2])
        assert a.free_blocks == 5 and a.used_blocks == 3
        a.free(pages[2:])
        assert a.free_blocks == 8 and a.used_blocks == 0

    def test_no_partial_grants_and_no_double_alloc(self):
        a = BlockAllocator(4)
        p1 = a.alloc(3)
        assert a.alloc(2) is None
        assert a.free_blocks == 1
        p2 = a.alloc(1)
        assert set(p1).isdisjoint(p2)
        assert a.alloc(1) is None

    def test_double_free_rejected(self):
        a = BlockAllocator(4)
        pages = a.alloc(2)
        a.free(pages)
        with pytest.raises(ValueError):
            a.free(pages)

    def test_bad_free_is_atomic(self):
        a = BlockAllocator(8)
        pages = a.alloc(4)
        with pytest.raises(ValueError):
            a.free([pages[0], pages[1], 99])
        assert a.free_blocks + a.used_blocks == 8 and a.used_blocks == 4
        with pytest.raises(ValueError):
            a.free([pages[0], pages[0]])
        assert a.used_blocks == 4
        a.free(pages)
        assert a.free_blocks == 8 and a.used_blocks == 0
        assert a.alloc(8) is not None

    def test_interchangeable_pages_no_fragmentation(self):
        a = BlockAllocator(6)
        held = [a.alloc(2) for _ in range(3)]
        a.free(held[0])
        a.free(held[2])
        assert a.alloc(4) is not None

    def test_shared_pages_release_by_refcount(self):
        a = BlockAllocator(4)
        pages = a.alloc(2)
        a.share(pages[:1])
        with pytest.raises(ValueError):
            a.free(pages)                          # one page is shared
        assert a.release(pages) == [pages[1]]
        assert a.refcount(pages[0]) == 1 and a.free_blocks == 3
        assert a.release(pages[:1]) == pages[:1]
        assert a.free_blocks == 4 and a.used_blocks == 0

    @pytest.mark.parametrize("seed", range(3))
    def test_random_operation_sequences_keep_the_pool_whole(self, seed):
        """Random alloc/share/release/free sequences: no page is ever held
        twice by alloc, and free + distinct-owned always equals the pool."""
        rng = np.random.default_rng(seed)
        a = BlockAllocator(16)
        held: list[int] = []                       # one entry per reference
        for _ in range(300):
            op = rng.integers(4)
            if op == 0:
                got = a.alloc(int(rng.integers(1, 5)))
                if got is not None:
                    assert not set(got) & set(held)
                    held += got
            elif op == 1 and held:
                page = held[int(rng.integers(len(held)))]
                a.share([page])
                held.append(page)
            elif op == 2 and held:
                page = held.pop(int(rng.integers(len(held))))
                a.release([page])
            elif op == 3 and held:
                page = held[int(rng.integers(len(held)))]
                if held.count(page) == 1:
                    held.remove(page)
                    a.free([page])
                else:
                    with pytest.raises(ValueError):
                        a.free([page])
            assert a.free_blocks + a.used_blocks == 16
            assert a.used_blocks == len(set(held))
            assert all(a.refcount(p) == held.count(p) for p in set(held))
