"""int8 KV pages of the port (``serving/kv_quant.py``, the int8 paths of
``models/attention.py`` and ``models/transformer.py``, and
``EngineConfig(kv_dtype='int8')``) against the JAX package, on the reduced
Llama-60m with weights carried across by ``repro_torch.bridge``.

Tolerances: int8 payloads bit for bit and scales within 1 ulp (the same
f32 division on both sides); logits 1e-5 relative to the largest |logit|
(summation order differs between the frameworks); token streams equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro.models.attention import PagedLayerCache as JaxPagedLayerCache
from repro.models.attention import paged_gather as jax_paged_gather
from repro.models.attention import paged_insert as jax_paged_insert
from repro.serving import kv_quant as jax_kvq
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as transformer_lib
from repro_torch.models.attention import PagedLayerCache, paged_gather, paged_insert
from repro_torch.serving import kv_quant
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
)

PROMPTS = [[5, 7, 11], [3, 1], list(range(2, 30)), [8, 8, 2], [1, 2, 3, 4, 5, 6]]


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, get_arch("salaad_llama_60m").reduced(), params, tparams


def _inputs(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    x[..., 0, :] = 0.0                               # an all-zero row: scale 1e-12
    x.reshape(-1, shape[-1])[1, :4] = (0.5, -1.5, 2.5, 127.0)   # ties at .5
    return x


@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (4, 1, 7, 33)])
def test_quantize_kv_matches_jax(shape):
    x = _inputs(shape, sum(shape))
    q, s = kv_quant.quantize_kv(torch.from_numpy(x))
    jq, js = jax_kvq.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_allclose(kv_quant.dequantize_kv(q, s, torch.float32).numpy(),
                               np.asarray(jax_kvq.dequantize_kv(jq, js, jnp.float32)),
                               rtol=1e-6, atol=0)


def test_append_token_and_cache_roundtrip_match_jax():
    """An LMCache-shaped cache quantized whole, then two appends (one and
    three positions) at its length: payload bit for bit, scales within 1
    ulp, lengths and bytes equal."""
    rng = np.random.default_rng(3)
    l, b, h, s, d = 2, 3, 2, 12, 16
    k, v = (rng.standard_normal((l, b, h, s, d), dtype=np.float32) for _ in range(2))
    tq = kv_quant.quantize_cache(transformer_lib.LMCache(torch.from_numpy(k),
                                                         torch.from_numpy(v), 4))
    jq = jax_kvq.quantize_cache(jax_transformer.LMCache(jnp.asarray(k), jnp.asarray(v),
                                                        jnp.asarray(4, jnp.int32)))
    for t in (1, 3):
        kn, vn = (rng.standard_normal((l, b, h, t, d), dtype=np.float32) for _ in range(2))
        tq = kv_quant.append_token(tq, torch.from_numpy(kn), torch.from_numpy(vn))
        jq = jax_kvq.append_token(jq, jnp.asarray(kn), jnp.asarray(vn))
    assert tq.length == int(jq.length) == 8
    for a, b_ in ((tq.k_q, jq.k_q), (tq.v_q, jq.v_q)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    for a, b_ in ((tq.k_scale, jq.k_scale), (tq.v_scale, jq.v_scale)):
        np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b_), maxulp=1)
    assert kv_quant.cache_bytes(tq) == jax_kvq.cache_bytes(jq._replace(length=None))
    back = kv_quant.dequantize_cache(tq, torch.float32)
    np.testing.assert_allclose(back.k.numpy(), np.asarray(
        jax_kvq.dequantize_cache(jq, jnp.float32).k), rtol=1e-6, atol=0)


def test_paged_insert_and_gather_int8_match_jax():
    """Int8 pools with scale pools: a ragged insert (an unmapped page, a slot
    past capacity) quantizes per (position, head) with JAX's drop rules, and
    the gather dequantizes as JAX's."""
    rng = np.random.default_rng(5)
    n, hkv, bs, d, nb = 6, 2, 4, 8, 3
    k = rng.integers(-127, 128, (n, hkv, bs, d)).astype(np.int8)
    v = rng.integers(-127, 128, (n, hkv, bs, d)).astype(np.int8)
    ks, vs = (rng.random((n, hkv, bs, 1), dtype=np.float32) for _ in range(2))
    table = np.array([[0, 1, n], [2, 3, 4], [n, n, n]], np.int32)
    lengths = np.array([6, 10, 0], np.int32)
    kh, vh = (rng.standard_normal((3, hkv, 5, d), dtype=np.float32) for _ in range(2))
    want = jax_paged_insert(JaxPagedLayerCache(*map(jnp.asarray, (k, v, table, lengths, ks,
                                                                  vs))),
                            jnp.asarray(kh), jnp.asarray(vh))
    got = paged_insert(PagedLayerCache(*(torch.from_numpy(a.copy()) for a in (
        k, v, table, lengths, ks, vs))), torch.from_numpy(kh), torch.from_numpy(vh))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_max_ulp(got.k_scale.numpy(), np.asarray(want.k_scale), maxulp=1)
    np.testing.assert_array_max_ulp(got.v_scale.numpy(), np.asarray(want.v_scale), maxulp=1)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    for a, b_ in zip(paged_gather(got), jax_paged_gather(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-6, atol=0)


def test_scatter_and_copy_pages_carry_scales(tiny):
    """Whole-page prefill scatter quantizes like JAX's, and a page copy
    carries the payload and both scale pools."""
    jcfg, tcfg, _, _ = tiny
    rng = np.random.default_rng(9)
    l, h, d, bs = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim, 4
    kh, vh = (rng.standard_normal((l, 2, h, 8, d), dtype=np.float32) for _ in range(2))
    page_map = np.array([[3, 0], [5, 9]], np.int32)          # 9 is outside the pool: drops
    tc = model_lib.init_paged_cache(tcfg, 2, 6, bs, 2, device="cpu", quantized=True)
    jc = jax_model.init_paged_cache(jcfg, 2, 6, bs, 2, dtype=jnp.float32, quantized=True)
    tc = transformer_lib.scatter_prefill_pages(tc, (torch.from_numpy(kh), torch.from_numpy(vh)),
                                               torch.from_numpy(page_map))
    jc = jax_transformer.scatter_prefill_pages(jc, (jnp.asarray(kh), jnp.asarray(vh)),
                                               jnp.asarray(page_map))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_max_ulp(tc.v_scale.numpy(), np.asarray(jc.v_scale), maxulp=1)
    src, dst = torch.tensor([3, 0], dtype=torch.int32), torch.tensor([1, 2], dtype=torch.int32)
    before = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    transformer_lib.copy_cache_pages(tc, src, dst)
    for pool, old in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), before):
        assert torch.equal(pool[:, [1, 2]], old[:, [3, 0]])
        assert torch.equal(pool[:, [0, 3, 4, 5]], old[:, [0, 3, 4, 5]])


def test_first_int8_decode_logits_match_jax(tiny):
    """A ragged chunk into int8 pages, then the first decode tick: logits
    within 1e-5 of the largest |logit| against JAX's int8 gather path."""
    jcfg, tcfg, params, tparams = tiny
    slots, bs, nb = 3, 8, 4
    table = np.arange(slots * nb, dtype=np.int32).reshape(slots, nb)
    counts = np.array([16, 5, 11], np.int32)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (slots, 16)).astype(np.int32)
    tc = model_lib.init_paged_cache(tcfg, slots, slots * nb, bs, nb, device="cpu",
                                    quantized=True)._replace(block_table=torch.from_numpy(table))
    jc = jax_model.init_paged_cache(jcfg, slots, slots * nb, bs, nb, dtype=jnp.float32,
                                    quantized=True)._replace(block_table=jnp.asarray(table))
    got, tc = model_lib.chunk_prefill_step(tparams, torch.from_numpy(toks),
                                           torch.from_numpy(counts), tc, tcfg)
    want, jc = jax_model.chunk_prefill_step(params, jnp.asarray(toks), jnp.asarray(counts), jc,
                                            jcfg)
    nxt = np.asarray(want)[np.arange(slots), counts - 1].argmax(-1)[:, None].astype(np.int32)
    got, _ = model_lib.decode_step(tparams, torch.from_numpy(nxt), tc, tcfg)
    want, _ = jax_model.decode_step(params, jnp.asarray(nxt), jc, jcfg)
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


ENGINES = {
    "oneshot": dict(max_slots=2, max_len=48, block_size=8),
    "chunked": dict(max_slots=3, max_len=48, block_size=8, prefill_chunk=16),
    "prefix_cow": dict(max_slots=2, max_len=48, block_size=4, prefix_cache=True),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_int8_engine_streams_match_jax(tiny, case):
    """``kv_dtype='int8'`` engines, one-shot, chunked, and with the prefix
    cache on: an exact repeat of a page-aligned prompt resumes inside its
    last hit page, so copy-on-write copies payload and scale pools. Streams
    and counters equal JAX's int8 engine's; the pools are int8 under f32
    activations with scale pools."""
    jcfg, tcfg, params, tparams = tiny
    kw = dict(ENGINES[case], kv_dtype="int8")
    prompts = PROMPTS + ([list(range(2, 10))] * 3 if case == "prefix_cow" else [])
    eng = PagedServingEngine(ModelBank.single(tcfg, tparams), EngineConfig(**kw))
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k_scale.dtype == torch.float32
    jeng = JaxPagedServingEngine(JaxModelBank.single(jcfg, params), JaxEngineConfig(**kw))
    runs = []
    for e in (eng, jeng):
        for p in prompts:
            e.submit(p, max_new_tokens=6)
        runs.append({r.uid: r.out_tokens for r in e.run()})
    assert runs[0] == runs[1]
    assert (eng.decode_calls, eng.prefill_calls, eng.chunk_calls) == \
        (jeng.decode_calls, jeng.prefill_calls, jeng.chunk_calls)
    if case == "prefix_cow":
        assert eng.cow_copies >= 1 and eng.cow_copies == jeng.cow_copies
        assert eng.prefix_hits == jeng.prefix_hits
    assert eng.allocator.used_blocks == jeng.allocator.used_blocks


def test_int8_pages_are_a_quarter_of_f32(tiny):
    """The pools' bytes: int8 payload plus f32 scales against f32 pages."""
    _, tcfg, _, tparams = tiny
    sizes = {}
    for kv in ("float32", "int8"):
        eng = PagedServingEngine(ModelBank.single(tcfg, tparams),
                                 EngineConfig(max_slots=2, max_len=32, kv_dtype=kv))
        sizes[kv] = kv_quant.cache_bytes(eng.cache)
    d = tcfg.head_dim
    pool = sizes["float32"] - sizes["int8"]
    assert pool > 0
    assert sizes["int8"] < sizes["float32"] * (d + 4) / (4 * d) + 1024


def test_reference_engine_rejects_int8(tiny):
    _, tcfg, _, tparams = tiny
    with pytest.raises(EngineCapabilityError, match="kv_dtype='int8'"):
        ReferenceEngine(ModelBank.single(tcfg, tparams), EngineConfig(kv_dtype="int8"))
