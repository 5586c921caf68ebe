"""Sampling with a temperature in the port's engines (``_sample``,
``keyed_uniform``, ``gumbel_argmax`` in ``serving/engine.py``).

Torch and JAX cannot draw equal streams, so the sampler is held to the JAX
engine's semantics (``TestPerSlotPRNG`` in ``tests/test_speculative.py``)
and to the distribution it must draw from: an 8-way logits row's class
frequencies over 20000 keyed draws within 0.01 of ``softmax(logits / T)``
(about three standard errors of the largest class). The reduced Llama's
weights come from the JAX package through ``repro_torch.bridge``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    gumbel_argmax,
    keyed_uniform,
    unit_interval,
)

PROMPTS = [[5, 7, 11], [3, 1], list(range(2, 30)), [8, 8, 2], [1, 2, 3, 4, 5, 6]]


@pytest.fixture(scope="module")
def bank():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return ModelBank.single(get_arch("salaad_llama_60m").reduced(), tparams)


def _engine(bank, **kw):
    return PagedServingEngine(bank, EngineConfig(max_slots=3, max_len=48, block_size=8, **kw))


def _streams(engine, max_new=8):
    for p in PROMPTS:
        engine.submit(p, max_new_tokens=max_new)
    return {r.uid: r.out_tokens for r in engine.run()}


@pytest.mark.parametrize("kw", [dict(), dict(greedy=False, temperature=0.0),
                                dict(greedy=False, temperature=-1.0)],
                         ids=["greedy", "t0", "t-neg"])
def test_greedy_and_nonpositive_temperature_take_argmax(bank, kw):
    eng = _engine(bank, **kw)
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 256), dtype=np.float32))
    eng._steps = 5
    assert torch.equal(eng._sample(logits, salt=0), logits.argmax(-1))
    assert torch.equal(eng._sample(logits, salt=1, slots=torch.tensor([2, 2, 2])),
                       logits.argmax(-1))


def test_slot_id_keys_streams(bank):
    """Same logits and slot id: the same sample; different slot ids:
    independent samples; the row order does not matter, only the slot id;
    another step or salt draws other noise."""
    eng = _engine(bank, greedy=False, temperature=1.0)
    eng._steps = 3
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 256), dtype=np.float32)).repeat(8, 1)
    same = eng._sample(logits, salt=0, slots=torch.full((8,), 2))
    assert len(set(same.tolist())) == 1
    mixed = eng._sample(logits, salt=0, slots=torch.arange(8))
    assert len(set(mixed.tolist())) > 1
    perm = eng._sample(logits, salt=0, slots=torch.arange(8).flip(0))
    assert mixed.tolist() == perm.flip(0).tolist()
    u = keyed_uniform((0, 3, 0), torch.arange(8), 256)
    assert not torch.equal(u, keyed_uniform((0, 3, 1), torch.arange(8), 256))
    assert not torch.equal(u, keyed_uniform((0, 4, 0), torch.arange(8), 256))
    # one slot's row equals its row in any batch, bit for bit
    assert torch.equal(keyed_uniform((0, 3, 0), torch.tensor([5]), 256), u[5:6])


def test_uniforms_are_open_unit_interval():
    u = keyed_uniform((7, 1, 2), torch.arange(64), 4096)
    assert u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005


def test_unit_interval_ends_stay_open():
    """The hash's extreme values map inside (0, 1), and their Gumbel noise
    is finite: the largest hash must not round up to 1.0."""
    bits = torch.tensor([0, 1, 0x1FF, 0x200, 0xFFFFFE00, 0xFFFFFFFE, 0xFFFFFFFF],
                        dtype=torch.int64)
    u = unit_interval(bits)
    assert u.dtype == torch.float32
    assert float(u.min()) == 2.0 ** -24 and float(u.max()) == 1.0 - 2.0 ** -24
    assert bool(((u > 0) & (u < 1)).all())
    assert bool(torch.isfinite(-torch.log(-torch.log(u))).all())


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_samples_follow_softmax(temperature):
    """A fixed 8-way logits row drawn 20000 times (slot ids 0..19999, one
    key): each class within 0.01 of softmax(logits / T)."""
    logits = torch.tensor([1.5, -0.3, 0.0, 2.2, -1.7, 0.8, 0.4, -0.9])
    draws = gumbel_argmax(logits.repeat(20000, 1), temperature, (0, 11, 0),
                          torch.arange(20000))
    freq = torch.bincount(draws, minlength=8).float() / 20000
    want = torch.softmax(logits / temperature, dim=-1)
    assert float((freq - want).abs().max()) <= 0.01


def test_sampled_engine_streams_are_keyed_by_seed(bank):
    """A sampled run is the same twice under one seed and differs under
    another; every request emits max_new tokens inside the vocabulary; the
    streams are not the greedy ones."""
    a = _streams(_engine(bank, greedy=False, temperature=0.8, seed=0))
    b = _streams(_engine(bank, greedy=False, temperature=0.8, seed=0))
    c = _streams(_engine(bank, greedy=False, temperature=0.8, seed=1))
    greedy = _streams(_engine(bank))
    assert a == b
    assert a != c and a != greedy
    assert all(len(t) == 8 and all(0 <= x < 256 for x in t) for t in a.values())


def test_sampled_chunked_and_prefix_paths_complete(bank):
    """Chunk ends (salt 1) and prefix-cache hits sample too: the same
    sampled config run twice gives the same streams."""
    kw = dict(greedy=False, temperature=1.0, seed=3, prefill_chunk=16, prefix_cache=True)
    prompts = PROMPTS + [list(range(2, 30))]
    runs = []
    for _ in range(2):
        eng = _engine(bank, **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        runs.append({r.uid: r.out_tokens for r in eng.run()})
        assert eng.chunk_calls > 0 and eng.prefix_hits >= 1
    assert runs[0] == runs[1]


def test_reference_engine_ignores_sampling(bank):
    """Like the JAX package's, ReferenceEngine emits argmax whatever
    greedy and temperature say."""
    runs = []
    for kw in (dict(), dict(greedy=False, temperature=1.0, seed=5)):
        eng = ReferenceEngine(bank, EngineConfig(max_slots=2, max_len=48, **kw))
        runs.append(_streams(eng, max_new=4))
    assert runs[0] == runs[1]
