"""The port's serving telemetry (``serving/telemetry.py``) and request tracer
(``serving/trace.py``) against the JAX package's, on the reduced Llama-60m
(the cases of ``tests/test_telemetry.py``).

Telemetry and tracing are host-side observers: greedy streams must be
bit-identical with them on or off, on every engine configuration (batched,
paged, chunked prefill, speculative, the pressure tiers, the prefix cache, a
starved pool that evicts, the reference engine). For the same driven run the
port's registry holds what the JAX engine's holds: every counter and gauge
equal, and every histogram's count per label equal (the timings differ, the
counts may not).
Two families are left out of that comparison: ``serve_jit_*``, which count
XLA compiles in JAX and the kernels' launch-plan builds in the port (0 on the
CPU, where no plan is built), and the ``device`` label of
``serve_kv_pool_device_bytes``, which names a JAX device on one side and a
torch device on the other (its values are compared). The port's Chrome trace
and Prometheus text pass both packages' validators.

Every (package, configuration, telemetry) engine is built and driven once,
through the module-scoped ``driven`` fixture, and the tests read that run.
"""
import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as jax_model
from repro.serving import engine as jax_engine
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.speculative import SpeculativeEngine as JaxSpeculativeEngine
from repro.serving.telemetry import engine_provenance as jax_engine_provenance
from repro.serving.telemetry import validate_prometheus_text as jax_validate_prometheus_text
from repro.serving.trace import validate_chrome_trace as jax_validate_chrome_trace
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    ServingEngine,
)
from repro_torch.serving.speculative import SpeculativeEngine
from repro_torch.serving.telemetry import (
    EngineTelemetry,
    MetricsRegistry,
    NullTelemetry,
    engine_provenance,
    request_itls,
    request_ttft,
    start_metrics_server,
    validate_prometheus_text,
)
from repro_torch.serving.trace import validate_chrome_trace


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_get_arch("salaad_llama_60m").reduced()
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return SimpleNamespace(cfg=cfg, tcfg=get_arch("salaad_llama_60m").reduced(),
                           params=params, tparams=tparams)


def _prompts(vocab: int, n: int = 6):
    """Shared prefix + unique tails: exercises the radix cache when on."""
    shared = [(7 * i + 3) % (vocab - 2) + 1 for i in range(12)]
    return [shared + [(i * 5 + j) % (vocab - 2) + 1 for j in range(2 + i % 3)]
            for i in range(n)]


# per configuration: (engine class name, bank tiers, ecfg kwargs)
_BASE = dict(max_slots=2, max_len=48, block_size=8, num_blocks=24)
CONFIGS = {
    "batched": ("ServingEngine", 1, dict(_BASE)),
    "paged": ("PagedServingEngine", 1, dict(_BASE)),
    "chunked_prefill": ("PagedServingEngine", 1, dict(_BASE, prefill_chunk=8)),
    "speculative": ("SpeculativeEngine", 1, dict(_BASE, spec_k=2)),
    "elastic_pressure": ("PagedServingEngine", 2,
                         dict(_BASE, num_blocks=16, tier_policy="pressure")),
    "prefix_cache": ("PagedServingEngine", 1, dict(_BASE, prefill_chunk=8, prefix_cache=True)),
    # a starved pool and long generations: eviction and resume
    "paged_tight": ("PagedServingEngine", 1, dict(_BASE, num_blocks=6)),
    "reference": ("ReferenceEngine", 1, dict(max_slots=2, max_len=48)),
}
_MAX_NEW = {"paged_tight": 16}
_TORCH = {"ServingEngine": ServingEngine, "PagedServingEngine": PagedServingEngine,
          "SpeculativeEngine": SpeculativeEngine, "ReferenceEngine": ReferenceEngine}
_JAX = {"ServingEngine": jax_engine.ServingEngine,
        "PagedServingEngine": jax_engine.PagedServingEngine,
        "SpeculativeEngine": JaxSpeculativeEngine,
        "ReferenceEngine": jax_engine.ReferenceEngine}


def _build(tiny, side: str, name: str, telemetry: bool):
    cls, tiers, kw = CONFIGS[name]
    keeps = [1.0, 0.5][:tiers] if tiers > 1 else None
    if side == "jax":
        bank = JaxModelBank(tiny.cfg, [tiny.params] * tiers, keeps=keeps)
        return _JAX[cls](bank, jax_engine.EngineConfig(telemetry=telemetry, **kw))
    bank = ModelBank(tiny.tcfg, [tiny.tparams] * tiers, keeps=keeps)
    return _TORCH[cls](bank, EngineConfig(telemetry=telemetry, **kw))


@pytest.fixture(scope="module")
def driven(tiny):
    """Memoized (side, config, telemetry) -> (engine, streams, done): every
    engine is built, traced when instrumented, and driven over the shared
    prompt trace once."""
    cache = {}

    def get(name: str, telemetry: bool, side: str = "torch"):
        key = (side, name, telemetry)
        if key not in cache:
            eng = _build(tiny, side, name, telemetry)
            if telemetry:
                eng.start_trace()
            prompts = _prompts(tiny.cfg.vocab_size)
            for p in prompts:
                eng.submit(list(p), max_new_tokens=_MAX_NEW.get(name, 6))
            done = eng.run()
            assert len(done) == len(prompts)
            streams = [r.out_tokens for r in sorted(done, key=lambda r: r.uid)]
            cache[key] = (eng, streams, done)
        return cache[key]

    return get


# ------------------------------------------------- bitwise on/off identity ---


class TestBitwiseInvariance:
    """Turning telemetry and tracing on changes no emitted token."""

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_streams_identical_on_off(self, driven, name):
        eng_off, s_off, _ = driven(name, False)
        eng_on, s_on, _ = driven(name, True)
        assert s_off == s_on
        assert isinstance(eng_off.metrics, NullTelemetry) and eng_off.tracer is None
        assert not isinstance(eng_on.metrics, NullTelemetry) and eng_on.tracer is not None
        tel = eng_on.metrics
        assert tel.counter_value(tel.tokens, "emitted") == sum(len(s) for s in s_on)

    def test_null_telemetry_records_nothing(self, driven):
        eng, streams, _ = driven("paged", False)
        tel = eng.metrics
        assert tel.enabled is False
        assert sum(len(s) for s in streams) > 0
        assert tel.counter_value(tel.tokens, "emitted") == 0
        assert tel.ttft.count(tel.engine) == 0
        assert eng.evictions == 0 and eng.prefix_hits == 0
        tel.snapshot()                    # still callable, reads empty


# --------------------------------------------------- the JAX engine's registry ---


def _registry(eng) -> tuple[dict, dict]:
    """(counters and gauges, histogram counts), each by metric and label
    string, from a snapshot; ``serve_jit_*`` left out, and the device
    label of the pool-bytes gauge dropped (its values sorted)."""
    values, counts = {}, {}
    for name, m in eng.metrics.snapshot().items():
        if name.startswith("serve_jit_"):
            continue
        if m["type"] == "histogram":
            counts[name] = {k: v["count"] for k, v in m["values"].items()}
        elif name == "serve_kv_pool_device_bytes":
            values[name] = sorted(m["values"].values())
        else:
            values[name] = m["values"]
    return values, counts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_registry_matches_jax(driven, name):
    """The same driven run on both sides: every counter and gauge, and every
    histogram's count per (engine, program, tier) label, equal; the streams
    equal too."""
    eng, streams, _ = driven(name, True)
    jeng, jstreams, _ = driven(name, True, side="jax")
    assert streams == jstreams
    values, counts = _registry(eng)
    jvalues, jcounts = _registry(jeng)
    assert values == jvalues
    assert counts == jcounts
    assert counts["serve_ttft_seconds"] == {CONFIGS[name][0]: len(streams)}
    assert any(v for v in counts["serve_program_seconds"].values())


# ------------------------------------------------------- registry internals ---


class TestRegistryPrimitives:
    def test_counter_monotone_and_incrementer(self):
        r = MetricsRegistry()
        c = r.counter("t_total", "x", ("engine",))
        c.inc(2, "E")
        inc = c.incrementer("E")
        inc()
        inc(3)
        assert c.value("E") == 6
        with pytest.raises(ValueError):
            c.inc(-1, "E")

    def test_histogram_exact_percentiles(self):
        r = MetricsRegistry()
        h = r.histogram("h_seconds", "x", ("engine",))
        for v in (0.010, 0.020, 0.030, 0.040):
            h.observe(v, "E")
        assert h.count("E") == 4
        assert h.sum_("E") == pytest.approx(0.100)
        assert h.percentile(0, "E") == pytest.approx(0.010)
        assert h.percentile(100, "E") == pytest.approx(0.040)

    def test_histogram_reset_keeps_bound_observers_live(self):
        r = MetricsRegistry()
        h = r.histogram("h_seconds", "x", ("engine",))
        obs = h.observer("E")
        obs(0.5)
        assert h.count("E") == 1
        h.reset()
        assert h.count("E") == 0
        obs(0.25)
        assert h.count("E") == 1
        assert h.percentile(50, "E") == pytest.approx(0.25)

    def test_gauge_setter(self):
        r = MetricsRegistry()
        g = r.gauge("g", "x", ("engine",))
        set_ = g.setter("E")
        set_(3)
        assert g.value("E") == 3.0

    def test_duplicate_declaration_rejected(self):
        r = MetricsRegistry()
        r.counter("c_total", "x", ("engine",))
        with pytest.raises(ValueError):
            r.gauge("c_total", "x", ("engine",))


# ---------------------------------------------------------- retrace detector ---


class TestRetraceDetector:
    def test_first_compile_then_steady_then_retrace(self):
        tel = EngineTelemetry("T")
        n = {"traces": 0}

        def bump():
            with tel.measure_program("p", 0, traces=lambda: n["traces"]):
                n["traces"] += 1

        def steady():
            with tel.measure_program("p", 0, traces=lambda: n["traces"]):
                pass

        bump()                             # first use: a compile, not a retrace
        assert tel.counter_value(tel.jit_compiles, "p", "0") == 1
        assert tel.retraces() == 0
        steady()
        assert tel.retraces() == 0
        bump()                             # a seen program builds again
        assert tel.counter_value(tel.jit_retraces, "p", "0") == 1
        assert tel.retraces() == 1

    def test_tiers_tracked_independently(self):
        tel = EngineTelemetry("T")
        n = {"traces": 0}
        for tier in (0, 1):
            with tel.measure_program("p", tier, traces=lambda: n["traces"]):
                n["traces"] += 1
        assert tel.retraces() == 0

    def test_plan_builds_are_the_compiles(self):
        """The engines' counter: a launch plan built for a new shape inside a
        program call is its compile; the same shape again builds nothing; a
        new shape on a program that already ran is a retrace."""
        tel = EngineTelemetry("T")
        shape = (1000 + ops.plan_builds(), 256, 32, 4, 4, 4, 132)   # not built before

        def call(n):
            with tel.measure_program("decode", 0, traces=ops.plan_builds):
                ops.bsr_plan(shape[0] + n, *shape[1:])

        call(0)
        assert tel.counter_value(tel.jit_compiles, "decode", "0") == 1 and tel.retraces() == 0
        call(0)
        assert tel.counter_value(tel.jit_compiles, "decode", "0") == 1 and tel.retraces() == 0
        call(1)
        assert tel.retraces() == 1

    def test_engine_steady_state_has_no_retraces(self, tiny, driven):
        eng, _, _ = driven("chunked_prefill", True)
        for p in _prompts(tiny.cfg.vocab_size):
            eng.submit(list(p), max_new_tokens=6)
        eng.run()
        snap = eng.stats_snapshot()
        assert snap["jit_retraces"] == 0
        assert snap["steps"] > 0


# ------------------------------------------------- exactly-once accounting ---


class TestTokenAccounting:
    """Each emitted token is counted once: eviction, resume re-prefill and
    prefix-cache hits do not double-count."""

    def _audit(self, eng, done):
        tel = eng.metrics
        emitted = sum(len(r.out_tokens) for r in done)
        assert tel.counter_value(tel.tokens, "emitted") == emitted
        for r in done:
            assert len(r.token_times) == len(r.out_tokens)
        assert tel.ttft.count(tel.engine) == len(done)
        assert tel.itl.count(tel.engine) == emitted - len(done)

    def test_eviction_resume_counts_once(self, driven):
        eng, _, done = driven("paged_tight", True)
        self._audit(eng, done)
        tel = eng.metrics
        assert eng.evictions > 0
        assert tel.counter_value(tel.tokens, "reprefill") > 0
        assert tel.counter_value(tel.tokens, "prefill_compute") >= \
            tel.counter_value(tel.tokens, "reprefill")

    def test_prefix_hits_split_from_compute(self, tiny, driven):
        eng, _, done = driven("prefix_cache", True)
        self._audit(eng, done)
        tel = eng.metrics
        assert eng.prefix_hits > 0
        hit = tel.counter_value(tel.tokens, "prefix_hit")
        compute = tel.counter_value(tel.tokens, "prefill_compute")
        assert hit > 0
        assert hit + compute == sum(len(p) for p in _prompts(tiny.cfg.vocab_size))

    @pytest.mark.parametrize("name", ["batched", "paged"])
    def test_latency_helpers_are_canonical(self, driven, name):
        eng, _, done = driven(name, True)
        self._audit(eng, done)
        for r in done:
            assert request_ttft(r) >= 0
            gaps = request_itls(r)
            assert len(gaps) == len(r.out_tokens) - 1
            assert all(g >= 0 for g in gaps)


# ----------------------------------------------------------- chrome traces ---


class TestChromeTrace:
    @pytest.mark.parametrize("name", ["batched", "chunked_prefill", "paged_tight"])
    def test_roundtrip_schema(self, driven, tmp_path, name):
        """The exported trace passes the port's validator and the JAX
        package's, with the same counts."""
        eng, _, _ = driven(name, True)
        path = tmp_path / "trace.json"
        eng.tracer.save_chrome(path)
        doc = json.loads(path.read_text())
        rep = validate_chrome_trace(doc)
        assert rep == jax_validate_chrome_trace(doc)
        assert rep["events"] > 0
        assert rep["tracks"] >= 2          # slot tracks + program tracks
        for ev in doc["traceEvents"]:
            assert ev["ph"] in ("X", "i", "M")
            assert "pid" in ev and "tid" in ev and "name" in ev
            if ev["ph"] == "X":
                assert ev["dur"] >= 0 and ev["ts"] >= 0

    def test_jsonl_event_log(self, driven, tmp_path):
        eng, _, _ = driven("paged", True)
        path = tmp_path / "events.jsonl"
        eng.tracer.save_jsonl(path)
        lines = path.read_text().splitlines()
        assert lines
        for ln in lines:
            ev = json.loads(ln)
            assert "name" in ev and "kind" in ev

    def test_validator_rejects_unbalanced(self):
        with pytest.raises(ValueError):
            validate_chrome_trace({"traceEvents": [
                {"ph": "B", "ts": 0, "pid": 1, "tid": 1, "name": "x"},
            ]})


# ------------------------------------------------------------- prometheus ---


class TestPrometheus:
    @pytest.mark.parametrize("name", ["batched", "speculative"])
    def test_text_exposition_valid(self, driven, name):
        eng, _, _ = driven(name, True)
        text = eng.metrics.registry.prometheus_text()
        rep = validate_prometheus_text(text)
        assert rep == jax_validate_prometheus_text(text)
        assert rep["families"] > 10
        assert "serve_tokens_total" in text
        assert "serve_ttft_seconds_bucket" in text

    def test_http_endpoint(self, driven):
        eng, _, _ = driven("paged", True)
        server = start_metrics_server(eng.metrics.registry, port=0)
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
                assert resp.status == 200
                body = resp.read().decode()
            validate_prometheus_text(body)
            assert "serve_tokens_total" in body
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        finally:
            server.shutdown()
            server.server_close()


# -------------------------------------------------------------- provenance ---


class TestProvenance:
    def test_keys_identical_across_engines_and_packages(self, tiny):
        """Every engine's provenance has the same keys and config keys, and
        they are the JAX package's."""
        bank = ModelBank.single(tiny.tcfg, tiny.tparams)
        engines = [
            ServingEngine(bank, EngineConfig(max_slots=1, max_len=16)),
            PagedServingEngine(bank, EngineConfig(max_slots=1, max_len=16, block_size=8)),
            ReferenceEngine(bank, EngineConfig(max_slots=1, max_len=16)),
            SpeculativeEngine(bank, EngineConfig(max_slots=1, max_len=16, block_size=8,
                                                 spec_k=2)),
        ]
        provs = [engine_provenance(e) for e in engines]
        assert len({frozenset(p) for p in provs}) == 1
        assert len({frozenset(p["config"]) for p in provs}) == 1
        for p in provs:
            json.dumps(p)
        jeng = jax_engine.ServingEngine(JaxModelBank.single(tiny.cfg, tiny.params),
                                        jax_engine.EngineConfig(max_slots=1, max_len=16))
        jprov = jax_engine_provenance(jeng)
        assert set(provs[0]) == set(jprov)
        assert set(provs[0]["config"]) == set(jprov["config"])
        assert set(provs[0]["telemetry"]) == set(jprov["telemetry"])

    @pytest.mark.parametrize("name", ["batched", "paged"])
    def test_stats_snapshot_schema(self, driven, name):
        eng, _, _ = driven(name, True)
        snap = eng.stats_snapshot()
        for key in ("engine", "steps", "jit_retraces", "metrics"):
            assert key in snap, key
        assert snap["engine"] == CONFIGS[name][0]
        assert "serve_tokens_total" in snap["metrics"]
