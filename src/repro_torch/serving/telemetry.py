"""Serving telemetry: one metrics substrate for every engine (port of
``repro/serving/telemetry.py``, standard library only).

``MetricsRegistry``
    Counters, gauges and fixed-bucket histograms, each with a name, type,
    help string and label names: the Prometheus data model. One registry per
    engine; every metric carries an ``engine`` label. ``snapshot()`` gives a
    plain dict, ``prometheus_text()`` the text exposition format (served by
    :func:`start_metrics_server`).

``Histogram``
    Fixed log-spaced buckets (cumulative-bucket export) plus a bounded
    raw-sample window for exact percentiles: the one definition of TTFT,
    ITL and tick time the launcher and harnesses read. Past the window,
    ``percentile`` interpolates from the buckets (and the snapshot says so).

``EngineTelemetry``
    The standard serving metric set, with the JAX package's names, help
    strings and labels, and the host-side hooks the engines call: request
    and token accounting, per-program wall-clock timing, and the retrace
    detector. A program here is one engine call of the model (``prefill[
    {bucket}]``, ``decode``, ``chunk[{width}]``, ``page_copy[{n}]``,
    ``spec_decode[k={k}]``); the detector's "compile" is a miss in the
    kernels' host-side launch-plan caches during the call
    (``kernels/ops.py::plan_builds``): the host work PyTorch redoes for a new
    shape, as XLA recompiles for one. A miss on a ``(program, tier)`` pair
    that already ran is a retrace (``serve_jit_retraces_total``). On the CPU
    no plan is built, so both counts stay 0.

Telemetry adds nothing to the device path: every hook runs on the host and
reads host state only, and ``measure_program`` wraps a call together with
the host fetch the engine already does. Greedy streams are bit-identical with
telemetry on or off.

Token accounting: ``serve_tokens_total{kind="emitted"}`` counts every token a
request emits exactly once; eviction re-prefill and prefix-cache hits
re-process tokens (``kind="prefill_compute"`` / ``"reprefill"``,
``"prefix_hit"``) but never re-emit them.

    python -m repro_torch.serving.telemetry validate metrics.txt
"""
from __future__ import annotations

import bisect
import http.server
import json
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import asdict

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "EngineTelemetry",
    "NullTelemetry",
    "engine_provenance",
    "request_ttft",
    "request_itls",
    "start_metrics_server",
    "validate_prometheus_text",
    "LATENCY_BUCKETS_S",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets (seconds, Prometheus base unit): sub-millisecond
# host ticks on the reduced CPU model up through multi-second cold prefills.
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Raw-sample window per histogram: exact percentiles for benchmark-scale
# runs; production-scale streams overflow into bucket interpolation.
_SAMPLE_CAP = 65536


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    esc = lambda s: s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")  # noqa: E731
    return "{" + ",".join(
        f'{n}="{esc(str(v))}"' for n, v in zip(names, values)
    ) + "}"


class _Metric:
    """Shared base: a named, typed, labeled family of samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for l in labels:
            if not _LABEL_RE.match(l):
                raise ValueError(f"invalid label name {l!r} on {name}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        # label-value tuple -> per-series state; () for unlabeled metrics
        self._series: dict[tuple[str, ...], float] = {}
        # raw label values -> stringified key; the hot path (on_token etc.)
        # passes the same few tuples millions of times
        self._key_cache: dict[tuple, tuple[str, ...]] = {}

    def _key(self, values: tuple) -> tuple[str, ...]:
        k = self._key_cache.get(values)
        if k is None:
            if len(values) != len(self.labels):
                raise ValueError(
                    f"{self.name} takes labels {self.labels}, got {values!r}"
                )
            k = self._key_cache[values] = tuple(str(v) for v in values)
        return k

    # --- export -----------------------------------------------------------

    def header(self) -> list[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]

    def samples(self) -> list[str]:
        return [
            f"{self.name}{_label_str(self.labels, k)} {_fmt_value(v)}"
            for k, v in sorted(self._series.items())
        ]

    def snapshot(self):
        if not self.labels:
            return self._series.get((), 0)
        return {",".join(k): v for k, v in sorted(self._series.items())}


class Counter(_Metric):
    """Monotone counter. ``inc`` only ever adds a non-negative amount."""

    kind = "counter"

    def inc(self, amount: float = 1, *labels):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0) + amount

    def incrementer(self, *labels):
        """Pre-bound single-series increment: resolves the label key ONCE so
        per-token hooks skip the varargs + key-cache work on every call."""
        k = self._key(labels)
        series = self._series

        def inc(n: float = 1):
            series[k] = series.get(k, 0) + n

        return inc

    def value(self, *labels) -> float:
        return self._series.get(self._key(labels), 0)

    def total(self) -> float:
        """Sum across every label combination."""
        return sum(self._series.values())


class Gauge(_Metric):
    """Point-in-time value (pool occupancy, controller state, EMAs)."""

    kind = "gauge"

    def set(self, value: float, *labels):
        self._series[self._key(labels)] = float(value)

    def setter(self, *labels):
        """Pre-bound single-series set — the per-tick pool-gauge fast path."""
        k = self._key(labels)
        series = self._series

        def set_(value: float):
            series[k] = float(value)

        return set_

    def value(self, *labels) -> float:
        return self._series.get(self._key(labels), 0.0)


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "sum", "samples", "overflowed")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)   # +Inf bucket last
        self.count = 0
        self.sum = 0.0
        self.samples: list[float] = []
        self.overflowed = False


class Histogram(_Metric):
    """Fixed-bucket histogram with an exact-percentile sample window.

    The bucket layout is frozen at declaration (Prometheus cumulative
    ``_bucket`` export); a bounded raw-sample list rides alongside so that
    benchmark-scale runs get EXACT percentiles — the one definition of
    TTFT/ITL every harness shares. Past ``_SAMPLE_CAP`` observations the
    window stops growing and ``percentile`` interpolates from the buckets
    (upper-bound linear interpolation), which is what a production scrape
    would do anyway.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_S):
        super().__init__(name, help, labels)
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(
                f"histogram {name} buckets must be a sorted, unique, "
                f"non-empty sequence, got {buckets!r}"
            )
        self.buckets = b
        self._series: dict[tuple[str, ...], _HistSeries] = {}

    def _get(self, labels: tuple) -> _HistSeries:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, *labels):
        s = self._get(labels)
        s.bucket_counts[bisect.bisect_left(self.buckets, value)] += 1
        s.count += 1
        s.sum += value
        if len(s.samples) < _SAMPLE_CAP:
            s.samples.append(value)
        else:
            s.overflowed = True

    def observer(self, *labels):
        """Pre-bound single-series observe: the per-token hot path. Resolves
        the series ONCE and closes over it, skipping the varargs build and
        two dict lookups that ``observe`` pays on every call. Safe across
        ``reset`` because reset zeroes series IN PLACE."""
        s = self._get(labels)
        buckets = self.buckets
        bl = bisect.bisect_left
        cap = _SAMPLE_CAP

        def obs(value: float):
            s.bucket_counts[bl(buckets, value)] += 1
            s.count += 1
            s.sum += value
            if len(s.samples) < cap:
                s.samples.append(value)
            else:
                s.overflowed = True

        return obs

    def reset(self):
        """Zero every series — benchmarks call this between warmup and the
        measured window so compilation-time observations never pollute a
        reported percentile. Zeroes IN PLACE (rather than dropping series)
        so the pre-bound ``observer`` closures engines hold stay live."""
        n = len(self.buckets) + 1
        for s in self._series.values():
            s.bucket_counts = [0] * n
            s.count = 0
            s.sum = 0.0
            s.samples = []
            s.overflowed = False

    # --- reads ------------------------------------------------------------

    def count(self, *labels) -> int:
        k = self._key(labels)
        return self._series[k].count if k in self._series else 0

    def sum_(self, *labels) -> float:
        k = self._key(labels)
        return self._series[k].sum if k in self._series else 0.0

    def percentile(self, p: float, *labels) -> float:
        """p in [0, 100]. Exact over the raw-sample window; bucket-
        interpolated once the window has overflowed. nan when empty."""
        k = self._key(labels)
        s = self._series.get(k)
        if s is None or s.count == 0:
            return float("nan")
        if not s.overflowed:
            xs = sorted(s.samples)
            # linear interpolation between closest ranks (numpy default)
            pos = (len(xs) - 1) * p / 100.0
            lo = int(pos)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
        target = s.count * p / 100.0
        cum = 0
        lower = 0.0
        for i, c in enumerate(s.bucket_counts):
            if c:
                upper = (self.buckets[i] if i < len(self.buckets)
                         else self.buckets[-1])
                if cum + c >= target:
                    frac = (target - cum) / c
                    return lower + (upper - lower) * frac
                cum += c
                lower = upper
        return lower

    # --- export -----------------------------------------------------------

    def samples(self) -> list[str]:
        out = []
        for k, s in sorted(self._series.items()):
            cum = 0
            for i, le in enumerate(self.buckets):
                cum += s.bucket_counts[i]
                lbl = _label_str(self.labels + ("le",), k + (repr(float(le)),))
                out.append(f"{self.name}_bucket{lbl} {cum}")
            lbl = _label_str(self.labels + ("le",), k + ("+Inf",))
            out.append(f"{self.name}_bucket{lbl} {s.count}")
            base = _label_str(self.labels, k)
            out.append(f"{self.name}_sum{base} {repr(s.sum)}")
            out.append(f"{self.name}_count{base} {s.count}")
        return out

    def snapshot(self):
        def one(s: _HistSeries) -> dict:
            return {
                "count": s.count,
                "sum": round(s.sum, 9),
                "p50": self._pct_of(s, 50),
                "p90": self._pct_of(s, 90),
                "p99": self._pct_of(s, 99),
                "exact": not s.overflowed,
            }
        if not self.labels:
            s = self._series.get(())
            return one(s) if s is not None else {"count": 0}
        return {",".join(k): one(s) for k, s in sorted(self._series.items())}

    def _pct_of(self, s: _HistSeries, p: float):
        key = next(k for k, v in self._series.items() if v is s)
        v = self.percentile(p, *key)
        return None if v != v else round(v, 9)   # nan -> null in JSON


class MetricsRegistry:
    """A named collection of metrics with idempotent declaration.

    Declaring the same (name, kind, labels) twice returns the existing
    metric; a conflicting redeclaration raises — two call sites can never
    silently split one logical metric."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _declare(self, cls, name, help, labels, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labels != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already declared as {type(m).__name__}"
                    f"{m.labels}, redeclared as {cls.__name__}{tuple(labels)}"
                )
            return m
        m = cls(name, help, tuple(labels), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def __iter__(self):
        return iter(self._metrics.values())

    def snapshot(self) -> dict:
        """Plain-dict view of every metric — the registry half of
        ``engine_provenance`` and ``stats_snapshot`` payloads."""
        return {
            m.name: {"type": m.kind, "values": m.snapshot()}
            for m in self._metrics.values()
        }

    def prometheus_text(self) -> str:
        """The text exposition format (version 0.0.4)."""
        lines = []
        for m in self._metrics.values():
            lines.extend(m.header())
            lines.extend(m.samples())
        return "\n".join(lines) + "\n"


# --------------------------------------------------------- engine telemetry ---


class EngineTelemetry:
    """The standard serving metric set + the host-side hooks engines call.

    One instance per engine. Every metric carries the ``engine`` label (the
    concrete class name) so several engines can be scraped side by side.
    The full catalog — names, types, labels, semantics — is documented in
    ``docs/observability.md`` for the JAX package; the port keeps its names,
    labels and help strings, but the retrace pair's meaning (see the module
    docstring).
    """

    # engines consult this before computing EXPENSIVE hook arguments (e.g. a
    # radix-tree walk for a gauge); the hooks themselves are called
    # unconditionally so the scheduler keeps one code path
    enabled = True

    def __init__(self, engine: str, registry: MetricsRegistry | None = None,
                 tracer=None):
        self.engine = engine
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer          # serving.trace.RequestTracer or None
        r = self.registry
        e = ("engine",)
        self.requests = r.counter(
            "serve_requests_total",
            "Request lifecycle events (submitted/admitted/finished/evicted/"
            "rejected; admissions of a previously evicted request also count "
            "'resumed')", e + ("event",))
        self.tokens = r.counter(
            "serve_tokens_total",
            "Token accounting: 'emitted' counts every generated token exactly "
            "once; 'prefill_compute' counts prompt tokens run through a "
            "prefill/chunk program (eviction re-prefill re-counts here, never "
            "in 'emitted'); 'reprefill' is the re-admission share of that "
            "compute; 'prefix_hit' tokens were served from cached pages",
            e + ("kind",))
        self.ttft = r.histogram(
            "serve_ttft_seconds",
            "Time to first token, measured from Request.submitted_at (open-"
            "loop harnesses backdate it to the scheduled arrival)", e)
        self.itl = r.histogram(
            "serve_itl_seconds", "Inter-token latency between consecutive "
            "emitted tokens of one request", e)
        self.admission_wait = r.histogram(
            "serve_admission_wait_seconds",
            "submit-to-admit queue wait per admission (re-admissions count "
            "from eviction-time re-queue)", e)
        self.tick = r.histogram(
            "serve_tick_seconds", "Wall time of one engine step()", e)
        self.program = r.histogram(
            "serve_program_seconds",
            "Wall time per program call, including the host fetch of its "
            "outputs (count = device calls)", e + ("program", "tier"))
        self.jit_compiles = r.counter(
            "serve_jit_compiles_total",
            "Kernel launch-plan cache misses per (program, tier), the host "
            "work redone for a new shape: first-use builds land here (0 on "
            "the CPU, where no plan is built)", e + ("program", "tier"))
        self.jit_retraces = r.counter(
            "serve_jit_retraces_total",
            "Kernel launch-plan cache misses on a (program, tier) that had "
            "already run: steady-state rebuilds; SLO benchmarks assert 0",
            e + ("program", "tier"))
        self.evictions = r.counter(
            "serve_evictions_total", "Slots evicted back to the queue", e)
        self.prefix = r.counter(
            "serve_prefix_events_total",
            "Radix prompt-cache events: lookups / hits / cow_copies / "
            "reattached_pages", e + ("event",))
        self.tier_switches = r.counter(
            "serve_tier_switches_total",
            "Mid-stream effective-tier changes across all slots", e)
        self.downshift_ticks = r.counter(
            "serve_downshift_ticks_total",
            "Ticks served with a positive pressure-controller shift", e)
        self.spec_tokens = r.counter(
            "serve_spec_tokens_total",
            "Speculative decoding: 'drafted' proposals vs 'accepted' by the "
            "verifier", e + ("kind",))
        self.adapter_swaps = r.counter(
            "serve_adapter_swaps_total",
            "Adapter-pool residency misses: host tables swapped into a "
            "device pool row (multi-tenant AdapterBank serving)", e)
        self.adapter_tokens = r.counter(
            "serve_adapter_tokens_total",
            "Tokens emitted per adapter id (multi-tenant serving)",
            e + ("adapter",))
        self.queue_depth = r.gauge(
            "serve_queue_depth", "Requests waiting for admission", e)
        self.active_slots = r.gauge(
            "serve_active_slots", "Slots holding an active request", e)
        self.free_pages = r.gauge(
            "serve_free_pages", "Free pages in the KV pool (paged engines)", e)
        self.cached_pages = r.gauge(
            "serve_cached_pages",
            "Pages the prefix-cache radix index holds a reference to", e)
        self.tier_shift = r.gauge(
            "serve_tier_shift", "Current pressure-controller downshift", e)
        self.spec_accept_ema = r.gauge(
            "serve_spec_accept_ema",
            "Mean per-slot EMA acceptance rate over active slots", e)
        self.spec_k = r.gauge(
            "serve_spec_k", "Current draft window (adaptive k)", e)
        self.resident_adapters = r.gauge(
            "serve_resident_adapters",
            "Adapters resident in the device pool (AdapterBank capacity "
            "minus unoccupied rows)", e)
        self.kv_pool_device_bytes = r.gauge(
            "serve_kv_pool_device_bytes",
            "KV payload bytes resident per device (pools + int8 scales); "
            "under a ServingMesh each device holds its head-axis shard, so "
            "this shrinks ~1/N with the model-axis size", e + ("device",))
        # (program, tier) pairs whose first call already happened: a plan
        # build observed later is a RETRACE
        self._seen_programs: set[tuple[str, str]] = set()
        # pre-bound fast paths for the hooks that fire every token / tick;
        # everything colder goes through the generic label-resolving calls
        eng = self.engine
        self._obs_ttft = self.ttft.observer(eng)
        self._obs_itl = self.itl.observer(eng)
        self._obs_tick = self.tick.observer(eng)
        self._inc_emitted = self.tokens.incrementer(eng, "emitted")
        self._set_free = self.free_pages.setter(eng)
        self._set_cached = self.cached_pages.setter(eng)
        self._set_queue = self.queue_depth.setter(eng)
        self._set_active = self.active_slots.setter(eng)
        self._set_shift = self.tier_shift.setter(eng)
        self._prog_obs: dict[tuple[str, str], object] = {}

    # ---------------------------------------------------------- low level --

    def counter_value(self, metric: Counter, *rest) -> float:
        return metric.value(self.engine, *rest)

    def inc(self, metric: Counter, n: float = 1, *rest):
        """Engine-labeled increment that respects the on/off switch — engine
        code goes through THIS (or a named hook), never ``metric.inc``
        directly, so NullTelemetry can make 'off' actually free."""
        metric.inc(n, self.engine, *rest)

    # ------------------------------------------------------------- hooks ---

    def on_submit(self):
        self.requests.inc(1, self.engine, "submitted")

    def on_reject(self):
        self.requests.inc(1, self.engine, "rejected")

    def on_admit(self, req, slot: int, now: float, prefill_tokens: int,
                 hit_tokens: int = 0):
        """One admission: queue-wait histogram + the prefill-compute /
        reprefill token split (``prefill_tokens`` is what this admission
        schedules through a prefill or chunk program — the prefix-cache hit
        share is already excluded by the caller)."""
        e = self.engine
        self.requests.inc(1, e, "admitted")
        # a re-admission waited since its eviction RE-QUEUED it, not since
        # the original submit
        since = req.requeued_at if req.evictions else req.submitted_at
        self.admission_wait.observe(max(now - since, 0.0), e)
        if prefill_tokens > 0:
            self.tokens.inc(prefill_tokens, e, "prefill_compute")
            if req.evictions:
                self.requests.inc(1, e, "resumed")
                self.tokens.inc(prefill_tokens, e, "reprefill")
        if hit_tokens > 0:
            self.tokens.inc(hit_tokens, e, "prefix_hit")

    def on_token(self, req, now: float, first: bool):
        """EXACTLY-ONCE emission accounting: called once per token appended
        to ``req.out_tokens`` — never from a re-prefill path."""
        self._inc_emitted(1)
        if first:
            self._obs_ttft(max(now - req.submitted_at, 0.0))
        else:
            self._obs_itl(max(now - req.token_times[-2], 0.0))

    def on_finish(self):
        self.requests.inc(1, self.engine, "finished")

    def on_evict(self):
        self.requests.inc(1, self.engine, "evicted")
        self.evictions.inc(1, self.engine)

    def prefix_event(self, event: str, n: int = 1):
        if n:
            self.prefix.inc(n, self.engine, event)

    def on_spec_tick(self, drafted: int, accepted: int, ema: float, k: int):
        e = self.engine
        self.spec_tokens.inc(drafted, e, "drafted")
        self.spec_tokens.inc(accepted, e, "accepted")
        self.spec_accept_ema.set(ema, e)
        self.spec_k.set(k, e)

    def set_resident_adapters(self, n: int):
        self.resident_adapters.set(n, self.engine)

    def set_pool(self, free: int | None = None, cached: int | None = None,
                 queue: int | None = None, active: int | None = None,
                 shift: int | None = None):
        if free is not None:
            self._set_free(free)
        if cached is not None:
            self._set_cached(cached)
        if queue is not None:
            self._set_queue(queue)
        if active is not None:
            self._set_active(active)
        if shift is not None:
            self._set_shift(shift)

    def set_pool_device_bytes(self, bytes_by_device: dict):
        """Per-device KV pool residency (label: device). Called once at cache
        placement — pool shapes and shardings are static for an engine's
        lifetime, so this is NOT a per-tick hook."""
        for device, nbytes in sorted(bytes_by_device.items()):
            self.kv_pool_device_bytes.set(nbytes, self.engine, device)

    @contextmanager
    def measure_tick(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._obs_tick(time.monotonic() - t0)

    @contextmanager
    def measure_program(self, program: str, tier: int = 0, traces=None):
        """Time one program call (call + host fetch of its outputs) and run
        the retrace detector: ``traces`` is a zero-arg callable reading a
        monotone count of builds (the engines pass ``ops.plan_builds``); a
        positive delta on a (program, tier) pair that already ran is a
        RETRACE."""
        t0 = time.monotonic()
        before = traces() if traces is not None else None
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            e = self.engine
            ts = str(tier)
            obs = self._prog_obs.get((program, ts))
            if obs is None:
                obs = self._prog_obs[(program, ts)] = \
                    self.program.observer(e, program, ts)
            obs(dt)
            if traces is not None:
                delta = traces() - before
                key = (program, ts)
                if delta > 0:
                    self.jit_compiles.inc(delta, e, program, ts)
                    if key in self._seen_programs:
                        self.jit_retraces.inc(delta, e, program, ts)
                self._seen_programs.add(key)
            if self.tracer is not None:
                self.tracer.program_span(program, tier, t0, dt)

    # ------------------------------------------------------------- reads ---

    def retraces(self) -> int:
        """Total steady-state rebuilds across every (program, tier)."""
        return int(self.jit_retraces.total())

    def reset_histograms(self):
        """Benchmark seam: drop histogram state after warmup so the measured
        window's percentiles are clean (counters stay cumulative)."""
        for m in self.registry:
            if isinstance(m, Histogram):
                m.reset()

    def snapshot(self) -> dict:
        return self.registry.snapshot()


class NullTelemetry(EngineTelemetry):
    """Telemetry OFF: every hook is a no-op and the timing context managers
    yield without reading the clock. The engines call hooks unconditionally —
    keeping ONE scheduler code path — and this class makes 'off' actually
    free. The registry still exists (declared but never written), so
    ``snapshot()``/``prometheus_text()`` stay callable and simply read empty.
    """

    enabled = False

    def inc(self, metric, n=1, *rest):
        pass

    def on_submit(self):
        pass

    def on_reject(self):
        pass

    def on_admit(self, req, slot, now, prefill_tokens, hit_tokens=0):
        pass

    def on_token(self, req, now, first):
        pass

    def on_finish(self):
        pass

    def on_evict(self):
        pass

    def prefix_event(self, event, n=1):
        pass

    def on_spec_tick(self, drafted, accepted, ema, k):
        pass

    def set_resident_adapters(self, n):
        pass

    def set_pool(self, free=None, cached=None, queue=None, active=None,
                 shift=None):
        pass

    def set_pool_device_bytes(self, bytes_by_device):
        pass

    @contextmanager
    def measure_tick(self):
        yield

    @contextmanager
    def measure_program(self, program, tier=0, traces=None):
        yield


# ----------------------------------------------------- request-level helpers ---


def request_ttft(req) -> float:
    """THE definition of a request's TTFT: first token relative to
    ``submitted_at`` (monotonic). Open-loop harnesses backdate
    ``submitted_at`` to the scheduled arrival via ``submit(...,
    submitted_at=...)``, so queue time the driver loop induces counts."""
    return req.first_token_at - req.submitted_at


def request_itls(req) -> list[float]:
    """THE definition of a request's inter-token latencies: consecutive
    ``token_times`` gaps (eviction gaps included — the resume cost is real
    latency the client observed)."""
    return [b - a for a, b in zip(req.token_times, req.token_times[1:])]


# ---------------------------------------------------------------- provenance ---


def engine_provenance(engine) -> dict:
    """Engine provenance for BENCH_*.json payloads, generated CENTRALLY from
    the ``EngineConfig`` dataclass plus the telemetry-registry snapshot — so
    every benchmark's payload carries IDENTICAL keys and a new config field
    or counter appears everywhere at once instead of per-script."""
    ecfg = engine.ecfg
    mesh = getattr(engine, "mesh", None)
    out = {
        "engine": type(engine).__name__,
        "config": asdict(ecfg),
        "num_blocks": getattr(engine, "num_blocks", None),
        # device topology: BENCH_*.json from sharded and unsharded runs must
        # be distinguishable (None = single-device / no ServingMesh)
        "mesh": mesh.describe() if mesh is not None else None,
    }
    bank = getattr(engine, "bank", None)
    if bank is not None:
        out["bank"] = {
            "num_tiers": len(bank),
            "names": [t.name for t in bank],
        }
    tel = getattr(engine, "metrics", None)
    if tel is not None:
        snap = tel.snapshot()
        # counters + gauges only: histograms are measurement, not provenance
        out["telemetry"] = {
            name: m["values"] for name, m in sorted(snap.items())
            if m["type"] in ("counter", "gauge")
        }
    return out


# ----------------------------------------------------------------- HTTP ---


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registries: list[MetricsRegistry] = []

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = "".join(r.prometheus_text() for r in self.registries).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):   # keep scrapes out of stderr
        pass


def start_metrics_server(registries, port: int = 0, host: str = "127.0.0.1"):
    """Serve the Prometheus text exposition of one or more registries on a
    daemon thread. Returns the live ``ThreadingHTTPServer`` (``server.
    server_address[1]`` is the bound port — pass ``port=0`` for ephemeral);
    call ``server.shutdown()`` when done."""
    if isinstance(registries, MetricsRegistry):
        registries = [registries]
    handler = type("Handler", (_MetricsHandler,),
                   {"registries": list(registries)})
    server = http.server.ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


# ------------------------------------------------------------- validation ---


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?\s+[-+0-9.eEinfa]+$"
)


def validate_prometheus_text(text: str) -> dict:
    """Light structural validation of the text exposition format: every
    non-comment line parses as a sample, every TYPE is legal, histogram
    series carry _bucket/_sum/_count. Returns {families, samples} counts;
    raises ValueError on malformed input (the CI telemetry smoke gate)."""
    families: dict[str, str] = {}
    samples = 0
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(None, 3)
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"illegal TYPE {kind!r} for {name}")
            families[name] = kind
            continue
        if ln.startswith("#"):
            continue
        if not _SAMPLE_RE.match(ln):
            raise ValueError(f"malformed sample line: {ln!r}")
        samples += 1
    for name, kind in families.items():
        if kind == "histogram":
            for suffix in ("_bucket", "_sum", "_count"):
                if not re.search(rf"^{re.escape(name)}{suffix}[{{ ]", text,
                                 re.M):
                    raise ValueError(
                        f"histogram {name} missing {name}{suffix} series"
                    )
    if not families:
        raise ValueError("no metric families found")
    return {"families": len(families), "samples": samples}


def _main(argv=None) -> int:
    import argparse
    import pathlib
    import sys

    ap = argparse.ArgumentParser(
        description="validate a Prometheus text exposition file"
    )
    ap.add_argument("cmd", choices=["validate"])
    ap.add_argument("path")
    a = ap.parse_args(argv)
    try:
        rep = validate_prometheus_text(pathlib.Path(a.path).read_text())
    except ValueError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, **rep}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
