"""Per-request span tracing with Chrome-trace and JSONL export (port of
``repro/serving/trace.py``).

Where :mod:`repro_torch.serving.telemetry` answers "how is the fleet doing"
(aggregates), this module answers "why was THIS request slow" (timelines).
A :class:`RequestTracer` collects spans and instants from the engine hooks:

* one track (``tid``) per engine SLOT under pid 1 — a request's life renders
  as nested spans on the slot it occupied: ``request`` envelope >
  ``admission_wait`` > ``prefill`` / ``prefill_chunk`` spans > ``decode``
  span, with instant markers for first token, tier switches, CoW copies,
  prefix-cache hits, speculative accept runs, and eviction/resume;
* one track per PROGRAM under pid 2 — ``decode``, ``prefill[32]``,
  ``chunk[64]``, ``spec_decode[k=4]`` wall-clock slices, so a TTFT bubble on a slot track
  lines up visually with the program call that caused it.

Export formats:

* ``save_chrome(path)`` — Chrome trace-event JSON (the ``traceEvents``
  array form). Open in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``. ``ph:"X"`` complete events carry ``ts``/``dur`` in
  MICROSECONDS relative to the tracer's epoch; ``ph:"i"`` instants mark
  point events; ``ph:"M"`` metadata names the tracks.
* ``save_jsonl(path)`` — one structured event dict per line, stable schema
  (``kind``/``name``/``ts_us``/``dur_us``/``slot``/``uid``/``args``), for
  ad-hoc analysis without a trace viewer.

Tracing is host-side only and costs one list-append per event; the token
stream is bitwise-identical with tracing on or off
(tests/test_torch_telemetry.py).

    python -m repro_torch.serving.trace validate trace.json   # schema check
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

__all__ = ["RequestTracer", "validate_chrome_trace"]

_SLOT_PID = 1      # one tid per engine slot
_PROGRAM_PID = 2   # one tid per program


@dataclass
class _Span:
    """An open span on a slot track; closed spans move to ``events``."""
    name: str
    t0: float
    args: dict = field(default_factory=dict)


class RequestTracer:
    """Collects slot-track spans + program-track slices for one engine run.

    All timestamps are ``time.monotonic()`` seconds; export converts to µs
    relative to the tracer's construction (so traces start near ts=0).
    Spans on one slot track nest strictly: ``begin_span``/``end_span`` pairs
    form a stack per slot, and the exporter emits them as ``ph:"X"``
    complete events (Perfetto infers nesting from containment).
    """

    def __init__(self, engine: str = "engine"):
        self.engine = engine
        self.epoch = time.monotonic()
        self.events: list[dict] = []       # closed events, export order
        self._open: dict[int, list[_Span]] = {}   # slot -> span stack
        self._programs: dict[str, int] = {}       # program name -> tid

    # ------------------------------------------------------------ helpers --

    def _us(self, t: float) -> int:
        return int(round((t - self.epoch) * 1e6))

    def _program_tid(self, name: str) -> int:
        tid = self._programs.get(name)
        if tid is None:
            tid = self._programs[name] = len(self._programs) + 1
        return tid

    # -------------------------------------------------------- slot spans ---

    def begin_span(self, slot: int, name: str, t: float | None = None,
                   **args):
        self._open.setdefault(slot, []).append(
            _Span(name, time.monotonic() if t is None else t, dict(args))
        )

    def end_span(self, slot: int, name: str, t: float | None = None, **args):
        """Close the innermost open span named ``name`` on ``slot``; spans
        opened after it (still unclosed, e.g. on eviction) are discarded —
        an aborted child span has no meaningful duration."""
        t = time.monotonic() if t is None else t
        stack = self._open.get(slot, [])
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                span = stack[i]
                del stack[i:]
                span.args.update(args)
                self.events.append({
                    "kind": "span", "name": span.name, "slot": slot,
                    "ts_us": self._us(span.t0),
                    "dur_us": max(self._us(t) - self._us(span.t0), 0),
                    "args": span.args,
                })
                return
        # unmatched end (e.g. resume path after eviction dropped the stack):
        # record a zero-duration span so the event is still visible
        self.events.append({
            "kind": "span", "name": name, "slot": slot,
            "ts_us": self._us(t), "dur_us": 0, "args": dict(args),
        })

    def has_open(self, slot: int, name: str) -> bool:
        """True if an unclosed span named ``name`` is open on ``slot`` — the
        engines use this to close lifecycle spans lazily (a prefill span ends
        at whichever token event arrives first: first token, resume
        completion, or eviction)."""
        return any(s.name == name for s in self._open.get(slot, ()))

    def instant(self, slot: int, name: str, t: float | None = None, **args):
        self.events.append({
            "kind": "instant", "name": name, "slot": slot,
            "ts_us": self._us(time.monotonic() if t is None else t),
            "args": dict(args),
        })

    def program_span(self, program: str, tier: int, t0: float, dur_s: float):
        """One program call on the program pid (called by
        ``EngineTelemetry.measure_program``)."""
        self.events.append({
            "kind": "program", "name": program, "tier": tier,
            "ts_us": self._us(t0), "dur_us": max(int(round(dur_s * 1e6)), 0),
            "args": {"tier": tier},
        })

    # --------------------------------------------------- request lifecycle --

    def request_begin(self, slot: int, uid: int, t: float | None = None,
                      **args):
        self.begin_span(slot, "request", t, uid=uid, **args)

    def request_end(self, slot: int, uid: int, t: float | None = None,
                    **args):
        self.end_span(slot, "request", t, uid=uid, **args)

    # ------------------------------------------------------------ export ---

    def chrome_events(self) -> list[dict]:
        out = [
            {"ph": "M", "pid": _SLOT_PID, "tid": 0, "name": "process_name",
             "args": {"name": f"{self.engine} slots"}},
            {"ph": "M", "pid": _PROGRAM_PID, "tid": 0, "name": "process_name",
             "args": {"name": f"{self.engine} programs"}},
        ]
        slots = sorted({e["slot"] for e in self.events if "slot" in e})
        for s in slots:
            out.append({"ph": "M", "pid": _SLOT_PID, "tid": s,
                        "name": "thread_name", "args": {"name": f"slot {s}"}})
        for prog, tid in sorted(self._programs.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "pid": _PROGRAM_PID, "tid": tid,
                        "name": "thread_name", "args": {"name": prog}})
        for e in self.events:
            if e["kind"] == "span":
                out.append({"ph": "X", "pid": _SLOT_PID, "tid": e["slot"],
                            "name": e["name"], "ts": e["ts_us"],
                            "dur": e["dur_us"], "cat": "request",
                            "args": e["args"]})
            elif e["kind"] == "instant":
                out.append({"ph": "i", "pid": _SLOT_PID, "tid": e["slot"],
                            "name": e["name"], "ts": e["ts_us"], "s": "t",
                            "cat": "request", "args": e["args"]})
            elif e["kind"] == "program":
                out.append({"ph": "X", "pid": _PROGRAM_PID,
                            "tid": self._program_tid(e["name"]),
                            "name": e["name"], "ts": e["ts_us"],
                            "dur": e["dur_us"], "cat": "program",
                            "args": e["args"]})
        return out

    def save_chrome(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)

    def save_jsonl(self, path):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")


# ------------------------------------------------------------- validation ---


def validate_chrome_trace(doc) -> dict:
    """Structural validation of an exported Chrome trace: every event has a
    legal ``ph`` with the fields that phase requires, complete events on one
    track don't partially overlap (spans nest or are disjoint), and request
    envelopes contain their children. Returns summary counts; raises
    ValueError on violations. Used by the CI telemetry smoke and the schema
    round-trip test."""
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("object form must carry a traceEvents array")
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError("trace must be an object or array")

    counts = {"X": 0, "i": 0, "M": 0}
    tracks: dict[tuple, list[tuple[int, int, str]]] = {}
    for e in events:
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"unsupported ph {ph!r}: {e}")
        if "pid" not in e or "name" not in e:
            raise ValueError(f"event missing pid/name: {e}")
        if ph in ("X", "i"):
            ts = e.get("ts")
            if not isinstance(ts, int) or ts < 0:
                raise ValueError(f"ts must be a non-negative int (µs): {e}")
            if "tid" not in e:
                raise ValueError(f"event missing tid: {e}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(f"X event needs non-negative int dur: {e}")
            tracks.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + dur, e["name"])
            )
        if ph == "i" and e.get("s", "t") not in ("t", "p", "g"):
            raise ValueError(f"instant scope must be t/p/g: {e}")
        counts[ph] += 1

    # spans on a track must nest (contain) or be disjoint — partial overlap
    # means mismatched begin/end bookkeeping and renders as garbage
    for key, spans in tracks.items():
        # parents before equal-start children (longer span first)
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple[int, int, str]] = []
        for s in spans:
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            if stack and s[1] > stack[-1][1]:
                raise ValueError(
                    f"partially overlapping spans on track {key}: "
                    f"{stack[-1]} vs {s}"
                )
            stack.append(s)

    if counts["X"] == 0:
        raise ValueError("trace has no complete (ph=X) events")
    return {"events": sum(counts.values()), **counts,
            "tracks": len(tracks)}


def _main(argv=None) -> int:
    import argparse
    import pathlib
    import sys

    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON file"
    )
    ap.add_argument("cmd", choices=["validate"])
    ap.add_argument("path")
    a = ap.parse_args(argv)
    try:
        doc = json.loads(pathlib.Path(a.path).read_text())
        rep = validate_chrome_trace(doc)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, **rep}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
