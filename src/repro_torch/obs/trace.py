"""Request-lifecycle tracing in Chrome/Perfetto trace-event JSON.

The serving stack's lifecycle — submit -> queue -> schedule -> batch-form
-> prefill/decode/execute -> stream — was only observable as aggregate
percentiles.  :class:`TraceRecorder` captures it as *events*: every
request gets its own track (``tid`` = request uid), the engine's
scheduler/batch machinery shares track 0, and one-off moments
(jit compiles, prefix-cache hits/misses/evictions) land as instants.
``export()`` emits the Trace Event Format JSON that both
``chrome://tracing`` and https://ui.perfetto.dev load directly.

Event vocabulary (the subset of the format we emit):

* ``ph: "B"/"E"`` — begin/end a duration span on one (pid, tid) track,
* ``ph: "X"``     — a span recorded whole once it has ended (``dur``),
* ``ph: "i"``     — an instant (scope ``"t"``: thread-width tick),
* ``ph: "C"``     — a counter sample (Perfetto draws a value track),
* ``ph: "M"``     — metadata (we name tracks with ``thread_name``).

Timestamps are integer microseconds from a monotonic clock captured at
recorder construction, so traces are replayable and diffable.  A
disabled recorder returns from every recording call before it reads the
clock or builds an event.  The buffer is bounded (``max_events``);
overflow increments ``dropped`` instead of growing without bound,
matching the engine's windowed stats.

:func:`validate_trace` is the CI-side schema check: required fields,
globally non-decreasing timestamps, B/E spans balanced LIFO per track
with matching names, X spans of a non-negative integer ``dur``, and at
least one complete span per request track —
the guarantees a trace viewer needs to render without glitches.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


class TraceRecorder:
    """Bounded in-memory trace-event buffer with a stable clock origin."""

    def __init__(self, enabled: bool = True, *, clock=time.perf_counter,
                 pid: int = 1, max_events: int = 1_000_000):
        self.enabled = enabled
        self.clock = clock
        self.pid = pid
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._t0 = clock()

    # -- primitives ---------------------------------------------------------

    def now_us(self) -> int:
        return int((self.clock() - self._t0) * 1e6)

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def begin(self, name: str, *, tid: int = 0, cat: str = "engine",
              ts_us: Optional[int] = None, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "B", "cat": cat, "pid": self.pid,
                    "tid": tid,
                    "ts": self.now_us() if ts_us is None else ts_us,
                    **({"args": args} if args else {})})

    def end(self, name: str, *, tid: int = 0, cat: str = "engine",
            ts_us: Optional[int] = None, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "E", "cat": cat, "pid": self.pid,
                    "tid": tid,
                    "ts": self.now_us() if ts_us is None else ts_us,
                    **({"args": args} if args else {})})

    def span(self, name: str, *, tid: int = 0, cat: str = "engine", **args):
        """``with trace.span("execute", tid=uid):`` — balanced B/E pair."""
        if not self.enabled:
            return _NO_SPAN
        return self._span(name, tid=tid, cat=cat, **args)

    @contextlib.contextmanager
    def _span(self, name: str, *, tid: int, cat: str, **args):
        self.begin(name, tid=tid, cat=cat, **args)
        try:
            yield self
        finally:
            self.end(name, tid=tid, cat=cat)

    def complete(self, name: str, t_begin: float, t_end: float, *,
                 tid: int = 0, cat: str = "engine",
                 args: Optional[dict] = None) -> None:
        """A span that has ended, as one ``ph: "X"`` event: ``t_begin``
        and ``t_end`` are readings of ``clock``.  One event and no
        keyword packing where ``begin``/``end`` make two, for hot loops;
        it is recorded at the span's end, so the trace's stamps stay in
        order where nothing else is recorded during the span."""
        if not self.enabled:
            return
        ts = int((t_begin - self._t0) * 1e6)
        ev = {"name": name, "ph": "X", "cat": cat, "pid": self.pid,
              "tid": tid, "ts": ts,
              "dur": int((t_end - self._t0) * 1e6) - ts}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, *, tid: int = 0, cat: str = "engine",
                **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "i", "s": "t", "cat": cat,
                    "pid": self.pid, "tid": tid, "ts": self.now_us(),
                    **({"args": args} if args else {})})

    def counter(self, name: str, values: dict, *, tid: int = 0,
                cat: str = "engine") -> None:
        """A Perfetto counter-track sample (``values`` are the series)."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C", "cat": cat, "pid": self.pid,
                    "tid": tid, "ts": self.now_us(),
                    "args": {k: float(v) for k, v in values.items()}})

    def thread_name(self, tid: int, name: str) -> None:
        """Label a track (metadata event; Perfetto shows it as the row
        title instead of a bare tid)."""
        if not self.enabled:
            return
        self._emit({"name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "ts": 0, "args": {"name": name}})

    # -- export -------------------------------------------------------------

    def export(self, path: Optional[str] = None) -> dict:
        """The trace as ``{"traceEvents": [...]}``; written to ``path``
        as JSON when given.  Loadable by chrome://tracing / Perfetto."""
        trace = {"traceEvents": list(self.events),
                 "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace


#: what a disabled recorder's ``span`` returns: enters and exits at no cost
_NO_SPAN = contextlib.nullcontext()

_REQUIRED = ("name", "ph", "pid", "tid", "ts")


def validate_trace(trace: dict) -> dict:
    """Schema-check an exported trace; raises ValueError on violations.

    Checks (the CI gate for ``serving_load.py --trace``):

    * non-empty ``traceEvents`` with the required fields per event,
    * integer, globally non-decreasing timestamps (monotonic clock),
    * B/E spans balanced LIFO per (pid, tid) track with matching names,
    * every request track (events with ``cat == "request"``) carries at
      least one complete (begun *and* ended) span.

    Returns summary stats: event/span counts, tracks, request tracks.
    """
    events = trace.get("traceEvents")
    if not events:
        raise ValueError("trace has no traceEvents")
    last_ts = None
    stacks: dict[tuple, list] = {}
    spans = 0
    request_tids: set = set()
    complete_request_tids: set = set()
    for i, ev in enumerate(events):
        for field in _REQUIRED:
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ts = ev["ts"]
        if not isinstance(ts, int):
            raise ValueError(f"event {i} ts is not an integer: {ts!r}")
        ph = ev["ph"]
        if ph == "M":                      # metadata is timeless
            continue
        if last_ts is not None and ts < last_ts:
            raise ValueError(
                f"event {i} ts {ts} < previous {last_ts}: timestamps "
                "must be non-decreasing")
        last_ts = ts
        track = (ev["pid"], ev["tid"])
        if ev.get("cat") == "request":
            request_tids.add(ev["tid"])
        if ph == "B":
            stacks.setdefault(track, []).append(ev)
        elif ph == "E":
            stack = stacks.get(track)
            if not stack:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} on track {track} "
                    "without a matching B")
            top = stack.pop()
            if top["name"] != ev["name"]:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} closes B "
                    f"{top['name']!r} on track {track} (spans must "
                    "nest LIFO)")
            spans += 1
            if ev.get("cat") == "request":
                complete_request_tids.add(ev["tid"])
        elif ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(f"event {i}: X {ev['name']!r} has no "
                                 f"non-negative integer dur: {dur!r}")
            spans += 1
            if ev.get("cat") == "request":
                complete_request_tids.add(ev["tid"])
        elif ph not in ("i", "C"):
            raise ValueError(f"event {i}: unknown ph {ph!r}")
    unbalanced = {t: [e["name"] for e in s]
                  for t, s in stacks.items() if s}
    if unbalanced:
        raise ValueError(f"unclosed B spans: {unbalanced}")
    missing = request_tids - complete_request_tids
    if missing:
        raise ValueError(
            f"request tracks without a complete span: {sorted(missing)}")
    return {"n_events": len(events), "n_spans": spans,
            "n_tracks": len({(e['pid'], e['tid']) for e in events}),
            "n_request_tracks": len(request_tids)}
