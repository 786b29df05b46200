"""`repro_torch.obs` — unified observability for the CUTIE serving stack.

Three legs, one subsystem (see also the README's Observability section):

* **in-kernel stats** — the conv kernels optionally emit integer
  switching counters (zero-trit counts, window-toggle accumulators)
  next to their activations, so `StatsTracer`/`SwitchingTracer` rows and
  `energy_uj` come off the fused fast path instead of forcing per-layer
  execution (that leg lives in `repro_torch.kernels` +
  `repro_torch.pipeline.tracer`),
* **request-lifecycle tracing** — :class:`TraceRecorder` captures
  submit -> queue -> schedule -> batch -> prefill/decode/execute ->
  stream spans plus jit-compile and prefix-cache events, exported as
  Chrome/Perfetto trace-event JSON (``engine.trace_export(path)``),
* **metrics** — :class:`MetricsRegistry` is the one counters/gauges/
  histograms sink every component publishes into, with ``snapshot()``
  and Prometheus text export.

:class:`Observability` bundles a recorder and a registry; the serving
engine owns one and hands it to its executors (``Executor.bind_obs``).
``NULL`` is the disabled instance components default to, so
instrumentation costs nothing until an engine turns it on.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import (COUNT_BUCKETS, DEFAULT_BUCKETS,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import TraceRecorder, validate_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "COUNT_BUCKETS",
    "TraceRecorder", "validate_trace", "Observability", "NULL",
]


class Observability:
    """One trace recorder + one metrics registry, enabled together."""

    def __init__(self, *, trace: bool = True, clock=None,
                 max_events: int = 1_000_000):
        kwargs = {"clock": clock} if clock is not None else {}
        self.trace = TraceRecorder(enabled=trace, max_events=max_events,
                                   **kwargs)
        self.metrics = MetricsRegistry()
        self.enabled = trace

    def trace_export(self, path: Optional[str] = None) -> dict:
        return self.trace.export(path)


#: The no-op sink: components instrument against ``obs = NULL`` until an
#: engine binds a live instance, so standalone use records nothing.
NULL = Observability(trace=False)
