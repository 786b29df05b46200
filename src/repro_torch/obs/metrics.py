"""Unified metrics registry: counters, gauges, histograms, one export.

Before this module every layer of the serving stack reported numbers its
own way — ``engine.stats()`` hand-merged dicts, ``Executor.extra_stats()``
returned ad-hoc nested mappings, the paged-state block/prefix counters
lived on the executor.  :class:`MetricsRegistry` is the one sink they all
publish into:

* :class:`Counter` — monotonically increasing totals (requests served,
  switching energy spent, prefix-cache evictions),
* :class:`Gauge` — last-write-wins instantaneous values (queue depth,
  block occupancy),
* :class:`Histogram` — bucketed distributions (request latency, queue
  time, batch occupancy) with Prometheus-style cumulative buckets.

All three take free-form ``**labels`` so one metric family covers every
model/executor (``requests_completed{model="cnn"}``).  Components that
own derived state register a *collector* callback (:meth:`collect`);
``snapshot()`` runs the collectors first, so gauges computed from live
objects (pool occupancy, jit-variant counts) are fresh at read time.
Re-registering a collector under the same key replaces it — hot-swapping
a model does not leak its predecessor's callback.

Exports: :meth:`snapshot` (nested plain-python dict, for tests and
``engine.stats()``) and :meth:`prometheus_text` (the text exposition
format, scrape-ready).  Pure python, no deps, safe to call from traced
code's host side only.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

#: Default histogram buckets (seconds-flavoured: 1ms .. 10s).
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: Buckets for small-integer counts (accepted speculative tokens, batch
#: fill, retry counts): exact through 8, coarse to 64.
COUNT_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0,
                 12.0, 16.0, 24.0, 32.0, 48.0, 64.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_text(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Shared labelled-series plumbing for the three metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def labels(self) -> list[tuple]:
        return sorted(self._series)


class Counter(_Metric):
    """Monotonically increasing total; ``inc`` rejects negative deltas."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        got = self._series.get(_label_key(labels))
        return None if got is None else float(got)


class Histogram(_Metric):
    """Fixed-bucket distribution with Prometheus cumulative semantics."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = {"counts": [0] * (len(self.buckets) + 1),
                 "sum": 0.0, "count": 0}
            self._series[key] = s
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        s["counts"][i] += 1           # last slot == +Inf overflow
        s["sum"] += float(value)
        s["count"] += 1

    def summary(self, **labels) -> Optional[dict]:
        s = self._series.get(_label_key(labels))
        if s is None:
            return None
        return {"count": s["count"], "sum": s["sum"],
                "mean": s["sum"] / s["count"] if s["count"] else math.nan,
                "buckets": dict(zip(self.buckets + (math.inf,),
                                    _cumulative(s["counts"])))}


def _cumulative(counts) -> list[int]:
    out, total = [], 0
    for c in counts:
        total += c
        out.append(total)
    return out


class MetricsRegistry:
    """The one sink: get-or-create metric families + keyed collectors."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: dict[str, Callable[[], None]] = {}

    # -- families (get-or-create; kind mismatches are bugs) -----------------

    def _family(self, cls, name: str, help: str, **kwargs):
        got = self._metrics.get(name)
        if got is None:
            got = cls(name, help, **kwargs)
            self._metrics[name] = got
        elif not isinstance(got, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{got.kind}, not {cls.kind}")
        return got

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    # -- collectors ---------------------------------------------------------

    def collect(self, key: str, fn: Callable[[], None]) -> None:
        """Register (or replace) a pre-snapshot callback under ``key``.

        Collectors publish gauges derived from live objects (block-pool
        occupancy, jit-variant counts) so snapshots read fresh values;
        keying them makes hot-swap replace instead of accumulate.
        """
        self._collectors[key] = fn

    def drop_collector(self, key: str) -> None:
        self._collectors.pop(key, None)

    def _run_collectors(self) -> None:
        for fn in list(self._collectors.values()):
            fn()

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """{metric: {kind, help, series: {label-text: value|summary}}}."""
        self._run_collectors()
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                series = {_label_text(k): m.summary(**dict(k))
                          for k in m.labels()}
            else:
                series = {_label_text(k): m.value(**dict(k))
                          for k in m.labels()}
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (scrape-ready)."""
        self._run_collectors()
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in m.labels():
                if isinstance(m, Histogram):
                    s = m.summary(**dict(key))
                    for le, cum in s["buckets"].items():
                        le_txt = "+Inf" if math.isinf(le) else repr(le)
                        bkey = key + (("le", le_txt),)
                        lines.append(
                            f"{name}_bucket{_label_text(bkey)} {cum}")
                    lines.append(
                        f"{name}_sum{_label_text(key)} {s['sum']}")
                    lines.append(
                        f"{name}_count{_label_text(key)} {s['count']}")
                else:
                    lines.append(
                        f"{name}{_label_text(key)} {m.value(**dict(key))}")
        return "\n".join(lines) + "\n"
