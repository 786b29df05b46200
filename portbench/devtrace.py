"""A traced window's device operations, from ``torch.profiler``'s CUDA
activity (CUPTI), reduced to sums: busy time, time by operation, the
device time of named kernels, and the idle gaps with the harness span
that the host had open in each."""

from __future__ import annotations

import time

import torch

TOP = 10


def _ns(ev, name: str) -> int:
    f = getattr(ev, f"{name}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{name}_us")()
                                               * 1000)


class DeviceTrace:
    """``start()`` .. ``stop()`` around a window; afterwards ``events``
    holds (name, start_s, end_s) of every device operation, times on
    time.perf_counter."""

    def __init__(self) -> None:
        self.events: list[tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        # the profiler stamps operations on the wall clock (ns since the
        # epoch); the harness's spans are on time.perf_counter
        self._shift_ns = time.perf_counter_ns() - time.time_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(ev.name(), _ns(ev, "start"), _ns(ev, "duration"))
               for ev in self._prof.profiler.kineto_results.events()
               if ev.device_type() == cuda]
        self._prof = None
        self.events = self._align(raw)

    def _align(self, raw) -> list[tuple[str, float, float]]:
        """The profiler's wall-clock stamps on time.perf_counter; an
        operation stamped outside the window means the clocks disagree."""
        k = self._shift_ns
        out = [(n, (s + k) / 1e9, (s + d + k) / 1e9) for n, s, d in raw]
        off = [s for _, s, _ in out if not self.t0 - 0.5 <= s <= self.t1 + 0.5]
        if off:
            raise RuntimeError(
                f"{len(off)} of {len(out)} device operations are stamped "
                f"outside the traced window (one at {off[0] - self.t0:+.3f} s "
                "from its start): the profiler's clock is not the wall clock")
        return out

    # -- reductions -------------------------------------------------------

    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the operations' intervals, clipped to the window."""
        out: list[list[float]] = []
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, parts) -> float:
        """Summed device time of the operations whose name holds one of
        ``parts``."""
        return sum(min(e, self.t1) - max(s, self.t0)
                   for n, s, e in self.events
                   if any(p in n for p in parts)
                   and min(e, self.t1) > max(s, self.t0))

    def top_ops(self) -> list[list]:
        tot: dict[str, float] = {}
        for n, s, e in self.events:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n[:200], t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self, spans) -> list[list]:
        """The longest idle gaps, each named by the harness span open at
        its midpoint (``spans``: (name, start_s, end_s), innermost last
        wins)."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:TOP]:
            mid, name = (a + b) / 2, "none"
            for n, s, e in spans:
                if s <= mid <= e:
                    name = n
            out.append([name, b - a])
        return out
