"""The bulk loop: one client scores an image pool in calls of ``batch``
images, keeping ``in_flight`` calls enqueued before it reads the oldest
result back on the host.

Per call the host copies its images (pinned) to the device, the program
enqueues its work, and the class scores are copied back into pinned host
memory; an event marks the copy's end.  A call's result has reached the
host when its event has completed.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench import traffic as TR


class _Done:
    """A stand-in for a CUDA event on the CPU, where every copy is done
    when it returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _event(device):
    return torch.cuda.Event() if device.type == "cuda" else _Done()


class Loop:
    def __init__(self, system, traffic: dict, sizes: dict, seed: int,
                 device):
        self.program, self.traffic, self.device = system, traffic, device
        self.batch = traffic["batch"]
        pool = TR.image_pool(traffic, sizes, seed, device)
        if pool.shape[0] % self.batch:
            raise ValueError("pool_images must be a multiple of batch")
        self.pool_host = pool.cpu()
        if device.type == "cuda":
            self.pool_host = self.pool_host.pin_memory()
        self.n_chunks = pool.shape[0] // self.batch
        ring = traffic["in_flight"] + 1
        out = torch.empty((ring, self.batch, sizes["n_classes"]),
                          dtype=torch.int8)
        self.out = out.pin_memory() if device.type == "cuda" else out
        self.calls: list[dict] = []
        self.spans: list[tuple] = []
        self.results: list[np.ndarray] = []

    def _enqueue(self, i: int) -> dict:
        t0 = time.perf_counter()
        c = i % self.n_chunks
        x = self.pool_host[c * self.batch:(c + 1) * self.batch].to(
            self.device, non_blocking=True)
        y = self.program(x)
        buf = self.out[i % self.out.shape[0]]
        buf.copy_(y, non_blocking=True)
        ev = _event(self.device)
        ev.record()
        t1 = time.perf_counter()
        self.spans.append(("enqueue", t0, t1))
        return {"i": i, "chunk": c, "event": ev, "buf": buf,
                "t_submit": t0, "t_enqueued": t1}

    def _read(self, call: dict) -> None:
        t0 = time.perf_counter()
        call["event"].synchronize()
        call["t_done"] = time.perf_counter()
        self.spans.append(("wait", t0, call["t_done"]))
        self.results.append(call.pop("buf").numpy().copy())
        del call["event"]
        self.calls.append(call)

    def warmup(self) -> None:
        """Every shape the window uses: one call size, ``in_flight`` deep,
        twice round the ring."""
        q = deque()
        for i in range(2 * self.out.shape[0]):
            q.append(self._enqueue(i))
            if len(q) >= self.traffic["in_flight"]:
                self._read(q.popleft())
        while q:
            self._read(q.popleft())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.calls, self.spans, self.results = [], [], []

    def window(self, seconds: float, trace=None, trace_s: float = 0.0
               ) -> dict:
        q, i = deque(), 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        trace_end = t_start + trace_s if trace is not None else None
        while time.perf_counter() < t_end:
            q.append(self._enqueue(i))
            i += 1
            if len(q) >= self.traffic["in_flight"]:
                self._read(q.popleft())
            if trace_end is not None and time.perf_counter() >= trace_end:
                trace.stop()
                trace_end = None
        if trace_end is not None:
            trace.stop()
        while q:
            self._read(q.popleft())
        return {"t_start": t_start, "t_end": t_end, "seconds": seconds}

    def close(self) -> None:
        self.program = None

    def tally(self, t_end: float) -> tuple[int, int]:
        """(images attempted in the window, images never answered); a
        call that raised ends the run instead."""
        return sum(self.batch for _ in self.calls), 0
