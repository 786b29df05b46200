"""Host-side background prefetch of batches.

`Prefetcher` overlaps host-side batch synthesis with device compute by one
step (double buffering on a worker thread) — the data-pipeline half of the
paper's "loading phase overlaps with execution phase" scheduling (Fig. 3).

The reference's `make_global` (placing a batch on a device mesh) waits for
``mesh=`` execution and raises.
"""

from __future__ import annotations

import queue
import threading


def make_global(batch_np: dict, mesh, pspecs: dict) -> dict:
    """Not ported yet: mesh placement of a batch."""
    raise NotImplementedError(
        "data.pipeline.make_global is not ported yet: see ROADMAP.md, "
        "'Modules still to port', item 9 (launch/cutie_mesh.py on "
        "torch.distributed)")


class Prefetcher:
    """One-step-lookahead prefetch of a `fn(step) -> batch` source."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            try:
                item = (step, self._fn(step))
            except Exception as e:  # propagate to consumer
                self._q.put(("error", e))
                return
            self._q.put(item)
            step += 1

    def get(self) -> tuple[int, dict]:
        item = self._q.get()
        if item[0] == "error":
            raise item[1]
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
