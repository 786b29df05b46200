"""Host->device pipeline: mesh placement of a batch + background prefetch.

`make_global(batch_np, mesh, pspecs)` gives this rank its part of each
batch leaf under the batch partition specs (its rows over the mesh's
batch axes), as tensors on its device.  In the reference that is
`jax.make_array_from_process_local_data`; here one process runs per
mesh position, so each rank keeps its own slice of the global batch.

`Prefetcher` overlaps host-side batch synthesis with device compute by one
step (double buffering on a worker thread) — the data-pipeline half of the
paper's "loading phase overlaps with execution phase" scheduling (Fig. 3).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.core import placement as PL


def make_global(batch_np: dict, mesh, pspecs: dict) -> dict:
    """Each leaf of ``batch_np`` (numpy arrays or tensors, global) cut to
    this rank's slice under ``pspecs`` (a missing key: replicated), on
    ``mesh.device``.  Axes that do not divide a dimension drop, as
    `shardings.fit_named` drops them."""
    out = {}
    for k, v in batch_np.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        spec = PL.fits(PL.resolve(pspecs.get(k, PL.P()), mesh),
                       tuple(t.shape), mesh)
        out[k] = PL.shard_leaf(t, spec, mesh).to(mesh.device).contiguous()
    return out


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
