"""Batch executors: how a scheduled batch becomes results.

An :class:`Executor` is one registered model's execution strategy.  The
engine asks it for free capacity (so the scheduler can size batches),
hands it the admitted requests, and gets back an
:class:`ExecutionReport` — completions plus batch accounting.  Two
families:

* one-shot (`ProgramExecutor`): a request completes in a single call —
  the CUTIE CNN case, one whole-program pipeline run per batch;
* resident (the LLM decode loop in `repro_torch.serving.llm`): a
  request occupies a slot across many calls and completes later, so
  ``execute`` may return fewer completions than it was handed and
  ``has_resident()`` keeps the engine stepping while work is in flight.

`ProgramExecutor` pads live requests up to a small fixed set of batch
sizes (**buckets**) before running the pipeline, so the number of
program variants (input shapes the pipeline has run) is bounded by
``len(buckets)`` no matter what batch sizes the load produces, and
steady-state batches stay full instead of flushing every slot each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs


@dataclasses.dataclass
class ExecutionReport:
    """What one executor call did, for the engine's accounting."""

    completions: list                # [(uid, result), ...] finished now
    live: int                        # real requests in the executed batch
    padded: int                      # batch size actually executed
    rows: Any = None                 # tracer rows for this batch, if any
    energy_uj: Optional[float] = None  # per-inference switching energy
    per_device_live: Optional[list] = None  # live slots per data-parallel dev
    tokens_generated: Optional[dict] = None  # {uid: tokens emitted this
    #                                          step} for token-at-a-time
    #                                          executors (LLM decode loops);
    #                                          None for one-shot executors


class Executor:
    """One registered model's execution strategy.

    ``obs`` is the observability sink (`repro_torch.obs.Observability`) the
    executor emits trace spans and metrics into; it defaults to the
    module-level no-op `repro_torch.obs.NULL`, and the serving engine rebinds
    it (``bind_obs``) at registration so standalone executors cost
    nothing while engine-owned ones share the engine's recorder.
    """

    obs = _obs.NULL

    def bind_obs(self, obs) -> None:
        self.obs = obs

    def validate(self, value):
        """Canonicalize one submitted input; raise on bad requests.

        Runs at submit time so malformed requests fail at the caller,
        not inside a later batch that would take down its batchmates.
        """
        return value

    def free_capacity(self) -> int:
        """How many new requests the next execute() call can admit."""
        raise NotImplementedError

    def has_resident(self) -> bool:
        """True while previously admitted requests are still in flight."""
        return False

    def evict(self, uid: int) -> bool:
        """Forget any resident/partial state held for request ``uid``.

        The engine calls this on the failure paths (retry, bisect,
        quarantine, timeout) before a request leaves the executor, so a
        later re-admission never collides with leaked state.  One-shot
        executors hold none; returns True when something was released.
        """
        return False

    def extra_stats(self) -> Optional[dict]:
        """Executor-specific accounting merged into ``engine.stats()``
        (e.g. the paged-state block/prefix counters); None to omit."""
        return None

    def execute(self, requests) -> ExecutionReport:
        raise NotImplementedError


DEFAULT_BUCKETS = (1, 2, 4, 8)

_TRITS = (-1, 0, 1)


class ProgramExecutor(Executor):
    """Bucketed whole-program executor over a `CutiePipeline`.

    A batch of live requests is padded with zero images up to the
    smallest bucket that fits, sent to the pipeline's device as one
    tensor, executed as one pipeline run and sliced back — at most
    ``len(buckets)`` program variants per tracer configuration, full
    batches in the loaded steady state.

    ``head``: optional host-side callable mapping one request's final
    trit array to its response.  ``tracer``: a pipeline Tracer whose
    per-batch rows ride back on the ExecutionReport; a SwitchingTracer
    additionally prices each batch with the calibrated energy model
    (per-inference switching energy, padding slots included).

    ``mesh``: a mesh spec (see
    :class:`repro_torch.launch.cutie_mesh.MeshSpec`) for multi-device
    execution over the ranks of an initialized process group.  The
    pipeline is rebound onto the mesh (unless it is already meshed), and
    every bucket is rounded up to a multiple of the pipeline's batch
    quantum so each executed batch splits evenly across ranks;
    per-device occupancy rides back on the ExecutionReport for
    ``engine.stats()``.  Every rank runs its own engine on the same
    requests, in the same order.
    """

    def __init__(self, pipeline, *, buckets: Optional[Sequence[int]] = None,
                 head: Optional[Callable] = None, tracer=None, mesh=None):
        if mesh is not None and getattr(pipeline, "mesh_spec", None) is None:
            from repro_torch.pipeline import CutiePipeline

            pipeline = CutiePipeline(pipeline.program,
                                     backend=pipeline.backend,
                                     device=pipeline.device, mesh=mesh)
        self.pipeline = pipeline
        self.mesh_spec = getattr(pipeline, "mesh_spec", None)
        if self.mesh_spec is not None and tracer is not None:
            # fail at registration, not inside a later batch that would
            # take down its batchmates (see validate()'s contract)
            raise NotImplementedError(
                "tracers are not supported on meshed pipelines yet; "
                "register without mesh= to trace stats/energy")
        self.data_parallel = self.mesh_spec.data if self.mesh_spec else 1
        buckets = tuple(sorted(set(buckets or DEFAULT_BUCKETS)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, "
                             f"got {buckets}")
        # round buckets so every executed batch splits evenly across the
        # mesh: the data-parallel degree, times the microbatch count on
        # pipeline-parallel (layer) meshes
        dp = getattr(pipeline, "batch_quantum", 1) or 1
        self.buckets = tuple(sorted({-(-b // dp) * dp for b in buckets}))
        self.head = head
        self.tracer = tracer
        self._shape: Optional[tuple] = None      # (H, W, C), set on first submit
        self._energy_params = None

    # -- engine protocol ----------------------------------------------------

    def free_capacity(self) -> int:
        return self.buckets[-1]

    def validate(self, value) -> np.ndarray:
        """Trit-domain validation: (H, W, C), values in {-1, 0, +1},
        int8-coercible — rejected with a clear error, never silently cast."""
        arr = np.asarray(value)
        if arr.ndim != 3:
            raise ValueError(f"expected (H, W, C) trit image, "
                             f"got {arr.shape}")
        if self._shape is None:
            self._shape = arr.shape
        elif arr.shape != self._shape:
            raise ValueError(f"image {arr.shape} does not match serving "
                             f"shape {self._shape}")
        if arr.dtype.kind not in "biuf":
            raise TypeError(f"trit image must be numeric, "
                            f"got dtype {arr.dtype}")
        if arr.dtype.kind == "f" and (not np.all(np.isfinite(arr))
                                      or np.any(arr != np.rint(arr))):
            raise ValueError(
                "trit image is not int8-coercible: non-integral float "
                "values (quantize to {-1, 0, +1} before submitting)")
        ok = np.isin(arr, _TRITS)
        if not ok.all():
            bad = np.unique(np.asarray(arr)[~ok])[:5]
            raise ValueError(f"trit image values must be in "
                             f"{{-1, 0, +1}}, got {bad.tolist()}")
        return arr.astype(np.int8)

    def execute(self, requests) -> ExecutionReport:
        live = len(requests)
        size = self.bucket_for(live)
        if self._shape is None:
            # hot-swapped in with traffic already queued: the requests
            # were validated by the predecessor, so lock to their shape
            self._shape = tuple(requests[0].value.shape)
        batch = np.zeros((size,) + self._shape, np.int8)
        for i, req in enumerate(requests):
            batch[i] = req.value
        variants_before = self.pipeline.n_jit_variants
        out = self.pipeline.run(
            torch.from_numpy(batch).to(self.pipeline.device),
            tracer=self.tracer)
        if self.pipeline.n_jit_variants > variants_before:
            # a new program variant ran inside this batch (on `fused`, a
            # program built for its shape) — the latency outlier a trace
            # should be able to explain
            self.obs.trace.instant(
                "jit_compile", cat="jit", bucket=size,
                n_variants=self.pipeline.n_jit_variants)
            self.obs.metrics.counter(
                "jit_compiles_total",
                "jit specializations compiled during serving").inc()
        rows = None
        if self.tracer is not None:
            out, rows = out
        feats = out.cpu().numpy()[:live]
        completions = [
            (req.uid, self.head(feats[i]) if self.head is not None
             else feats[i])
            for i, req in enumerate(requests)]
        return ExecutionReport(completions, live, size, rows=rows,
                               energy_uj=self._price(rows),
                               per_device_live=self._per_device_live(live,
                                                                     size))

    @property
    def pipeline_schedule(self) -> Optional[dict]:
        """Static pipeline-parallel schedule accounting (stage count,
        per-stage occupancy, bubble fraction) for layer-sharded models;
        None otherwise.  Rides into ``engine.stats()["sharding"]``."""
        sharded = getattr(self.pipeline, "_sharded", None)
        if sharded is None or not hasattr(sharded, "schedule_stats"):
            return None
        return sharded.schedule_stats()

    def _per_device_live(self, live: int, size: int) -> Optional[list]:
        """Live slots landing on each data-parallel device (batch shards
        are contiguous, so live requests fill the leading shards)."""
        dp = self.data_parallel
        if dp <= 1:
            return None
        per = size // dp
        return [min(max(live - k * per, 0), per) for k in range(dp)]

    # -- internals ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding n requests (n bounded by capacity)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _price(self, rows) -> Optional[float]:
        """Per-inference switching energy when tracing with SwitchingTracer."""
        from repro_torch.pipeline.tracer import SwitchingTracer

        if rows is None or not isinstance(self.tracer, SwitchingTracer):
            return None
        from repro_torch.energy import model as E

        if self._energy_params is None:
            self._energy_params = E.EnergyParams(
                self.pipeline.program.instance.technology)
        return E.network_energy(rows, self._energy_params)["energy_uj"]

    @property
    def n_jit_variants(self) -> int:
        return self.pipeline.n_jit_variants
