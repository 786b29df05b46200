"""Deterministic fault injection + the serving resilience policy.

CUTIE's deployment story is an always-on engine draining its layer FIFO
with the host asleep (paper Fig. 3); always-on means the host-side
serving plane has to *survive* — a flaky executor, a poison request, a
wedged model, a killed process — not just benchmark well.  This module
is the failure half of that contract:

* :class:`FaultPlan` — a **seeded, O(1)-memory** schedule of injected
  faults.  Every decision is a counter-indexed draw from
  ``np.random.default_rng([seed, stream, index])``, so the same plan
  object produces the same fault at executor call ``i`` (and the same
  poison verdict for request ``r``) across processes, runs and hosts —
  which is what makes the recovery paths testable and benchmarkable
  (the reference's ``benchmarks/fault_injection.py``).
* :class:`FaultyExecutor` — wraps any :class:`~repro_torch.serving.executors.
  Executor` and applies a plan at the execute() boundary: transient
  raises, simulated device loss, slow steps, NaN/garbage outputs, and
  poison requests that opaquely fail any batch containing them (the
  engine has to *bisect* to find them — the error names no uids).
* :class:`FaultPolicy` — the engine-side recovery knobs: retry budget +
  capped exponential backoff, consecutive-failure quarantine (with
  optional cooldown), output guarding, queue-depth load shedding and
  pressure degradation.
* the named errors the recovery paths raise at callers
  (:class:`LoadShedError`, :class:`ModelQuarantinedError`,
  :class:`RequestTimeout`, ...).

Injected faults are priced into `repro_torch.obs` (``faults_injected_total``
counters + ``fault_injected`` trace instants) so a trace of a chaos run
shows *when* each fault landed next to *how* the engine recovered.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np

from repro_torch.serving.executors import Executor

# -- named errors -----------------------------------------------------------


class TransientFault(RuntimeError):
    """A failure worth retrying as-is (whole batch, capped backoff)."""


class DeviceLost(TransientFault):
    """Simulated accelerator loss; transient from the engine's view
    (the executor owns re-initialization), but repeated losses drive
    the consecutive-failure counter into quarantine."""


class PoisonedRequestError(RuntimeError):
    """A batch failed because of one of its requests.

    Deliberately opaque — it names no uids — so recovery cannot cheat:
    the engine must bisect the batch to isolate the culprit.
    """


class GarbageOutputError(RuntimeError):
    """An executor returned non-finite results (caught by the engine's
    output guard and retried; raised at the handle after the budget)."""


class LoadShedError(RuntimeError):
    """Admission refused: the engine is over its queue-depth cap or the
    request's deadline cannot be met.  Raised by ``submit()``."""


class ModelQuarantinedError(RuntimeError):
    """Submission routed to a quarantined model with no usable
    fallback registered."""


class RequestTimeout(TimeoutError):
    """A request exceeded its per-request ``timeout=`` budget."""


# -- recovery policy --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Engine-side resilience knobs (see `CutieEngine(policy=...)`).

    The defaults are conservative: retries and quarantine on, no load
    shedding (caps are opt-in because they change admission behavior).
    """

    max_retries: int = 3          # per-request failure budget
    backoff_base: float = 0.02    # first retry delay (seconds)
    backoff_cap: float = 1.0      # exponential backoff ceiling
    quarantine_after: Optional[int] = 5   # consecutive executor failures
    #                               before a model is quarantined (None: never)
    quarantine_cooldown: Optional[float] = None  # auto-reinstate after
    #                               this many seconds (None: manual reinstate)
    guard_outputs: bool = True    # treat non-finite results as failures
    max_queue_depth: Optional[int] = None   # shed submits past this depth
    shed_on_deadline: bool = False  # shed submits whose deadline the
    #                               current backlog provably misses
    pressure_queue_depth: Optional[int] = None  # force spec_k=0 (degrade
    #                               speculation) past this depth

    def backoff(self, retries: int) -> float:
        """Delay before retry number ``retries`` (1-based)."""
        return min(self.backoff_base * (2 ** max(retries - 1, 0)),
                   self.backoff_cap)


# -- the fault plan ---------------------------------------------------------

FAULT_KINDS = ("raise", "slow", "nan", "poison", "device_loss")


def _stable_int(key) -> int:
    """Deterministic int for seeding: ints pass through, strings hash."""
    if isinstance(key, str):
        return int.from_bytes(
            hashlib.sha1(key.encode()).digest()[:4], "little")
    return int(key)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of injected faults.

    Per-call faults (``raise_rate``/``slow_rate``/``nan_rate``) are
    drawn independently at each executor call index from a counter-
    keyed PRNG stream — no mutable state, so determinism survives
    process restarts and concurrent executors.  ``device_loss_at``
    opens a window of ``device_loss_calls`` consecutive losses (the
    shape that exercises quarantine).  Poison is a *per-request*
    property: ``poisoned(req)`` keys on the request's ``tag`` when set
    (stable across runs whose uid assignment differs, e.g. under load
    shedding), else its uid.
    """

    seed: int = 0
    raise_rate: float = 0.0
    slow_rate: float = 0.0
    nan_rate: float = 0.0
    poison_rate: float = 0.0
    slow_s: float = 0.02          # injected slow-step duration
    device_loss_at: Optional[int] = None   # first lost executor call
    device_loss_calls: int = 0             # consecutive lost calls
    start_after: int = 0          # calls before any rate-based fault
    #                               (lets jit warmup run clean)

    def __post_init__(self):
        total = self.raise_rate + self.slow_rate + self.nan_rate
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"raise+slow+nan rates sum to {total:.3f} > 1")
        for name in ("raise_rate", "slow_rate", "nan_rate", "poison_rate"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")

    def fault_for(self, call_idx: int) -> Optional[str]:
        """The fault injected at executor call ``call_idx`` (or None)."""
        if self.device_loss_at is not None and \
                self.device_loss_at <= call_idx < \
                self.device_loss_at + self.device_loss_calls:
            return "device_loss"
        if call_idx < self.start_after:
            return None
        u = float(np.random.default_rng(
            [self.seed, 1, int(call_idx)]).random())
        edge = 0.0
        for kind, rate in (("raise", self.raise_rate),
                           ("slow", self.slow_rate),
                           ("nan", self.nan_rate)):
            edge += rate
            if u < edge:
                return kind
        return None

    def poisoned(self, req) -> bool:
        """Whether ``req`` (a Request, or a bare uid/tag key) is poison."""
        if self.poison_rate <= 0:
            return False
        tag = getattr(req, "tag", None)
        key = tag if tag is not None else getattr(req, "uid", req)
        u = float(np.random.default_rng(
            [self.seed, 2, _stable_int(key)]).random())
        return u < self.poison_rate

    def schedule(self, n: int) -> list:
        """The first ``n`` per-call fault decisions (determinism tests)."""
        return [self.fault_for(i) for i in range(n)]


# -- the wrapping executor --------------------------------------------------


class FaultyExecutor(Executor):
    """Wrap an executor and apply a :class:`FaultPlan` at its execute()
    boundary.  Everything else — validation, capacity, residency,
    eviction, snapshot/restore — delegates to the wrapped executor, so
    the engine (and the registry) see a drop-in model.

    Fault semantics at call ``i`` (in precedence order):

    * any poisoned request in the batch -> :class:`PoisonedRequestError`
      (opaque; inner executor untouched, so its state never partially
      mutates);
    * ``device_loss`` / ``raise`` -> :class:`DeviceLost` /
      :class:`TransientFault`, again *before* the inner call;
    * ``slow`` -> sleep ``plan.slow_s`` then execute normally;
    * ``nan`` -> execute normally, then corrupt every array-valued
      completion to NaNs (exercises the engine's output guard; token-
      list completions pass through untouched).
    """

    def __init__(self, inner: Executor, plan: FaultPlan, *,
                 sleeper=time.sleep):
        self.inner = inner
        self.plan = plan
        self.sleeper = sleeper
        self.calls = 0
        self.injected = {kind: 0 for kind in FAULT_KINDS}

    # -- delegation ---------------------------------------------------------

    def bind_obs(self, obs) -> None:
        self.obs = obs
        self.inner.bind_obs(obs)

    def validate(self, value):
        return self.inner.validate(value)

    def free_capacity(self) -> int:
        return self.inner.free_capacity()

    def has_resident(self) -> bool:
        return self.inner.has_resident()

    def evict(self, uid: int) -> bool:
        return self.inner.evict(uid)

    def extra_stats(self) -> Optional[dict]:
        stats = dict(self.inner.extra_stats() or {})
        if any(self.injected.values()):
            stats["faults_injected"] = dict(self.injected)
        return stats or None

    def __getattr__(self, item):
        # snapshot()/restore()/n_jit_variants/... fall through to the
        # wrapped executor; only fires for names not defined here
        return getattr(self.inner, item)

    # -- the faulty boundary ------------------------------------------------

    def _record(self, kind: str, call_idx: int) -> None:
        self.injected[kind] += 1
        self.obs.trace.instant("fault_injected", cat="fault",
                               kind=kind, call=call_idx)
        self.obs.metrics.counter(
            "faults_injected_total",
            "faults injected by FaultyExecutor").inc(kind=kind)

    def execute(self, requests):
        call_idx = self.calls
        self.calls += 1
        if any(self.plan.poisoned(r) for r in requests):
            self._record("poison", call_idx)
            raise PoisonedRequestError(
                f"executor rejected a batch of {len(requests)}: a "
                "request in it produced an unrecoverable execution error")
        kind = self.plan.fault_for(call_idx)
        if kind == "device_loss":
            self._record(kind, call_idx)
            raise DeviceLost(
                f"simulated device loss at executor call {call_idx}")
        if kind == "raise":
            self._record(kind, call_idx)
            raise TransientFault(
                f"injected transient failure at executor call {call_idx}")
        if kind == "slow":
            self._record(kind, call_idx)
            self.sleeper(self.plan.slow_s)
            return self.inner.execute(requests)
        report = self.inner.execute(requests)
        if kind == "nan" and report.completions:
            corrupted = False
            out = []
            for uid, res in report.completions:
                if isinstance(res, np.ndarray):
                    res = np.full(res.shape, np.nan, np.float32)
                    corrupted = True
                out.append((uid, res))
            report.completions = out
            if corrupted:
                self._record(kind, call_idx)
        return report
