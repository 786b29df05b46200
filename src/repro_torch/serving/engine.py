"""`CutieEngine` — one scheduler-driven serving engine for the repo.

The CUTIE ASIC's serving story is a hardware engine draining a layer
FIFO autonomously while the host sleeps (paper Fig. 3).  This is the
host-side counterpart for heavy traffic: a single engine behind a

    submit -> schedule -> execute -> stream

lifecycle.  ``submit()`` validates a request against its model and
returns a :class:`~repro_torch.serving.request.RequestHandle`; a pluggable
:class:`~repro_torch.serving.scheduler.Scheduler` owns admission and batch
formation (FCFS / priority / deadline); an
:class:`~repro_torch.serving.executors.Executor` runs each admitted batch
(a bucketed CNN program run, or the LLM decode loop: prefill the
newcomers, one decode step for every resident slot); completed results
stream back through ``stream()`` / ``result()``.  A
:class:`~repro_torch.serving.registry.ModelRegistry` serves multiple
compiled programs and models concurrently with hot-swap.

Latency, queue-depth and tracer-derived switching-energy accounting are
first-class: every request is timestamped through its lifecycle and
``stats()`` aggregates p50/p95/p99 latency (overall and per tag),
queue-time, queue depth, batch occupancy, deadline hit-rate, jit-variant
counts and switching energy.

    engine = CutieEngine("deadline")
    engine.register("cnn", graph_or_program, backend="cuda")
    h = engine.submit(img, model="cnn", deadline=0.05)
    engine.register("llm", LLMExecutor(params, cfg, ServerConfig()))
    h = engine.submit(prompt_tokens, model="llm", deadline=0.05)
    y = h.result()                      # drives the engine
    for done in engine.stream():        # or: drain everything
        consume(done.uid, done.request.result)
    print(engine.stats()["latency"])

The engine is synchronous and step-driven — ``step()`` is one
schedule+execute round, and ``run()``/``stream()``/``result()`` are
loops over it — so serving, benchmarks and tests all drive the exact
same code path.

Failures are first-class (:mod:`repro_torch.serving.faults`): an executor
exception never propagates out of ``step()``.  Transient errors retry
with capped exponential backoff, opaque batch failures are *bisected*
to isolate poison requests (innocent batchmates complete), non-finite
outputs are guarded and retried, per-request ``timeout=`` budgets are
enforced, admission sheds load past the policy's queue caps, and a
model that fails repeatedly is quarantined (optionally rerouting its
traffic to a registered fallback) while everything else keeps serving.
The paged serving state itself is checkpointable — see
:mod:`repro_torch.serving.snapshot` for kill/restore with bit-identical
continuation.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.serving.executors import ProgramExecutor
from repro_torch.serving.faults import (FaultPolicy, GarbageOutputError,
                                        LoadShedError, ModelQuarantinedError,
                                        RequestTimeout, TransientFault)
from repro_torch.serving.registry import ModelRegistry
from repro_torch.serving.request import Request, RequestHandle, RequestStatus
from repro_torch.serving.scheduler import get_scheduler


def percentiles(samples, ps=(50, 95, 99)) -> dict:
    """{"p50": ..., "p95": ..., "p99": ...} (None when no samples)."""
    if not samples:
        return {f"p{p}": None for p in ps}
    arr = np.asarray(samples, np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def _garbage(result) -> bool:
    """Non-finite float output (the engine's output-guard predicate)."""
    try:
        arr = np.asarray(result)
    except Exception:
        return False
    if arr.dtype.kind != "f":
        return False
    return not bool(np.isfinite(arr).all())


class CutieEngine:
    """One serving engine: pluggable scheduler, multi-model, bucketed
    batches, first-class latency/energy accounting."""

    def __init__(self, scheduler="fcfs", *,
                 registry: Optional[ModelRegistry] = None,
                 clock=time.monotonic, history: int = 100_000,
                 trace: bool = True,
                 policy: Optional[FaultPolicy] = None,
                 sleep=time.sleep):
        self.registry = registry or ModelRegistry()
        self.scheduler = get_scheduler(scheduler)
        self.clock = clock
        # resilience: the policy holds the retry/quarantine/shedding
        # knobs; ``sleep`` is injectable so fake-clock tests never wait
        self.policy = policy or FaultPolicy()
        self.sleep = sleep
        # one observability sink for the whole engine: a request-
        # lifecycle trace recorder (``trace=False`` disables it; the
        # event buffer is bounded either way) + the metrics registry
        # every component publishes into.  Executors share it via
        # bind_obs at registration.
        self.obs = _obs.Observability(trace=trace, clock=clock)
        self.obs.trace.thread_name(0, "engine")
        self.obs.metrics.collect("engine", self._publish_metrics)
        self._requests: dict[int, Request] = {}
        self._handles: dict[int, RequestHandle] = {}
        self._completed: deque[RequestHandle] = deque()
        self._uid = 0
        self._seq = 0
        # accounting: counters are exact for the engine's lifetime; the
        # per-sample records (latency/queue-depth/batch rows) keep the
        # most recent ``history`` entries so a long-lived server's
        # memory stays bounded (see also evict_completed()).
        self.n_batches = 0
        self.n_cancelled = 0
        self.n_done = 0
        self.n_failed = 0
        # recovery state: batches awaiting a retry (they bypass the
        # scheduler so a bisected half re-executes exactly as isolated),
        # per-model consecutive-failure counts, quarantined models and
        # their registered fallbacks
        self._retry: list[tuple[float, str, list[Request]]] = []
        self._consec: dict[str, int] = {}
        self._quarantined: dict[str, float] = {}
        self._fallbacks: dict[str, str] = {}
        self._timed: set[int] = set()       # uids carrying a timeout=
        self.n_retries = 0
        self.n_shed = 0
        self.n_timed_out = 0
        self.n_degraded = 0
        self.n_quarantines = 0
        self.n_rerouted = 0
        self.batches: deque[dict] = deque(maxlen=history)
        self._queue_depth: deque[int] = deque(maxlen=history)
        # token-at-a-time executors (LLM decode loops) report per-step
        # emission counts; {model/tag: [tokens, steps]} turns those into
        # the tokens_per_step stat (> 1.0 under speculative decoding)
        self._tok_by_model: dict[str, list] = {}
        self._tok_by_tag: dict[str, list] = {}
        self._done: deque[Request] = deque(maxlen=history)
        self._energy_uj = 0.0
        self._energy_seen = False    # distinguishes a measured 0.0 from
        #                              "no executor ever priced a batch"

    # -- models -------------------------------------------------------------

    def register(self, name: str, source, *,
                 fallback: Optional[str] = None, **options):
        """Register (or hot-swap) a model; see ModelRegistry.register.

        ``fallback`` names another registered model that traffic for
        ``name`` reroutes to while ``name`` is quarantined.  Like
        hot-swap, the fallback must accept the same inputs.  Hot-
        swapping a quarantined model reinstates it (the replacement is
        presumed healthy).
        """
        executor = self.registry.register(name, source, **options)
        if fallback is not None:
            self._fallbacks[name] = fallback
        self._quarantined.pop(name, None)
        self._consec[name] = 0
        executor.bind_obs(self.obs)
        # keyed per model name: hot-swapping replaces the collector
        # instead of leaking the predecessor's callback
        self.obs.metrics.collect(f"executor:{name}",
                                 lambda: self._publish_executor(name))
        return executor

    def _publish_executor(self, name: str) -> None:
        """Gauge out one executor's ``extra_stats()`` numerics (the
        paged-state block/prefix counters of LLM executors)."""
        if name not in self.registry:
            return
        ex = self.registry[name]
        stats = ex.extra_stats()
        if stats:
            g = self.obs.metrics.gauge(
                "executor_stat", "executor-specific accounting "
                "(Executor.extra_stats values, numeric leaves)")
            for key, v in stats.items():
                if isinstance(v, (int, float)):
                    g.set(float(v), model=name, stat=key)
        if isinstance(ex, ProgramExecutor):
            self.obs.metrics.gauge(
                "jit_variants", "compiled jit specializations per model"
            ).set(ex.n_jit_variants, model=name)

    def _publish_metrics(self) -> None:
        """Engine-level gauges refreshed at every metrics snapshot."""
        m = self.obs.metrics
        m.gauge("queue_depth", "requests waiting in the scheduler").set(
            len(self.scheduler))
        m.gauge("requests_running", "requests admitted, not yet done").set(
            sum(1 for r in self._requests.values()
                if r.status is RequestStatus.RUNNING))
        if self._energy_seen:
            m.gauge("energy_uj_total", "cumulative per-request switching "
                    "energy priced by tracing executors").set(
                self._energy_uj)
        m.gauge("retry_queue_depth",
                "failed batches awaiting backoff retry").set(
            sum(len(reqs) for _, _, reqs in self._retry))
        m.gauge("models_quarantined",
                "registered models currently quarantined").set(
            len(self._quarantined))

    def models(self) -> list[str]:
        return self.registry.names()

    # -- submit -------------------------------------------------------------

    def submit(self, value, model: Optional[str] = None, *,
               priority: int = 0, deadline: Optional[float] = None,
               tag: Optional[str] = None,
               spec_k: Optional[int] = None,
               timeout: Optional[float] = None) -> RequestHandle:
        """Validate + enqueue one request; returns its handle.

        ``model`` may be omitted when exactly one model is registered.
        ``deadline`` is an SLA in seconds from now (used by the deadline
        scheduler and the deadline-met stats); ``priority`` is higher-
        first (priority scheduler); ``tag`` labels the request for
        per-class latency stats.  ``spec_k`` caps this request's
        speculative-decode proposal budget on spec-capable executors
        (0 disables speculation for the request; None leaves the
        executor's adaptive policy in charge).  ``timeout`` is a hard
        per-request budget: past it the engine fails the request with
        :class:`~repro_torch.serving.faults.RequestTimeout` wherever it is.

        Admission control (see :class:`~repro_torch.serving.faults.
        FaultPolicy`): traffic for a quarantined model reroutes to its
        registered fallback, else raises :class:`ModelQuarantinedError`;
        queue-depth and deadline-aware caps raise :class:`LoadShedError`
        *here* — at the caller — instead of letting a doomed request
        consume queue and batch capacity.
        """
        if model is None:
            names = self.registry.names()
            if len(names) == 1:
                model = names[0]
            elif "default" in names:
                model = "default"
            else:
                raise ValueError(
                    "model= is required: engine serves "
                    f"{names or 'no models'}")
        if model not in self.registry:
            self.registry[model]      # raises the canonical unknown-model
        if model in self._quarantined:
            fb = self._usable_fallback(model)
            if fb is None:
                raise ModelQuarantinedError(
                    f"model {model!r} is quarantined after "
                    f"{self._consec.get(model, 0)} consecutive executor "
                    "failures and has no healthy fallback; hot-swap it "
                    "or call reinstate()")
            self.n_rerouted += 1
            self.obs.metrics.counter(
                "requests_rerouted_total", "submissions rerouted to a "
                "fallback model during quarantine").inc(
                model=model, fallback=fb)
            model = fb
        pol = self.policy
        depth = len(self.scheduler)
        if pol.max_queue_depth is not None and depth >= pol.max_queue_depth:
            self._count_shed(model, "queue_depth")
            raise LoadShedError(
                f"queue depth {depth} at max_queue_depth="
                f"{pol.max_queue_depth}; retry later")
        executor = self.registry[model]
        if pol.shed_on_deadline and deadline is not None:
            est = self._estimated_wait(model, executor, depth)
            if est is not None and est > deadline:
                self._count_shed(model, "deadline")
                raise LoadShedError(
                    f"deadline {deadline:.3f}s cannot be met: estimated "
                    f"wait {est:.3f}s at queue depth {depth}")
        if pol.pressure_queue_depth is not None \
                and depth >= pol.pressure_queue_depth \
                and getattr(executor, "spec", None) is not None \
                and spec_k != 0:
            # graceful degradation: give up speculative speedup (extra
            # decode work per token) before giving up admission
            spec_k = 0
            self.n_degraded += 1
            self.obs.metrics.counter(
                "requests_degraded_total", "requests admitted with "
                "speculation disabled under queue pressure").inc(
                model=model)
        value = executor.validate(value)
        self._uid += 1
        self._seq += 1
        req = Request(uid=self._uid, model=model, value=value,
                      priority=priority, deadline=deadline, tag=tag,
                      spec_k=spec_k, timeout=timeout, seq=self._seq,
                      submit_t=self.clock())
        self.scheduler.add(req)
        handle = RequestHandle(self, req)
        self._requests[req.uid] = req
        self._handles[req.uid] = handle
        if timeout is not None:
            self._timed.add(req.uid)
        self.obs.metrics.counter(
            "requests_submitted_total",
            "requests accepted by submit()").inc(model=model)
        if self.obs.enabled:
            self.obs.trace.thread_name(req.uid, f"req {req.uid} ({model})")
            self.obs.trace.instant("submit", tid=req.uid, cat="request",
                                   model=model)
            self.obs.trace.begin("queued", tid=req.uid, cat="request")
        return handle

    def _count_shed(self, model: str, reason: str) -> None:
        self.n_shed += 1
        self.obs.metrics.counter(
            "requests_shed_total",
            "submissions refused by admission control").inc(
            model=model, reason=reason)
        self.obs.trace.instant("shed", tid=0, cat="engine", model=model,
                               reason=reason)

    def _estimated_wait(self, model: str, executor, depth: int
                        ) -> Optional[float]:
        """Rough queue wait from recent batch times: batches ahead of a
        new submit, times the recent mean batch duration.  None until
        at least 3 batches have run (no evidence, no shedding)."""
        recent = [b["seconds"] for b in list(self.batches)[-32:]]
        if len(recent) < 3:
            return None
        cap = max(1, executor.free_capacity())
        batches_ahead = -(-(depth + 1) // cap)
        return float(np.mean(recent)) * batches_ahead

    def cancel(self, uid: int) -> bool:
        """Cancel a queued request; False once admitted or finished."""
        req = self._requests.get(uid)
        if req is None or req.status is not RequestStatus.QUEUED:
            return False
        if self.scheduler.remove(uid) is None:
            return False
        req.status = RequestStatus.CANCELLED
        req.done_t = self.clock()
        self.n_cancelled += 1
        self.obs.metrics.counter(
            "requests_cancelled_total",
            "queued requests cancelled before admission").inc(
            model=req.model)
        self.obs.trace.end("queued", tid=uid, cat="request",
                           cancelled=True)
        return True

    # -- schedule + execute -------------------------------------------------

    def step(self) -> bool:
        """One schedule+execute round; False when nothing progressed.

        An executor exception no longer propagates out of ``step()``:
        the engine isolates, retries and (past the policy's budgets)
        fails only the implicated requests — callers observe errors at
        the handle (``result()`` raises ``req.error``), and co-batched
        innocents keep running.
        """
        now = self.clock()
        self._queue_depth.append(len(self.scheduler))
        self._expire(now)
        self._maybe_reinstate(now)
        progressed = self._run_due_retries(now)
        capacities = {name: (0 if name in self._quarantined
                             else ex.free_capacity())
                      for name, ex in self.registry.items()}
        with self.obs.trace.span("schedule", tid=0, cat="engine",
                                 queued=len(self.scheduler)):
            picked = self.scheduler.next_batch(capacities, now)
        admissions = {picked[0]: picked[1]} if picked else {}
        for name, executor in self.registry.items():
            if name in self._quarantined:
                continue
            reqs = admissions.get(name, [])
            if not reqs and not executor.has_resident():
                continue
            self._run_batch(name, executor, reqs)
            progressed = True
        if not progressed and self._retry:
            # only future retries remain: sleep to the earliest one so
            # backoff never reads as a dead engine to run()/result()
            delay = min(at for at, _, _ in self._retry) - self.clock()
            if delay > 0:
                self.sleep(delay)
            return True
        return progressed

    def _run_due_retries(self, now: float) -> bool:
        """Execute retry batches whose backoff elapsed.  They bypass the
        scheduler: a bisected half must re-execute exactly as isolated,
        not re-mixed with fresh admissions."""
        if not self._retry or not any(at <= now for at, _, _ in self._retry):
            return False
        due = sorted((e for e in self._retry if e[0] <= now),
                     key=lambda e: e[0])
        self._retry = [e for e in self._retry if e[0] > now]
        progressed = False
        for _, name, reqs in due:
            if name not in self.registry:
                self._fail(reqs, ValueError(
                    f"model {name!r} was unregistered while its batch "
                    "awaited retry"))
                progressed = True
                continue
            if name in self._quarantined:
                # quarantine already disposed of everything it saw; a
                # race here just fails/reroutes like quarantine did
                self._dispose_on_quarantine(name, reqs)
                progressed = True
                continue
            executor = self.registry[name]
            cap = executor.free_capacity()
            if cap <= 0:
                # no room (e.g. slots full of residents): try again
                # shortly; the resident pass below keeps making progress
                self._retry.append(
                    (now + self.policy.backoff_base, name, reqs))
                continue
            while reqs:
                part, reqs = reqs[:cap], reqs[cap:]
                self._run_batch(name, executor, part)
                progressed = True
        return progressed

    def _run_batch(self, name: str, executor, reqs: list[Request]) -> None:
        """Admit ``reqs`` (possibly empty, for resident-only executors)
        and run one executor call, with full failure handling."""
        start = self.clock()
        metrics = self.obs.metrics
        for r in reqs:
            first = r.schedule_t is None
            r.status = RequestStatus.RUNNING
            if first:
                r.schedule_t = start
            self.obs.trace.end("queued", tid=r.uid, cat="request")
            self.obs.trace.begin("execute", tid=r.uid, cat="request",
                                 model=name)
            if first and r.queue_time is not None:
                metrics.histogram(
                    "queue_time_seconds",
                    "submit-to-admission wait per request").observe(
                    r.queue_time, model=name)
        self.obs.trace.begin("batch", tid=0, cat="engine", model=name,
                             live=len(reqs))
        try:
            report = executor.execute(reqs)
        except Exception as err:
            self.obs.trace.end("batch", tid=0, cat="engine",
                               error=repr(err))
            self._on_failure(name, executor, reqs, err)
            return
        done_t = self.clock()
        self.obs.trace.end("batch", tid=0, cat="engine",
                           live=report.live, padded=report.padded)
        self._consec[name] = 0
        self.n_batches += 1
        self.batches.append({
            "model": name, "live": report.live,
            "padded": report.padded, "seconds": done_t - start,
            "rows": report.rows,
            "per_device_live": report.per_device_live,
        })
        metrics.counter("batches_total",
                        "executor batches run").inc(model=name)
        if report.padded:
            metrics.histogram(
                "batch_occupancy", "live/padded fill of executed "
                "batches", buckets=(0.125, 0.25, 0.375, 0.5, 0.625,
                                    0.75, 0.875, 1.0)).observe(
                report.live / report.padded, model=name)
        if report.tokens_generated is not None:
            # tokens per *sequence*-step, so plain one-token decode
            # reads 1.0 regardless of batch width and speculative
            # decoding's multi-token commits push it above 1.0
            emitted = sum(report.tokens_generated.values())
            acc = self._tok_by_model.setdefault(name, [0, 0])
            acc[0] += emitted
            acc[1] += len(report.tokens_generated)
            for uid, n in report.tokens_generated.items():
                r = self._requests.get(uid)
                if r is None or r.tag is None:
                    continue
                tacc = self._tok_by_tag.setdefault(r.tag, [0, 0])
                tacc[0] += n
                tacc[1] += 1
            if emitted:
                metrics.counter(
                    "tokens_generated_total",
                    "output tokens emitted by LLM executors").inc(
                    emitted, model=name)
        if report.energy_uj is not None:
            self._energy_uj += report.energy_uj * report.live
            self._energy_seen = True
            metrics.counter(
                "energy_uj_spent_total", "switching energy priced "
                "by tracing executors (uJ)").inc(
                report.energy_uj * report.live, model=name)
        completions = report.completions
        if self.policy.guard_outputs and completions:
            completions = self._guard_outputs(name, executor, completions)
        for uid, result in completions:
            req = self._requests[uid]
            req.result = result
            req.status = RequestStatus.DONE
            req.done_t = done_t
            self.n_done += 1
            self._done.append(req)
            self._completed.append(self._handles[uid])
            self.obs.trace.end("execute", tid=uid, cat="request")
            metrics.counter("requests_completed_total",
                            "requests finished successfully").inc(
                model=name)
            if req.latency is not None:
                metrics.histogram(
                    "request_latency_seconds",
                    "submit-to-done latency per request").observe(
                    req.latency, model=name)

    # -- failure handling ---------------------------------------------------

    def _guard_outputs(self, name: str, executor, completions: list
                       ) -> list:
        """Route non-finite (NaN/Inf) float results back through the
        retry path instead of handing garbage to callers."""
        bad_uids = {uid for uid, res in completions if _garbage(res)}
        if not bad_uids:
            return completions
        err = GarbageOutputError(
            f"model {name!r} returned non-finite results for "
            f"{len(bad_uids)} request(s)")
        self._consec[name] = self._consec.get(name, 0) + 1
        self.obs.metrics.counter(
            "executor_failures_total",
            "executor calls the engine treated as failed").inc(
            model=name, kind="garbage_output")
        bad = [self._requests[uid] for uid in sorted(bad_uids)]
        for r in bad:
            executor.evict(r.uid)
        self._retry_or_fail(name, bad, err)
        self._check_quarantine(name, executor)
        return [(uid, res) for uid, res in completions
                if uid not in bad_uids]

    def _on_failure(self, name: str, executor, reqs: list[Request],
                    err: BaseException) -> None:
        """One executor call raised: contain the blast radius.

        * transient errors: whole batch retried with capped backoff;
        * singleton batches: the request is the culprit — retry it with
          backoff until its budget, then FAIL it;
        * multi-request opaque failures: **bisect** — both halves are
          requeued for immediate isolated re-execution, so a poison
          request converges to a singleton and innocents complete;
        * resident-only failures (no fresh admissions): transient
          errors simply retry the next step; persistent ones evict and
          fail every resident of the model.

        Consecutive failures feed quarantine (see _check_quarantine).
        """
        self._consec[name] = self._consec.get(name, 0) + 1
        self.obs.metrics.counter(
            "executor_failures_total",
            "executor calls the engine treated as failed").inc(
            model=name, kind=type(err).__name__)
        self.obs.trace.instant("executor_failure", tid=0, cat="engine",
                               model=name, error=repr(err))
        for r in reqs:
            executor.evict(r.uid)
        if not reqs:
            self._on_resident_failure(name, executor, err)
            self._check_quarantine(name, executor)
            return
        if isinstance(err, TransientFault) or len(reqs) == 1:
            self._retry_or_fail(name, reqs, err)
        else:
            mid = len(reqs) // 2
            self.obs.trace.instant("bisect", tid=0, cat="engine",
                                   model=name, n=len(reqs))
            self.obs.metrics.counter(
                "batch_bisections_total",
                "failed batches split to isolate poison requests").inc(
                model=name)
            # no retry charge: innocence is the presumption until a
            # request fails alone
            self._requeue(name, reqs[:mid], err, delay=0.0)
            self._requeue(name, reqs[mid:], err, delay=0.0)
        self._check_quarantine(name, executor)

    def _on_resident_failure(self, name: str, executor,
                             err: BaseException) -> None:
        residents = [r for r in self._requests.values()
                     if r.model == name
                     and r.status is RequestStatus.RUNNING]
        if isinstance(err, TransientFault) and residents and \
                all(r.retries < self.policy.max_retries
                    for r in residents):
            # leave them resident; the next step re-executes.  The
            # retry charge caps how long a wedged model is re-driven.
            for r in residents:
                r.retries += 1
            self.n_retries += len(residents)
            self.obs.metrics.counter(
                "requests_retried_total",
                "request retries after executor failures").inc(
                len(residents), model=name)
            return
        for r in residents:
            executor.evict(r.uid)
        self._fail(residents, err)

    def _retry_or_fail(self, name: str, reqs: list[Request],
                       err: BaseException) -> None:
        """Charge one retry to each request; requeue those under budget
        with exponential backoff, FAIL the rest."""
        survivors, giveup = [], []
        for r in reqs:
            r.retries += 1
            (survivors if r.retries <= self.policy.max_retries
             else giveup).append(r)
        if giveup:
            self._fail(giveup, err)
        if survivors:
            delay = self.policy.backoff(
                max(r.retries for r in survivors))
            self._requeue(name, survivors, err, delay=delay)

    def _requeue(self, name: str, reqs: list[Request],
                 err: BaseException, *, delay: float) -> None:
        """Put failed-but-retryable requests back in flight (engine-
        owned retry queue, not the scheduler)."""
        now = self.clock()
        for r in reqs:
            r.status = RequestStatus.QUEUED
            self.obs.trace.end("execute", tid=r.uid, cat="request",
                               error=repr(err))
            self.obs.trace.begin("queued", tid=r.uid, cat="request",
                                 retry=r.retries)
        self.n_retries += len(reqs)
        self.obs.metrics.counter(
            "requests_retried_total",
            "request retries after executor failures").inc(
            len(reqs), model=name)
        self._retry.append((now + delay, name, list(reqs)))

    def _fail(self, reqs: list[Request], err: BaseException) -> None:
        """Mark requests FAILED so their handles report the error
        instead of stranding forever; closes whichever lifecycle span
        ('execute' for running, 'queued' for queued) is open."""
        done_t = self.clock()
        for r in reqs:
            span = ("execute" if r.status is RequestStatus.RUNNING
                    else "queued")
            r.status = RequestStatus.FAILED
            r.error = err
            r.done_t = done_t
            self.n_failed += 1
            self._completed.append(self._handles[r.uid])
            self.obs.trace.end(span, tid=r.uid, cat="request",
                               error=repr(err))
            self.obs.metrics.counter(
                "requests_failed_total",
                "requests failed by an executor error").inc(
                model=r.model)

    # -- health / quarantine ------------------------------------------------

    def _check_quarantine(self, name: str, executor) -> None:
        """Quarantine a model after ``quarantine_after`` consecutive
        failures: evict its work, reroute it to the registered fallback
        (or FAIL it), refuse new submits — and keep serving every other
        model."""
        after = self.policy.quarantine_after
        if after is None or name in self._quarantined:
            return
        if self._consec.get(name, 0) < after:
            return
        self._quarantined[name] = self.clock()
        self.n_quarantines += 1
        self.obs.metrics.counter(
            "models_quarantined_total",
            "models quarantined on consecutive failures").inc(model=name)
        self.obs.trace.instant("quarantine", tid=0, cat="engine",
                               model=name,
                               consecutive=self._consec.get(name, 0))
        victims: list[Request] = []
        for r in self._requests.values():
            if r.model == name and r.status is RequestStatus.RUNNING:
                executor.evict(r.uid)
                victims.append(r)
        victims += self.scheduler.drain(name)
        keep = []
        for at, model, reqs in self._retry:
            if model == name:
                victims.extend(reqs)
            else:
                keep.append((at, model, reqs))
        self._retry = keep
        self._dispose_on_quarantine(name, victims)

    def _dispose_on_quarantine(self, name: str,
                               victims: list[Request]) -> None:
        fb = self._usable_fallback(name)
        if fb is None:
            self._fail(victims, ModelQuarantinedError(
                f"model {name!r} quarantined after consecutive executor "
                "failures (no fallback registered)"))
            return
        for r in victims:
            if r.status is RequestStatus.RUNNING:
                # back to queued, under the fallback model
                r.status = RequestStatus.QUEUED
                self.obs.trace.end("execute", tid=r.uid, cat="request",
                                   rerouted=fb)
                self.obs.trace.begin("queued", tid=r.uid, cat="request")
            r.model = fb
            r.retries = 0        # a healthy model gets a fresh budget
            self.scheduler.add(r)
            self.n_rerouted += 1
            self.obs.metrics.counter(
                "requests_rerouted_total", "submissions rerouted to a "
                "fallback model during quarantine").inc(
                model=name, fallback=fb)

    def _usable_fallback(self, name: str) -> Optional[str]:
        fb = self._fallbacks.get(name)
        if fb is None or fb not in self.registry or \
                fb in self._quarantined:
            return None
        return fb

    def _maybe_reinstate(self, now: float) -> None:
        cooldown = self.policy.quarantine_cooldown
        if cooldown is None or not self._quarantined:
            return
        for name, since in list(self._quarantined.items()):
            if now - since >= cooldown:
                self.reinstate(name)

    def reinstate(self, name: str) -> bool:
        """Lift a model's quarantine (manual, or cooldown-driven);
        True when it was quarantined."""
        was = self._quarantined.pop(name, None) is not None
        if was:
            self._consec[name] = 0
            self.obs.trace.instant("reinstate", tid=0, cat="engine",
                                   model=name)
        return was

    @property
    def quarantined(self) -> list[str]:
        """Names of currently quarantined models."""
        return sorted(self._quarantined)

    # -- timeouts -----------------------------------------------------------

    def _expire(self, now: float) -> None:
        """Fail queued/running requests past their ``timeout=``."""
        if not self._timed:
            return
        for uid in sorted(self._timed):
            r = self._requests.get(uid)
            if r is None or r.status not in (RequestStatus.QUEUED,
                                             RequestStatus.RUNNING):
                self._timed.discard(uid)
                continue
            if now - r.submit_t < r.timeout:
                continue
            self._timed.discard(uid)
            if r.status is RequestStatus.QUEUED:
                if self.scheduler.remove(uid) is None:
                    self._drop_from_retry(uid)
            elif r.model in self.registry:
                self.registry[r.model].evict(uid)
            self.n_timed_out += 1
            self.obs.metrics.counter(
                "requests_timed_out_total",
                "requests failed on their per-request timeout").inc(
                model=r.model)
            self._fail([r], RequestTimeout(
                f"request {uid} exceeded timeout={r.timeout}s "
                f"({now - r.submit_t:.3f}s since submit)"))

    def _drop_from_retry(self, uid: int) -> None:
        out = []
        for at, name, reqs in self._retry:
            reqs = [r for r in reqs if r.uid != uid]
            if reqs:
                out.append((at, name, reqs))
        self._retry = out

    def busy(self) -> bool:
        """Queued, retrying or resident work remains."""
        return (len(self.scheduler) > 0
                or bool(self._retry)
                or any(ex.has_resident()
                       for _, ex in self.registry.items()))

    def run(self, max_steps: int = 100_000) -> dict[int, Any]:
        """Drive until idle; {uid: result} for every completed request."""
        for _ in range(max_steps):
            if not self.step():
                break
        return {uid: r.result for uid, r in sorted(self._requests.items())
                if r.status is RequestStatus.DONE}

    def stream(self, max_steps: int = 100_000
               ) -> Iterator[RequestHandle]:
        """Yield handles in completion order, stepping until idle."""
        for _ in range(max_steps):
            while self._completed:
                yield self._pop_completed()
            if not self.busy() or not self.step():
                break
        while self._completed:
            yield self._pop_completed()

    def _pop_completed(self) -> RequestHandle:
        handle = self._completed.popleft()
        self.obs.trace.instant("stream", tid=handle.uid, cat="request")
        return handle

    # -- accounting ---------------------------------------------------------

    def evict_completed(self) -> int:
        """Drop finished requests and their handles from the engine.

        For long-lived servers: once results have been consumed (via
        ``stream()`` or handles), evicting bounds memory — counters and
        the windowed stats survive, but ``run()``'s cumulative result
        dict forgets the evicted uids.  Returns the eviction count.
        """
        gone = [uid for uid, r in self._requests.items()
                if r.status in (RequestStatus.DONE, RequestStatus.CANCELLED,
                                RequestStatus.FAILED)]
        for uid in gone:
            del self._requests[uid]
            del self._handles[uid]
        return len(gone)

    def stats(self) -> dict:
        """Engine-level serving statistics (all times in seconds).

        Counters (``n_*``) are exact for the engine's lifetime; sampled
        distributions cover the most recent ``history`` entries.
        """
        lat = [r.latency for r in self._done]
        qt = [r.queue_time for r in self._done
              if r.queue_time is not None]
        met = [r.deadline_met for r in self._done
               if r.deadline_met is not None]
        by_tag: dict = {}
        tags = ({r.tag for r in self._done if r.tag is not None}
                | set(self._tok_by_tag))
        for tag in sorted(tags):
            rs = [r for r in self._done if r.tag == tag]
            tmet = [r.deadline_met for r in rs
                    if r.deadline_met is not None]
            toks, steps = self._tok_by_tag.get(tag, (0, 0))
            by_tag[tag] = {
                "n": len(rs),
                **percentiles([r.latency for r in rs]),
                "deadline_met_frac": (sum(tmet) / len(tmet)
                                      if tmet else None),
                "tokens_per_step": toks / steps if steps else None,
            }
        occ = [b["live"] / b["padded"] for b in self.batches]
        jit_variants = {
            name: ex.n_jit_variants
            for name, ex in self.registry.items()
            if isinstance(ex, ProgramExecutor)}
        # per-data-parallel-device occupancy, per meshed model: how full
        # each device's batch shard ran, averaged over executed batches.
        # Hot-swapping a model across meshes changes the device count, so
        # only batches matching the model's current degree are averaged.
        current_dp = {
            name: ex.data_parallel for name, ex in self.registry.items()
            if isinstance(ex, ProgramExecutor)}
        per_dev: dict = {}
        for b in self.batches:
            pdl = b.get("per_device_live")
            if pdl and len(pdl) == current_dp.get(b["model"]):
                per = b["padded"] / len(pdl)
                per_dev.setdefault(b["model"], []).append(
                    [n / per for n in pdl])
        per_device_occupancy = {
            model: [float(v) for v in np.mean(rows, axis=0)]
            for model, rows in per_dev.items()}
        # mesh topology per meshed model; pipeline-parallel (layer)
        # models additionally report their static GPipe schedule —
        # per-stage occupancy and bubble fraction
        sharding = {}
        for name, ex in self.registry.items():
            if not isinstance(ex, ProgramExecutor) or ex.mesh_spec is None:
                continue
            sharding[name] = {
                "data": ex.mesh_spec.data, "filter": ex.mesh_spec.filter,
                "layer": ex.mesh_spec.layer,
                "devices": ex.mesh_spec.n_devices}
            if ex.pipeline_schedule is not None:
                sharding[name]["pipeline"] = ex.pipeline_schedule
        # executor-specific accounting (paged-state block/prefix counters
        # from LLM executors ride in here; see Executor.extra_stats)
        paged_state = {name: s for name, s in
                       ((n, ex.extra_stats())
                        for n, ex in self.registry.items())
                       if s is not None}
        return {
            "scheduler": self.scheduler.name,
            "n_requests": self._uid,
            "n_done": self.n_done,
            "n_cancelled": self.n_cancelled,
            "n_failed": self.n_failed,
            "n_batches": self.n_batches,
            # resilience accounting (FaultPolicy, repro_torch.serving.faults)
            "faults": {
                "n_retries": self.n_retries,
                "n_shed": self.n_shed,
                "n_timed_out": self.n_timed_out,
                "n_degraded": self.n_degraded,
                "n_quarantines": self.n_quarantines,
                "n_rerouted": self.n_rerouted,
                "pending_retries": sum(
                    len(reqs) for _, _, reqs in self._retry),
                "quarantined": sorted(self._quarantined),
            },
            "latency": {**percentiles(lat),
                        "mean": float(np.mean(lat)) if lat else None,
                        "max": float(np.max(lat)) if lat else None},
            "queue_time": percentiles(qt),
            "queue_depth": {
                "mean": (float(np.mean(self._queue_depth))
                         if self._queue_depth else 0.0),
                "max": max(self._queue_depth, default=0)},
            "batch_occupancy": float(np.mean(occ)) if occ else None,
            "per_device_occupancy": per_device_occupancy or None,
            "sharding": sharding or None,
            "deadline_met_frac": (sum(met) / len(met)) if met else None,
            "by_tag": by_tag,
            # decode steps that emit > 1 token (speculative decoding)
            # push this above 1.0; one-shot executors never report it
            "tokens_per_step": {
                name: toks / steps
                for name, (toks, steps) in self._tok_by_model.items()
                if steps} or None,
            # _energy_seen (not truthiness) so a measured 0.0 uJ — e.g. an
            # all-zero activation trace — reports as 0.0, not "untraced"
            "energy_uj": self._energy_uj if self._energy_seen else None,
            "jit_variants": jit_variants,
            "paged_state": paged_state or None,
        }

    def traced(self, model: Optional[str] = None) -> list:
        """Tracer rows per executed batch (for tracing executors)."""
        return [b["rows"] for b in self.batches
                if b["rows"] is not None
                and (model is None or b["model"] == model)]

    # -- observability exports ----------------------------------------------

    def trace_export(self, path=None) -> dict:
        """The engine's request-lifecycle trace as Chrome/Perfetto
        trace-event JSON (load at ui.perfetto.dev or chrome://tracing);
        writes ``path`` when given, returns the trace dict either way."""
        return self.obs.trace_export(path)

    def metrics_snapshot(self) -> dict:
        """Point-in-time metrics registry snapshot (nested dict)."""
        return self.obs.metrics.snapshot()

    def metrics_text(self) -> str:
        """Metrics in Prometheus text exposition format."""
        return self.obs.metrics.prometheus_text()

    def __repr__(self) -> str:
        return (f"CutieEngine(scheduler={self.scheduler.name!r}, "
                f"models={self.models()}, queued={len(self.scheduler)}, "
                f"done={len(self._done)})")
