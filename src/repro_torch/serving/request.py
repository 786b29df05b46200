"""Request lifecycle for the serving engine.

A submitted request moves through an explicit state machine —

    QUEUED --(scheduler admits into a batch)--> RUNNING --> DONE
       \\--(cancel before admission)--> CANCELLED        \\-> FAILED

— and every transition is timestamped, so per-request latency and
queue-time accounting fall out of the lifecycle instead of being bolted
on by each caller.  `submit()` returns a :class:`RequestHandle`, the
caller's view of one request: poll ``status``, block on ``result()``
(which drives the engine), or ``cancel()`` while still queued.

Priority and deadline are request *metadata*; what they mean is entirely
up to the engine's pluggable :class:`~repro_torch.serving.scheduler.Scheduler`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class RequestStatus(enum.Enum):
    QUEUED = "queued"          # submitted, waiting in the scheduler
    RUNNING = "running"        # admitted into an executing batch
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"


class RequestCancelled(RuntimeError):
    """Raised by ``RequestHandle.result()`` for a cancelled request."""


@dataclasses.dataclass
class Request:
    """One unit of serving work plus its scheduling metadata."""

    uid: int
    model: str                       # ModelRegistry routing key
    value: Any                       # canonical input (executor-validated)
    priority: int = 0                # higher serves first (priority policy)
    deadline: Optional[float] = None  # SLA seconds from submit (EDF policy)
    tag: Optional[str] = None        # free-form class label for stats
    spec_k: Optional[int] = None     # speculative-decode proposal budget
    #                                  (0 disables; None = executor default)
    timeout: Optional[float] = None  # hard per-request budget in seconds
    #                                  from submit; the engine fails the
    #                                  request with RequestTimeout past it
    retries: int = 0                 # failures charged so far (engine-
    #                                  managed; capped by FaultPolicy)
    seq: int = 0                     # global submission-order tiebreaker
    submit_t: float = 0.0
    schedule_t: Optional[float] = None
    done_t: Optional[float] = None
    status: RequestStatus = RequestStatus.QUEUED
    result: Any = None
    error: Optional[BaseException] = None

    @property
    def deadline_t(self) -> float:
        """Absolute deadline on the engine clock (+inf when none)."""
        if self.deadline is None:
            return float("inf")
        return self.submit_t + self.deadline

    @property
    def latency(self) -> Optional[float]:
        """submit -> completion, in engine-clock seconds."""
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    @property
    def queue_time(self) -> Optional[float]:
        """submit -> batch admission, in engine-clock seconds."""
        if self.schedule_t is None:
            return None
        return self.schedule_t - self.submit_t

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.done_t is None or self.deadline is None:
            return None
        return self.done_t <= self.deadline_t


class RequestHandle:
    """The caller's view of one submitted request."""

    def __init__(self, engine, request: Request):
        self._engine = engine
        self._request = request

    # -- introspection ------------------------------------------------------

    @property
    def uid(self) -> int:
        return self._request.uid

    @property
    def request(self) -> Request:
        return self._request

    @property
    def status(self) -> RequestStatus:
        return self._request.status

    @property
    def done(self) -> bool:
        return self._request.status in (RequestStatus.DONE,
                                        RequestStatus.CANCELLED,
                                        RequestStatus.FAILED)

    @property
    def latency(self) -> Optional[float]:
        return self._request.latency

    @property
    def queue_time(self) -> Optional[float]:
        return self._request.queue_time

    @property
    def deadline_met(self) -> Optional[bool]:
        return self._request.deadline_met

    def __repr__(self) -> str:
        r = self._request
        return (f"RequestHandle(uid={r.uid}, model={r.model!r}, "
                f"status={r.status.value})")

    # -- control ------------------------------------------------------------

    def result(self, max_steps: int = 100_000,
               timeout: Optional[float] = None) -> Any:
        """The request's output, driving the engine until it completes.

        ``timeout`` bounds the wall-clock (engine-clock) wait: a wedged
        or quarantined model then raises :class:`TimeoutError` here
        instead of driving the engine forever.
        """
        req = self._request
        deadline = (None if timeout is None
                    else self._engine.clock() + timeout)
        for _ in range(max_steps):
            if req.status not in (RequestStatus.QUEUED,
                                  RequestStatus.RUNNING):
                break
            if deadline is not None and self._engine.clock() >= deadline:
                raise TimeoutError(
                    f"request {req.uid} still {req.status.value} after "
                    f"result(timeout={timeout})")
            if not self._engine.step():
                raise RuntimeError(
                    f"request {req.uid} did not complete: engine made no "
                    f"progress (status={req.status.value})")
        if req.status is RequestStatus.CANCELLED:
            raise RequestCancelled(f"request {req.uid} was cancelled")
        if req.status is RequestStatus.FAILED:
            raise req.error
        if req.status is not RequestStatus.DONE:
            raise RuntimeError(
                f"request {req.uid} still {req.status.value} after "
                f"{max_steps} engine steps")
        return req.result

    def cancel(self) -> bool:
        """Cancel if still queued; False once admitted (or finished)."""
        return self._engine.cancel(self.uid)
