"""Pluggable scheduling policies: admission order and batch formation.

The scheduler owns the queued requests.  Each engine step it is offered
the per-model free capacities and answers with at most one batch — all
requests of a single model, picked and ordered by the policy's sort key.
Batching policy therefore lives here, not in the serving loop: FCFS,
strict priority and earliest-deadline-first are ~3 lines each, and a
custom policy is one subclass with one method.

The CUTIE analogue: the accelerator drains its layer FIFO in whatever
order the host loaded it (paper Fig. 3); the scheduler is the host-side
component that decides that order under load.
"""

from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.serving.request import Request


class Scheduler:
    """Base policy: storage + batch formation; subclasses rank requests.

    ``sort_key(request, now)`` returns a sortable key; lower serves
    first.  ``next_batch`` picks the globally most-urgent request among
    models with free capacity, then fills the batch with that model's
    queued requests in key order — one model per batch, because a batch
    executes one compiled program.
    """

    name = "scheduler"

    def __init__(self):
        self._queued: dict[int, Request] = {}

    def __len__(self) -> int:
        return len(self._queued)

    def pending(self, model: Optional[str] = None) -> int:
        if model is None:
            return len(self._queued)
        return sum(r.model == model for r in self._queued.values())

    def add(self, request: Request) -> None:
        self._queued[request.uid] = request

    def remove(self, uid: int) -> Optional[Request]:
        """Pull a request back out (cancellation before admission)."""
        return self._queued.pop(uid, None)

    def drain(self, model: str) -> list[Request]:
        """Pull every queued request of one model out, in submission
        order (quarantine: the engine reroutes or fails them)."""
        out = sorted((r for r in self._queued.values()
                      if r.model == model), key=lambda r: r.seq)
        for r in out:
            del self._queued[r.uid]
        return out

    def sort_key(self, request: Request, now: float):
        raise NotImplementedError

    def next_batch(self, capacities: Mapping[str, int], now: float
                   ) -> Optional[tuple[str, list[Request]]]:
        """Form one batch: ``(model, requests)``, or None when nothing
        admissible (empty queue, or every queued model is at capacity)."""
        cands = [r for r in self._queued.values()
                 if capacities.get(r.model, 0) > 0]
        if not cands:
            return None
        model = min(cands, key=lambda r: self.sort_key(r, now)).model
        batch = sorted((r for r in cands if r.model == model),
                       key=lambda r: self.sort_key(r, now))
        batch = batch[:capacities[model]]
        for r in batch:
            del self._queued[r.uid]
        return model, batch


class FCFSScheduler(Scheduler):
    """First come, first served: pure submission order."""

    name = "fcfs"

    def sort_key(self, request, now):
        return (request.seq,)


class PriorityScheduler(Scheduler):
    """Strict priority (higher first), FCFS within a priority level."""

    name = "priority"

    def sort_key(self, request, now):
        return (-request.priority, request.seq)


class DeadlineScheduler(Scheduler):
    """Earliest-deadline-first: SLA-aware admission.

    Requests without a deadline sort last (deadline_t = +inf); priority
    then submission order break ties, so it degrades to the priority
    policy for deadline-free traffic.
    """

    name = "deadline"

    def sort_key(self, request, now):
        return (request.deadline_t, -request.priority, request.seq)


SCHEDULERS = {cls.name: cls for cls in
              (FCFSScheduler, PriorityScheduler, DeadlineScheduler)}


def get_scheduler(spec) -> Scheduler:
    """Resolve a scheduler name / class / instance to an instance."""
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, type) and issubclass(spec, Scheduler):
        return spec()
    if spec in SCHEDULERS:
        return SCHEDULERS[spec]()
    raise ValueError(f"unknown scheduler {spec!r}; "
                     f"choose from {sorted(SCHEDULERS)}")
