"""Batch executors: how a scheduled batch becomes results.

An :class:`Executor` is one registered model's execution strategy.  The
engine asks it for free capacity (so the scheduler can size batches),
hands it the admitted requests, and gets back an
:class:`ExecutionReport` — completions plus batch accounting.  Two
families:

* one-shot: a request completes in a single call — the CUTIE CNN case
  (the reference's bucketed ``ProgramExecutor``, which waits for
  ROADMAP.md §1 item 7 here);
* resident (the LLM decode loop in `repro_torch.serving.llm`): a
  request occupies a slot across many calls and completes later, so
  ``execute`` may return fewer completions than it was handed and
  ``has_resident()`` keeps the engine stepping while work is in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
