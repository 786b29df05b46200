"""`repro_torch.serving.spec` — speculative decoding over paged ternary
state.

A small ternary draft model proposes ``k`` tokens per sequence per
engine step; the target model scores all of them in **one** batched
forward (reusing the pow2-bucketed suffix-prefill path) and a rejection
sampler keeps the longest valid run.  Greedy speculation follows plain
greedy decode — it changes latency, not output, up to the rounding of
a near tie (`SpecExecutor`) — and sampling speculation is
distribution-preserving.

Pieces:

* :class:`SpecConfig` / :class:`AdaptiveK` — proposal budget policy
  (windowed acceptance-rate -> k),
* :class:`DraftWorker` — the draft's decode loop, paged into the same
  `BlockPool` as the target,
* :class:`VerifyWorker` — batched verification with fork-commit writes
  (rollback of a rejected suffix is a pure refcount release),
* rejection sampling (:func:`greedy_accept` / :func:`sample_accept`),
* :class:`SpecExecutor` — the drop-in `LLMExecutor` subclass an engine
  registers like any other executor; per-request ``spec_k`` (via
  ``engine.submit``) caps or disables speculation per sequence.
"""

from repro_torch.serving.spec.config import AdaptiveK, SpecConfig
from repro_torch.serving.spec.draft import DraftWorker
from repro_torch.serving.spec.executor import SpecExecutor
from repro_torch.serving.spec.rejection import (accept, greedy_accept,
                                                sample_accept)
from repro_torch.serving.spec.verify import VerifyWorker

__all__ = [
    "SpecConfig", "AdaptiveK",
    "DraftWorker", "VerifyWorker", "SpecExecutor",
    "accept", "greedy_accept", "sample_accept",
]
