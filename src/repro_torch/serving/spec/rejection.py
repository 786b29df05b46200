"""Rejection sampling for speculative decoding.

Given ``k`` draft proposals and ``k + 1`` target distributions (one per
proposal position plus the bonus position after them), decide how many
proposals to keep and which token to emit in place of the first
rejection.  Two regimes share one entry point:

* **greedy** (temperature 0): a proposal is accepted while it equals the
  target argmax; the fallback token is the target argmax at the first
  mismatch.  The emitted run is *exactly* the token sequence a plain
  greedy decode loop would have produced — speculation changes latency,
  never output.
* **sampling** (temperature > 0): the standard accept/residual scheme
  (Leviathan et al.): proposal ``d`` is accepted with probability
  ``min(1, p(d) / q(d))``; on rejection the fallback is drawn from the
  normalized residual ``max(p - q, 0)``, and after ``k`` acceptances the
  bonus token is drawn from the target's next-position distribution.
  The emitted marginals equal plain target sampling (distribution-
  preserving), though not bit-identical to a particular PRNG stream.

Either way every verify step emits between 1 and ``k + 1`` tokens, and
the last emitted token is always target-sourced — it seeds the next
step's pending token exactly like a plain decode step would.

This is host numpy, as in the reference (`repro.serving.spec.rejection`):
the same float64 softmax and the same order of ``rng.random()`` /
``rng.choice`` draws, so the same inputs and generator state emit the
same tokens in both packages.
"""

from __future__ import annotations

import numpy as np


def _softmax(rows: np.ndarray, temperature: float) -> np.ndarray:
    x = rows.astype(np.float64) / max(temperature, 1e-8)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def greedy_accept(proposals: np.ndarray,
                  target_logits: np.ndarray) -> tuple[list[int], int]:
    """Greedy acceptance.

    ``proposals (k,)`` are draft tokens for positions ``pos+1 .. pos+k``;
    ``target_logits (k+1, V)`` rows are the target's distributions for
    positions ``pos+1 .. pos+k+1``.  Returns ``(emitted, j)``: the ``j``
    accepted proposals followed by the target's token at the first
    mismatch (or the bonus token when everything was accepted).
    """
    k = len(proposals)
    greedy = np.argmax(target_logits, axis=-1)
    j = 0
    while j < k and int(proposals[j]) == int(greedy[j]):
        j += 1
    return [int(t) for t in proposals[:j]] + [int(greedy[j])], j


def sample_accept(proposals: np.ndarray, draft_logits: np.ndarray,
                  target_logits: np.ndarray, temperature: float,
                  rng: np.random.Generator) -> tuple[list[int], int]:
    """Distribution-preserving acceptance at ``temperature > 0``.

    ``draft_logits (k, V)`` are the draft's distributions the proposals
    were sampled from, row-aligned with the first ``k`` rows of
    ``target_logits (k+1, V)``.
    """
    k = len(proposals)
    p = _softmax(target_logits, temperature)      # (k+1, V)
    q = _softmax(draft_logits, temperature)       # (k,   V)
    vocab = p.shape[-1]
    emitted: list[int] = []
    for i in range(k):
        d = int(proposals[i])
        if rng.random() < min(1.0, p[i, d] / max(q[i, d], 1e-300)):
            emitted.append(d)
            continue
        residual = np.maximum(p[i] - q[i], 0.0)
        z = residual.sum()
        dist = residual / z if z > 0 else p[i]
        emitted.append(int(rng.choice(vocab, p=dist)))
        return emitted, i
    emitted.append(int(rng.choice(vocab, p=p[k])))
    return emitted, k


def accept(proposals: np.ndarray, draft_logits: np.ndarray,
           target_logits: np.ndarray, temperature: float,
           rng: np.random.Generator) -> tuple[list[int], int]:
    """Dispatch on temperature; returns ``(emitted tokens, j accepted)``."""
    if temperature <= 0:
        return greedy_accept(proposals, target_logits)
    return sample_accept(proposals, draft_logits, target_logits,
                         temperature, rng)
