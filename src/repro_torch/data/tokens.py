"""Deterministic synthetic LM token pipeline.

Stateless-by-construction: batch ``i`` is a pure function of (seed, i), so

* any host can materialize exactly its shard of any step (multi-host safe),
* restart/elastic-reshard resume is trivial — the checkpoint stores only the
  step cursor, and a restore onto a *different* data-parallel size still
  yields the same global token stream.

The stream is a Zipf-ish unigram mix with injected n-gram structure so that
cross-entropy actually decreases during the example runs (pure uniform
tokens would pin the loss at log V).

The port's own numpy copy of the reference's pipeline
(`repro.data.tokens`): the same seed gives the same batches, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew
    ngram_period: int = 4        # every k-th token is a deterministic ngram


class SyntheticTokens:
    """`batch(step)` -> {'tokens','labels'} for the global batch;
    `batch_slice(step, lo, hi)` -> rows [lo, hi) only (per-host shard)."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        # Zipf unigram table (numpy once, tiny).
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self._cdf = np.cumsum(p / p.sum())

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row]))
        u = rng.random(cfg.seq_len + 1)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # inject structure: token at position i % period == 0 determines the
        # next token deterministically (learnable bigram).
        idx = np.arange(cfg.seq_len + 1)
        prev = np.roll(toks, 1)
        det = (prev.astype(np.int64) * 2654435761 % cfg.vocab
               ).astype(np.int32)
        toks = np.where(idx % cfg.ngram_period == 1, det, toks)
        return np.clip(toks, 0, cfg.vocab - 1)

    def batch_slice(self, step: int, lo: int, hi: int) -> dict:
        rows = np.stack([self._row(step, r) for r in range(lo, hi)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def batch(self, step: int) -> dict:
        return self.batch_slice(step, 0, self.cfg.global_batch)


def for_arch(cfg, shape, seed: int = 0) -> SyntheticTokens:
    return SyntheticTokens(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed))
