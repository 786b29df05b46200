"""`SpecExecutor` — speculative decoding as a drop-in `LLMExecutor`.

The base executor's engine step is already factored as "advance every
live slot, collect per-slot new tokens" (:meth:`LLMExecutor._step_tokens`);
this subclass replaces the one-token decode with the propose → verify →
accept cycle and leaves everything else — prefill, prefix caching,
completion/stop handling, the `Executor` protocol — untouched.  An
engine registers it like any other executor; `extra_stats()` grows a
``"spec"`` section and `ExecutionReport.tokens_generated` makes the
multi-token steps visible as ``tokens_per_step`` in ``engine.stats()``.

Per step and per slot:

1. ``k_eff`` is chosen: the adaptive acceptance-tracking budget, capped
   by the request's ``spec_k`` (0 disables speculation for that
   request), the remaining ``max_new_tokens`` budget, and the remaining
   position budget.  ``k_eff <= 0`` slots fall back to one *masked*
   batched decode step whose per-row math is the plain executor's.
2. the draft proposes ``k_eff`` tokens (catching up on tokens it has
   not consumed yet — see `DraftWorker`),
3. the target scores all proposals in one batched forward
   (`VerifyWorker`, fork-commit on the paged KV),
4. rejection sampling (`repro_torch.serving.spec.rejection`) keeps the
   longest valid run: greedy acceptance follows the target's greedy
   trajectory; sampling acceptance is distribution-preserving.

Greedy speculation emits the plain greedy decode's tokens up to
rounding: the verify forward (the suffix prefill's attention) and the
decode step (cached decode attention) sum in other orders, so at a
near tie of the top two logits the two may pick different tokens, in
the reference as in the port.

Draft state rides in the same `BlockPool` as the target's paged state,
so speculation's memory cost is visible to the same admission-control
arithmetic (`free_capacity`) the scheduler already uses.  Slot
positions stay host numpy and pending tokens a tensor on the device,
as in the base executor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.obs import COUNT_BUCKETS
from repro_torch.serving.llm import LLMExecutor, ServerConfig
from repro_torch.serving.spec.config import AdaptiveK, SpecConfig
from repro_torch.serving.spec.draft import DraftWorker
from repro_torch.serving.spec.rejection import accept
from repro_torch.serving.spec.verify import VerifyWorker


class SpecExecutor(LLMExecutor):
    """Draft-and-verify decode over the paged ternary state stack."""

    def __init__(self, params, cfg: ArchConfig, scfg: ServerConfig,
                 draft_params, draft_cfg: ArchConfig,
                 spec: Optional[SpecConfig] = None):
        if not scfg.paged:
            raise ValueError("SpecExecutor requires paged=True (the "
                             "verify path forks paged block tables)")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab} != target vocab "
                f"{cfg.vocab}: proposals would not be target tokens")
        self.spec = spec or SpecConfig()
        if scfg.num_blocks is None:
            # widen the default pool: a dense draft pins its own table
            # per slot, and every verify step forks a shadow that may
            # COW up to two span blocks before the original is freed
            bps = scfg.max_len // scfg.block_size
            mult = 1 if draft_cfg.family == "ssm" else 2
            nb = 1 + (scfg.n_slots + 2) * bps * mult + 2 * scfg.n_slots
            scfg = dataclasses.replace(scfg, num_blocks=nb)
        super().__init__(params, cfg, scfg)
        self.draft = DraftWorker(draft_params, draft_cfg, self.scfg,
                                 self.pool)
        self.verifier = VerifyWorker(self)
        self._adaptive = AdaptiveK(self.spec)
        self._spec_k: dict[int, Optional[int]] = {}   # uid -> request cap
        self._spec_rng = np.random.default_rng(scfg.seed + 104729)
        self.proposed_total = 0
        self.accepted_total = 0
        self.verify_steps = 0
        self.plain_steps = 0

    # -- request lifecycle ---------------------------------------------------

    def _admit(self, req) -> None:
        super()._admit(req)
        slot = next(i for i, r in enumerate(self.slots)
                    if r is not None and r.uid == req.uid)
        self._spec_k[req.uid] = getattr(req, "spec_k", None)
        self.draft.admit(slot, req.uid, self._prompts[req.uid],
                         self.spec.k_max)

    def _release(self, slot: int) -> None:
        req = self.slots[slot]
        if req is not None:
            self.draft.free(slot, req.uid)
            self._spec_k.pop(req.uid, None)
        super()._release(slot)

    def fork(self, uid: int, new_uid: int) -> int:
        dst = super().fork(uid, new_uid)
        # the child gets a fresh draft sequence; the draft catches up on
        # the whole history at its first propose for this slot
        self.draft.free(dst, new_uid)
        self.draft.admit(dst, new_uid, self._prompts[new_uid],
                         self.spec.k_max)
        self._spec_k[new_uid] = self._spec_k.get(uid)
        return dst

    def evict(self, uid: int) -> bool:
        found = super().evict(uid)       # _release override frees draft
        self._spec_k.pop(uid, None)
        return found

    def snapshot(self):
        raise NotImplementedError(
            "SpecExecutor does not support serving-state snapshots yet: "
            "the draft worker's state is not checkpointed.  Serve the "
            "model on a plain LLMExecutor to snapshot/restore.")

    def free_capacity(self) -> int:
        free_slots = sum(r is None for r in self.slots)
        # the draft's table, the target's, and the shadow fork's COW slack
        per_seq = self.draft.blocks_per_admit()
        if not self.is_ssm:
            per_seq += self.blocks_per_seq + 2
        if per_seq == 0:
            return free_slots
        avail = self.pool.n_free + self.pool.n_cached
        return min(free_slots, avail // per_seq)

    # -- the speculative step ------------------------------------------------

    def _step_tokens(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        plain: list[int] = []
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            k = self._k_for(i, r.uid)
            if k <= 0:
                plain.append(i)
            else:
                out[i] = self._spec_step(i, r.uid, k)
        if plain:
            nxt = self._plain_decode(plain)
            for i in plain:
                out[i] = [int(nxt[i])]
            self.plain_steps += 1
        return out

    def _k_for(self, slot: int, uid: int) -> int:
        """Proposal budget for this slot this step (0 = plain decode)."""
        cap = self._spec_k.get(uid)
        if cap is not None and cap <= 0:
            return 0
        m = len(self._tokens[uid])
        k = min(self._adaptive.k(),
                self.scfg.max_new_tokens - m - 1,       # emit <= k+1 more
                self.scfg.max_len - 1 - int(self.pos[slot]))
        if cap is not None:
            k = min(k, cap)
        return max(k, 0)

    def _spec_step(self, slot: int, uid: int, k: int) -> list[int]:
        toks = self._tokens[uid]
        cur = toks[-1]                       # pending token at `pos`
        committed = np.concatenate(
            [self._prompts[uid], np.asarray(toks[:-1], np.int64)])
        pos = int(self.pos[slot])
        full = np.concatenate([committed, [cur]])

        with self.obs.trace.span("spec_propose", tid=uid, cat="spec", k=k):
            proposals, draft_lgs = self.draft.propose(slot, uid, full, k)
        with self.obs.trace.span("spec_verify", tid=uid, cat="spec", k=k):
            if self.is_ssm:
                target_rows, states = self.verifier.verify_ssm(
                    slot, uid, cur, proposals, pos)
            else:
                target_rows = self.verifier.verify_kv(
                    slot, uid, committed, cur, proposals, pos)
        emitted, j = accept(proposals, draft_lgs, target_rows,
                            self.scfg.temperature, self._spec_rng)
        if self.is_ssm:
            self.verifier.commit_ssm(slot, states, j)
        # the draft consumed `full` plus its first k-1 proposals; the
        # prefix of that run still valid against the new true sequence
        # is everything through proposal j-1 (capped at k-1 when all
        # proposals were accepted — the k-th was never consumed)
        self.draft.commit(slot, min(pos + 1 + j, pos + k))

        self.proposed_total += k
        self.accepted_total += j
        self.verify_steps += 1
        self._adaptive.observe(k, j)
        self.obs.trace.instant("spec_accept", tid=uid, cat="spec",
                               k=k, accepted=j)
        self.obs.metrics.counter(
            "spec_proposed_tokens_total",
            "draft tokens proposed to the verifier").inc(k)
        self.obs.metrics.counter(
            "spec_accepted_tokens_total",
            "proposed tokens the target accepted").inc(j)
        self.obs.metrics.histogram(
            "spec_accepted_per_step",
            "accepted proposals per verify step",
            buckets=COUNT_BUCKETS).observe(j)

        self.pos[slot] = pos + j + 1
        self.cur_tok[slot, 0] = emitted[-1]
        return emitted

    def _plain_decode(self, subset: list[int]) -> np.ndarray:
        """One decode step for ``subset`` slots only, masked so the
        other slots' positions, pending tokens and paged state are
        untouched (their writes route to the null block).  Per-row math
        is the base executor's batched decode, so a ``spec_k=0`` request
        decodes as on `LLMExecutor`.
        """
        mask = np.zeros((self.scfg.n_slots,), bool)
        mask[subset] = True
        pos = torch.as_tensor(self.pos, device=self.device)
        if self.is_ssm:
            bids = np.where(mask, self._slot_bids, 0)
            logits, self.state_store.pages = self._decode_ssm(bids, pos)
        else:
            pairs = []
            for i in subset:
                pair = self.manager.ensure_writable(self.slots[i].uid,
                                                    int(self.pos[i]))
                if pair is not None:
                    pairs.append(pair)
            self.kv_store.apply_copies(pairs)
            tables = torch.as_tensor(np.stack([
                self.manager.table_array(self.slots[i].uid,
                                         self.blocks_per_seq)
                if mask[i] else np.zeros((self.blocks_per_seq,), np.int32)
                for i in range(self.scfg.n_slots)]), device=self.device)
            logits, self.kv_store.pages = self._decode_paged(tables, pos)
        self.n_decode_steps += 1
        nxt = self._sample(logits[:, -1])
        self.pos = np.where(mask, self.pos + 1, self.pos)
        maskd = torch.as_tensor(mask, device=self.device)
        self.cur_tok = torch.where(maskd[:, None], nxt[:, None],
                                   self.cur_tok)
        return nxt.cpu().numpy()

    # -- stats ---------------------------------------------------------------

    def extra_stats(self) -> dict:
        out = super().extra_stats()
        vs = self.verify_steps
        out["spec"] = {
            **self._adaptive.stats(),
            "proposed_tokens": self.proposed_total,
            "accepted_tokens": self.accepted_total,
            "verify_steps": vs,
            "plain_steps": self.plain_steps,
            # every verify step emits its accepted run + one
            # target-sourced token
            "tokens_per_verify":
                (self.accepted_total + vs) / vs if vs else None,
            "draft_jit_variants": self.draft.n_jit_variants,
            "verify_jit_variants": self.verifier.n_jit_variants,
        }
        return out
