"""`DraftWorker` — the small ternary draft model's decode loop.

One draft sequence per target slot, living in the **same**
:class:`~repro_torch.serving.blocks.pool.BlockPool` as the target's
paged state (the draft's KV pages / state snapshots are its own stores,
but every physical block comes out of the shared budget, so draft
residency is priced by the same allocator the scheduler already
watches).

The worker is deliberately lag-tolerant: it tracks how many tokens of
the true sequence it has consumed (``_pos``) and each ``propose()``
call first *catches up* on tokens it has not seen (the correction token
of the previous verify step — or the whole prompt right after
admission), then rolls ``k - 1`` further steps on its own proposals.
The reference runs catch-up and proposal as one jitted `lax.scan`,
bucketed to a power of two so jit variants stay bounded; here it is a
Python loop of the port's decode step over the ``n_new + k - 1`` real
steps only (a padding step would cost a whole draft forward).  The
buckets are still counted, so ``n_jit_variants`` keeps its meaning.

Rejected proposals need no block surgery on the draft side: a draft
sequence is private (never forked, never hash-committed), so its KV rows
for rejected positions are simply overwritten by the next catch-up, and
an SSM draft rolls back by re-writing its slot state from the per-step
states its propose loop kept.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decoding as DEC
from repro_torch.models.config import ArchConfig
from repro_torch.serving.blocks import (KVPagedStore, PagedSequenceManager,
                                        PrefixCache, StatePagedStore)
from repro_torch.serving.llm import _bucket, check_family

_PROPOSE_FLOOR = 8     # pow2 bucket floor for the propose-scan length


class DraftWorker:
    """Per-slot draft sequences over the shared block pool, on the
    draft parameters' device."""

    def __init__(self, params, cfg: ArchConfig, scfg, pool):
        check_family(cfg)
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.is_ssm = cfg.family == "ssm"
        self.device = params["embed"].device
        self.pool = pool
        self.n_slots = scfg.n_slots
        self._pos = [0] * scfg.n_slots        # tokens consumed per slot
        self._buckets: set = set()            # propose-scan lengths seen
        self.n_steps = 0                      # draft decode steps run
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed + 7919)
        bs = scfg.block_size
        self.blocks_per_seq = scfg.max_len // bs
        if self.is_ssm:
            one = DEC.init_caches(cfg, 1, scfg.max_len, device=self.device)
            self._init_state = {k: v[:, 0] for k, v in one["ssm"].items()}
            self.store = StatePagedStore(pool.num_blocks, self._init_state,
                                         codec_name=scfg.state_codec)
            self._slot_bids = [pool.allocate() for _ in range(scfg.n_slots)]
            # the last propose's per-step states and start position, per
            # slot: commit() picks the state matching the accepted run,
            # which is the whole rollback story for an SSM draft
            self._pending: list = [None] * scfg.n_slots
        else:
            self.manager = PagedSequenceManager(pool, PrefixCache(), bs)
            self.store = KVPagedStore(
                cfg.n_layers, pool.num_blocks, bs, cfg.n_kv, cfg.d_head,
                dtype=cfg.kv_dtype, codec_name=scfg.kv_codec,
                device=self.device)

    # -- lifecycle ----------------------------------------------------------

    def blocks_per_admit(self) -> int:
        """Shared-pool blocks one admitted draft sequence pins."""
        return 0 if self.is_ssm else self.blocks_per_seq

    def admit(self, slot: int, uid: int, prompt, k_max: int) -> None:
        self._pos[slot] = 0
        if self.is_ssm:
            self._pending[slot] = None
            self.store.write_(self._slot_bids[slot], self._init_state)
            return
        scfg = self.scfg
        total = min(len(prompt) + scfg.max_new_tokens + k_max + 1,
                    scfg.max_len)
        self.manager.create(uid, prompt, total, probe=False)

    def free(self, slot: int, uid: int) -> None:
        self._pos[slot] = 0
        if self.is_ssm:
            self._pending[slot] = None
        elif self.manager.has(uid):
            self.manager.free(uid)

    # -- propose ------------------------------------------------------------

    def propose(self, slot: int, uid: int, tokens: np.ndarray, k: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """Draft ``k`` tokens continuing ``tokens`` (committed + pending).

        Returns ``(proposals (k,), draft_logits (k, V) float32)`` — the
        logits rows are the distributions each proposal was drawn from,
        aligned for rejection sampling.
        """
        t = len(tokens)
        s0 = self._pos[slot]
        n_new = t - s0
        if n_new < 1:
            raise RuntimeError(
                f"draft slot {slot} is ahead of the sequence "
                f"({s0} consumed, {t} known)")
        n_total = n_new + k - 1
        self._buckets.add(("ssm" if self.is_ssm else "kv",
                           _bucket(n_total, _PROPOSE_FLOOR)))
        if self.is_ssm:
            nexts, lgs = self._propose_ssm(slot, tokens[s0:], s0, n_new,
                                           n_total)
        else:
            nexts, lgs = self._propose_kv(uid, tokens[s0:], s0, n_new,
                                          n_total)
        self.n_steps += n_total
        return (torch.cat(nexts).cpu().numpy(),
                torch.stack(lgs).float().cpu().numpy())

    def _propose_kv(self, uid, new_tokens, s0, n_new, n_total):
        dev, cfg, store = self.device, self.cfg, self.store
        table = torch.as_tensor(
            self.manager.table_array(uid, self.blocks_per_seq),
            device=dev)[None]
        toks = torch.as_tensor(np.asarray(new_tokens, np.int64), device=dev)
        row = torch.zeros((1,), dtype=torch.int64, device=dev)
        nexts, lgs = [], []
        cur = toks[:1]
        for i in range(n_total):
            tok = toks[i:i + 1] if i < n_new else cur
            pos = torch.full((1,), s0 + i, dtype=torch.int64, device=dev)
            kv = store.gather(store.pages, table)
            logits, new = DEC.decode_step(self.params, tok[:, None],
                                          {"kv": kv}, pos, cfg)
            rows = {n: new["kv"][n][:, row, pos] for n in ("k", "v")}
            store.pages = store.write_rows(store.pages, table, pos, rows)
            lg = logits[0, -1, :cfg.vocab]
            cur = self._next(lg)
            if i >= n_new - 1:
                nexts.append(cur)
                lgs.append(lg)
        return nexts, lgs

    def _propose_ssm(self, slot, new_tokens, s0, n_new, n_total):
        """The decode step from the slot's state over the catch-up tokens
        and its own proposals, keeping each step's state for `commit`."""
        dev, cfg = self.device, self.cfg
        st = self.store.read_([self._slot_bids[slot]])
        caches = {"ssm": {k: v[0][:, None] for k, v in st.items()}}
        toks = torch.as_tensor(np.asarray(new_tokens, np.int64), device=dev)
        nexts, lgs, states = [], [], []
        cur = toks[:1]
        for i in range(n_total):
            tok = toks[i:i + 1] if i < n_new else cur
            logits, caches = DEC.decode_step(self.params, tok[:, None],
                                             caches, s0 + i, cfg)
            states.append(caches["ssm"])
            lg = logits[0, -1, :cfg.vocab]
            cur = self._next(lg)
            if i >= n_new - 1:
                nexts.append(cur)
                lgs.append(lg)
        self._pending[slot] = (states, s0)
        return nexts, lgs

    def _next(self, lg: torch.Tensor) -> torch.Tensor:
        """The draft's token from one logits row (V,): argmax, or a draw
        at the serving temperature from the worker's generator."""
        temp = self.scfg.temperature
        if temp <= 0:
            return torch.argmax(lg)[None]
        probs = torch.softmax(lg.float() / temp, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)

    def commit(self, slot: int, n_valid: int) -> None:
        """The verify step accepted a run: the true sequence's first
        ``n_valid`` tokens match what this draft consumed/proposed, so
        advance to there (KV rows beyond are overwritten by the next
        catch-up; an SSM slot state is re-written from the propose's
        per-step states)."""
        if self.is_ssm and self._pending[slot] is not None:
            states, s0 = self._pending[slot]
            state = states[n_valid - 1 - s0]
            self.store.write_(self._slot_bids[slot],
                              {k: v[:, 0] for k, v in state.items()})
            self._pending[slot] = None
        self._pos[slot] = n_valid

    @property
    def n_jit_variants(self) -> int:
        return len(self._buckets)
