"""`PagedSequenceManager` — per-sequence block tables over one BlockPool.

The manager owns the *logical* side of paging: which physical blocks
each live sequence maps its positions onto, which prefix of those blocks
was served from the content-hash cache, and when a write needs
copy-on-write because the target block is shared (forked child, or a
hash-registered prefix block).

The *physical* side (actual KV rows / state snapshots) lives in the
stores; the manager only hands back ``(src, dst)`` copy pairs and padded
int32 tables for the jitted gather/scatter paths to consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.blocks.pool import NULL_BLOCK, BlockPool
from repro_torch.serving.blocks.prefix import PrefixCache, chain_hash


@dataclass
class SeqBlocks:
    """One live sequence's paging record."""

    rid: int
    tokens: np.ndarray              # prompt tokens (drives chain hashing)
    table: list[int]                # physical block per logical block idx
    n_cached: int                   # prompt tokens served from the cache
    hashes: list[str] = field(default_factory=list)  # chain keys so far


class PagedSequenceManager:
    """Block tables + prefix reuse + COW for a set of live sequences."""

    def __init__(self, pool: BlockPool, cache: PrefixCache,
                 block_size: int):
        self.pool = pool
        self.cache = cache
        self.block_size = block_size
        self._seqs: dict[int, SeqBlocks] = {}

    # -- lifecycle ----------------------------------------------------------

    def blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.block_size)

    def can_admit(self, total_len: int) -> bool:
        """Conservative: ignores prefix hits (they only help)."""
        return (self.pool.n_free + self.pool.n_cached
                >= self.blocks_needed(total_len))

    def create(self, rid: int, tokens, total_len: int, *,
               probe: bool = True) -> SeqBlocks:
        """Admit a sequence: match the prefix cache, retain the hit
        blocks, allocate fresh blocks for the rest of ``total_len``.

        ``n_cached`` is clamped to the largest multiple of ``block_size``
        strictly below ``len(tokens)`` so at least the last prompt token
        is always recomputed (its logits seed decode).  ``probe=False``
        skips the cache entirely (prefix caching disabled).
        """
        if rid in self._seqs:
            # overwriting would orphan the old record's refcounts: its
            # blocks stay active forever, and a later free() of a reused
            # id double-releases whichever record survived
            raise ValueError(f"sequence {rid} already exists")
        toks = np.asarray(tokens, np.int64)
        bs = self.block_size
        k_max = (len(toks) - 1) // bs
        if probe:
            hashes, bids = self.cache.match(toks, bs, max_blocks=k_max)
        else:
            hashes, bids = [], []
        for bid in bids:
            self.pool.retain(bid)
        n_total = self.blocks_needed(total_len)
        fresh: list[int] = []
        try:
            for _ in range(n_total - len(bids)):
                fresh.append(self.pool.allocate())
        except Exception:
            for bid in fresh + bids:
                self.pool.release(bid)
            raise
        seq = SeqBlocks(rid=rid, tokens=toks, table=bids + fresh,
                        n_cached=len(bids) * bs, hashes=list(hashes))
        self._seqs[rid] = seq
        return seq

    def commit(self, rid: int) -> None:
        """After prefill: register this sequence's remaining *full*
        prompt blocks in the prefix cache (insert-if-absent — an
        existing mapping for the same chain key wins, and this
        sequence's recomputed duplicate stays private)."""
        seq = self._seqs[rid]
        bs = self.block_size
        prev = seq.hashes[-1] if seq.hashes else None
        for i in range(len(seq.hashes), len(seq.tokens) // bs):
            h = chain_hash(prev, seq.tokens[i * bs:(i + 1) * bs])
            if self.cache.get(h) is None:
                bid = seq.table[i]
                self.pool.set_hash(bid, h)
                self.cache.insert(h, bid)
            seq.hashes.append(h)
            prev = h

    def fork(self, parent_rid: int, child_rid: int) -> SeqBlocks:
        """Copy-on-write fork: the child shares every parent block; the
        first write either side makes into a shared block triggers COW
        via :meth:`ensure_writable`."""
        if child_rid in self._seqs:
            raise ValueError(f"sequence {child_rid} already exists")
        parent = self._seqs[parent_rid]
        for bid in parent.table:
            self.pool.retain(bid)
        child = SeqBlocks(rid=child_rid, tokens=parent.tokens.copy(),
                          table=list(parent.table),
                          n_cached=parent.n_cached,
                          hashes=list(parent.hashes))
        self._seqs[child_rid] = child
        return child

    def adopt(self, tmp_rid: int, rid: int) -> SeqBlocks:
        """Rename a sequence (fork-commit protocol).

        The speculative write path forks a shadow of the live sequence,
        COWs and writes the shadow, then — only on success — frees the
        original and adopts the shadow under the original's id.  On any
        failure the shadow is freed instead and the original is intact:
        rollback is pure refcount release, never payload restore.  The
        target id must be free (the original already released).
        """
        if rid in self._seqs:
            raise ValueError(f"cannot adopt onto live sequence {rid}")
        seq = self._seqs.pop(tmp_rid)
        seq.rid = rid
        self._seqs[rid] = seq
        return seq

    def free(self, rid: int) -> None:
        seq = self._seqs.pop(rid)
        for bid in seq.table:
            self.pool.release(bid)

    # -- write discipline ---------------------------------------------------

    def ensure_writable(self, rid: int, pos: int
                        ) -> Optional[tuple[int, int]]:
        """Guarantee the block covering ``pos`` is exclusively owned.

        Returns a ``(src, dst)`` payload-copy pair when COW fired (the
        caller must apply it to the store before writing), else None.
        """
        seq = self._seqs[rid]
        idx = pos // self.block_size
        bid, pair = self.pool.writable(seq.table[idx])
        seq.table[idx] = bid
        return pair

    def ensure_span_writable(self, rid: int, start: int, end: int
                             ) -> list[tuple[int, int]]:
        """COW every block touched by positions ``[start, end)``."""
        pairs = []
        for pos in range(start, end, self.block_size):
            pair = self.ensure_writable(rid, pos)
            if pair is not None:
                pairs.append(pair)
        if end > start:
            pair = self.ensure_writable(rid, end - 1)
            if pair is not None:
                pairs.append(pair)
        return pairs

    # -- serving-state checkpoint -------------------------------------------

    def state_dict(self) -> dict:
        """JSON-safe snapshot of every live sequence's paging record
        (block tables reference physical ids; the pool snapshots its
        own refcounts separately)."""
        return {"seqs": [
            {"rid": int(s.rid), "tokens": s.tokens.tolist(),
             "table": [int(b) for b in s.table],
             "n_cached": int(s.n_cached), "hashes": list(s.hashes)}
            for s in self._seqs.values()]}

    def load_state(self, state: dict) -> None:
        self._seqs = {
            int(e["rid"]): SeqBlocks(
                rid=int(e["rid"]),
                tokens=np.asarray(e["tokens"], np.int64),
                table=[int(b) for b in e["table"]],
                n_cached=int(e["n_cached"]),
                hashes=[str(h) for h in e["hashes"]])
            for e in state["seqs"]}

    # -- views --------------------------------------------------------------

    def get(self, rid: int) -> SeqBlocks:
        return self._seqs[rid]

    def has(self, rid: int) -> bool:
        return rid in self._seqs

    def table_array(self, rid: int, max_blocks: int) -> np.ndarray:
        """Padded int32 table row for the jitted paths."""
        seq = self._seqs[rid]
        row = np.full((max_blocks,), NULL_BLOCK, np.int32)
        row[:len(seq.table)] = seq.table
        return row

    def stats(self) -> dict:
        return {
            "block_occupancy": self.pool.occupancy(),
            "blocks_active": self.pool.n_active,
            "blocks_cached": self.pool.n_cached,
            "blocks_free": self.pool.n_free,
            "evictions": self.pool.evictions,
            "prefix_hit_rate": self.cache.hit_rate,
            "prefix_entries": len(self.cache),
        }
