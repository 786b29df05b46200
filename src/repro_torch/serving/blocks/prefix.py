"""Content-hash prefix cache: hash-chained token blocks -> physical blocks.

Two prompts that share a prefix share *content*, and content is what the
hash chain names: block ``i``'s key is ``H(key_{i-1} || tokens_i)``, so
a physical block is reusable exactly when every token before it *and*
inside it matches — positional reuse falls out of content addressing
(the vLLM prefix-caching design).

The cache maps chain hashes to physical block ids in a
:class:`~repro_torch.serving.blocks.pool.BlockPool`; whether a block holds KV
rows (attention families) or a recurrent state snapshot at the block
boundary (SSM/mamba2) is the store's business — the chain key is the
same, which is what lets both state families share one pool.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def chain_hash(prev: Optional[str], tokens) -> str:
    """Key for the block holding ``tokens``, chained on the prefix key."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int64))
    h = hashlib.sha1()
    h.update(b"" if prev is None else prev.encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def chain_hashes(tokens, block_size: int) -> list[str]:
    """Chain keys for every *full* block of ``tokens``."""
    arr = np.asarray(tokens)
    out: list[str] = []
    prev: Optional[str] = None
    for i in range(len(arr) // block_size):
        prev = chain_hash(prev, arr[i * block_size:(i + 1) * block_size])
        out.append(prev)
    return out


class PrefixCache:
    """chain hash -> physical block id, plus hit accounting.

    The mapping's lifetime is owned jointly with the pool: ``insert``
    happens when a full block is committed after prefill, ``drop`` when
    the pool evicts the LRU cached block (wired through
    ``BlockPool(on_evict=...)``).
    """

    def __init__(self):
        self._map: dict[str, int] = {}
        self.lookup_tokens = 0          # full-block prompt tokens probed
        self.hit_tokens = 0             # of those, served from cache

    def __len__(self) -> int:
        return len(self._map)

    def get(self, h: str) -> Optional[int]:
        return self._map.get(h)

    def insert(self, h: str, bid: int) -> None:
        self._map[h] = bid

    def drop(self, bid: int, h: str) -> None:
        """Pool eviction callback: forget the evicted block's hash."""
        if self._map.get(h) == bid:
            del self._map[h]

    # -- matching -----------------------------------------------------------

    def match(self, tokens, block_size: int,
              max_blocks: Optional[int] = None
              ) -> tuple[list[str], list[int]]:
        """Longest cached chain prefix of ``tokens``.

        Returns ``(hashes, block_ids)`` for the matched full blocks —
        both lists have the same length ``k``, meaning the first
        ``k * block_size`` tokens are reusable.  ``max_blocks`` caps the
        match (callers clamp so the last prompt token is recomputed).
        Also accumulates the hit-rate counters (over prompt tokens
        probed).
        """
        hashes = chain_hashes(tokens, block_size)
        if max_blocks is not None:
            hashes = hashes[:max_blocks]
        matched_h: list[str] = []
        matched_b: list[int] = []
        for h in hashes:
            bid = self._map.get(h)
            if bid is None:
                break
            matched_h.append(h)
            matched_b.append(bid)
        self.lookup_tokens += len(np.asarray(tokens))
        self.hit_tokens += len(matched_b) * block_size
        return matched_h, matched_b

    # -- serving-state checkpoint -------------------------------------------

    def state_dict(self) -> dict:
        """JSON-safe snapshot (hash map + hit accounting)."""
        return {"map": dict(self._map),
                "lookup_tokens": int(self.lookup_tokens),
                "hit_tokens": int(self.hit_tokens)}

    def load_state(self, state: dict) -> None:
        self._map = {str(h): int(b) for h, b in state["map"].items()}
        self.lookup_tokens = int(state["lookup_tokens"])
        self.hit_tokens = int(state["hit_tokens"])

    @property
    def hit_rate(self) -> Optional[float]:
        """Cached fraction of all prompt tokens probed so far."""
        if self.lookup_tokens == 0:
            return None
        return self.hit_tokens / self.lookup_tokens
