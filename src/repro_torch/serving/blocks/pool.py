"""`BlockPool` — fixed-size physical block allocator with prefix reuse.

CUTIE's thesis is that *storing and moving* state, not compute, is the
energy wall; the serving analogue is that decode memory, not FLOPs, is
the capacity wall.  The pool manages a fixed budget of physical blocks
(the vLLM ``core/block/`` design) so sequences share identical prefix
blocks instead of duplicating them per slot:

* **refcounted allocation** — a block is *active* while any sequence
  references it; freeing a sequence releases its references;
* **prefix retention + LRU eviction** — a block registered under a
  content hash is not freed when its last reference drops: it parks in
  an LRU "cached" set, ready to be reused by a later prompt with the
  same prefix.  When the free list runs dry, the least-recently-parked
  cached block is evicted (its hash mapping dropped via ``on_evict``)
  and recycled;
* **copy-on-write discipline** — a shared block (refcount > 1, or a
  cached block another sequence may still match) must never be written
  in place; callers ask :meth:`writable` and get back a fresh block id
  plus the (src, dst) payload copy to perform.

Physical block id 0 is reserved as the **null block**: block tables are
padded with it, and masked/padded writes are directed at it, so it never
holds live data.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Optional

NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool is exhausted: every block is active (referenced)."""


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical blocks.

    ``num_blocks`` includes the reserved null block 0, so the usable
    capacity is ``num_blocks - 1``.  ``on_evict(block_id, content_hash)``
    is called when an LRU cached block is recycled, so the owning prefix
    cache can drop its hash mapping.
    """

    def __init__(self, num_blocks: int,
                 on_evict: Optional[Callable[[int, str], None]] = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved "
                             f"null block), got {num_blocks}")
        self.num_blocks = num_blocks
        self.on_evict = on_evict
        self._free: deque[int] = deque(range(1, num_blocks))
        self._ref: dict[int, int] = {}
        self._hash: dict[int, str] = {}            # bid -> content hash
        self._cached: OrderedDict[int, str] = OrderedDict()  # LRU parked
        self.evictions = 0

    # -- accounting ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    @property
    def n_active(self) -> int:
        return self.capacity - self.n_free - self.n_cached

    def occupancy(self) -> float:
        """Fraction of usable blocks holding live (referenced) state."""
        return self.n_active / self.capacity

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def shared(self, bid: int) -> bool:
        """True when writing ``bid`` in place would corrupt another
        sequence or a still-matchable cached prefix."""
        return self._ref.get(bid, 0) > 1 or bid in self._hash

    def content_hash(self, bid: int) -> Optional[str]:
        return self._hash.get(bid)

    # -- allocate / retain / release ----------------------------------------

    def allocate(self) -> int:
        """One unreferenced block: free list first, else evict the LRU
        cached prefix block; raises :class:`OutOfBlocks` when every
        block is actively referenced."""
        if self._free:
            bid = self._free.popleft()
        elif self._cached:
            bid, h = self._cached.popitem(last=False)   # LRU end
            del self._hash[bid]
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(bid, h)
        else:
            raise OutOfBlocks(
                f"all {self.capacity} blocks are active; "
                "free or shrink sequences, or grow num_blocks")
        self._ref[bid] = 1
        return bid

    def retain(self, bid: int) -> int:
        """Take one more reference (prefix hit, fork).  Reactivates a
        parked cached block.

        A block that is neither referenced nor parked is *free* (or was
        evicted and recycled): retaining it would resurrect a block the
        allocator may already have handed to someone else, silently
        corrupting the free list — callers holding such a stale id must
        fail loudly instead.
        """
        if bid == NULL_BLOCK:
            raise ValueError("cannot retain the null block")
        if bid in self._cached:
            del self._cached[bid]
        elif bid not in self._ref:
            raise ValueError(
                f"retain of free/evicted block {bid}: the id is stale "
                "(its block was evicted from the cached set or freed)")
        self._ref[bid] = self._ref.get(bid, 0) + 1
        return bid

    def release(self, bid: int) -> None:
        """Drop one reference.  At zero, a hash-registered block parks
        in the LRU cached set (still prefix-matchable); an anonymous
        block returns to the free list."""
        n = self._ref.get(bid, 0) - 1
        if n < 0:
            raise ValueError(f"release of unreferenced block {bid}")
        if n > 0:
            self._ref[bid] = n
            return
        del self._ref[bid]
        if bid in self._hash:
            self._cached[bid] = self._hash[bid]     # MRU end
        else:
            self._free.append(bid)

    # -- serving-state checkpoint -------------------------------------------

    def state_dict(self) -> dict:
        """JSON-safe snapshot of the allocator (free list order, refs,
        hash registrations, LRU order of the cached set)."""
        return {
            "free": [int(b) for b in self._free],
            "ref": {str(b): int(n) for b, n in self._ref.items()},
            "hash": {str(b): h for b, h in self._hash.items()},
            "cached": [[int(b), h] for b, h in self._cached.items()],
            "evictions": int(self.evictions),
        }

    def load_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`, onto a pool of the same size."""
        accounted = (len(state["free"]) + len(state["ref"])
                     + len(state["cached"]))
        if accounted != self.capacity:
            raise ValueError(
                f"pool snapshot covers {accounted} blocks but this pool "
                f"has capacity {self.capacity}; restore into a pool of "
                "the size that saved")
        self._free = deque(int(b) for b in state["free"])
        self._ref = {int(b): int(n) for b, n in state["ref"].items()}
        self._hash = {int(b): str(h) for b, h in state["hash"].items()}
        self._cached = OrderedDict(
            (int(b), str(h)) for b, h in state["cached"])
        self.evictions = int(state["evictions"])

    # -- prefix-cache integration -------------------------------------------

    def set_hash(self, bid: int, content_hash: str) -> None:
        """Register ``bid`` as the physical block for a content hash
        (full block committed to the prefix cache)."""
        self._hash[bid] = content_hash

    def drop_hash(self, bid: int) -> None:
        """Unregister a block's hash (cache invalidation); a parked
        block becomes plain free."""
        self._hash.pop(bid, None)
        if bid in self._cached:
            del self._cached[bid]
            self._free.append(bid)

    # -- copy-on-write ------------------------------------------------------

    def writable(self, bid: int) -> tuple[int, Optional[tuple[int, int]]]:
        """A block id safe to write in place of ``bid``.

        Returns ``(bid, None)`` when exclusive, else allocates a fresh
        private block and returns ``(new_bid, (bid, new_bid))`` — the
        caller must copy the payload src -> dst and has already lost one
        reference on src (release happens here).
        """
        if not self.shared(bid):
            return bid, None
        new = self.allocate()
        self.release(bid)
        return new, (bid, new)

    def __repr__(self) -> str:
        return (f"BlockPool(capacity={self.capacity}, "
                f"active={self.n_active}, cached={self.n_cached}, "
                f"free={self.n_free}, evictions={self.evictions})")
