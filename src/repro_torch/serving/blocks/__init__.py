"""Paged ternary state: block-granular KV memory with prefix reuse.

The subsystem splits into four pieces:

* :mod:`~repro_torch.serving.blocks.pool` — `BlockPool`, the refcounted
  physical-block allocator with LRU eviction of parked prefix blocks
  and copy-on-write discipline (`writable`).
* :mod:`~repro_torch.serving.blocks.prefix` — `PrefixCache`, the
  content-hash (chain-hashed token block) -> physical block map plus hit
  accounting.
* :mod:`~repro_torch.serving.blocks.store` — the physical pages:
  `KVPagedStore` (attention KV rows, optionally ternarized + packed
  5 trits/byte).
* :mod:`~repro_torch.serving.blocks.manager` — `PagedSequenceManager`,
  the per-sequence block tables tying the three together.

`repro_torch.serving.llm.LLMExecutor` composes these into the paged
serving path.
"""

from repro_torch.serving.blocks.manager import PagedSequenceManager, SeqBlocks
from repro_torch.serving.blocks.pool import NULL_BLOCK, BlockPool, OutOfBlocks
from repro_torch.serving.blocks.prefix import (PrefixCache, chain_hash,
                                               chain_hashes)
from repro_torch.serving.blocks.store import (KVPagedStore, pack_last_axis,
                                              ternarize_rows,
                                              unpack_last_axis)

__all__ = [
    "NULL_BLOCK",
    "BlockPool",
    "OutOfBlocks",
    "PrefixCache",
    "chain_hash",
    "chain_hashes",
    "KVPagedStore",
    "pack_last_axis",
    "unpack_last_axis",
    "ternarize_rows",
    "PagedSequenceManager",
    "SeqBlocks",
]
