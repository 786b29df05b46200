"""Physical paged state: block-granular KV pages and state snapshots.

:class:`KVPagedStore` holds the attention families' KV rows in
``(L, num_blocks, block_size, Hk, Dh)`` pages; a per-sequence block
table maps logical positions to physical blocks, and the decode step
*gathers* through the table instead of indexing a contiguous cache.
With ``codec="trit"`` the pages hold **ternarized** rows packed 5
trits/byte (`repro_torch.core.codec` layout) plus one scale per
(position, head) — 1.6 bits per element (paper §III-A).

The reference's methods are pure ``(pages, ...) -> pages`` functions for
jit; here they take the same arguments, write into ``pages`` in place and
return it, and the store keeps the live ``self.pages``.

:class:`StatePagedStore` holds the ssm family's recurrent state: one
block is one sequence's state snapshot (all layers), packed 5 trits per
byte under ``codec="trit"`` for ternary state.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import codec
from repro_torch.kernels.trit_codec import ternarize_rows  # noqa: F401
from repro_torch.models.attention import KV_DTYPES
from repro_torch.serving.blocks.pool import NULL_BLOCK


def pack_last_axis(t: torch.Tensor) -> torch.Tensor:
    """Trits {-1,0,1} ``(..., n)`` -> uint8 ``(..., ceil(n/5))``
    (little-endian in the trit index, `repro_torch.core.codec` layout)."""
    n = t.shape[-1]
    rows = codec.pack_rows(t.reshape(-1, n).to(torch.int8))
    return rows.reshape(*t.shape[:-1], rows.shape[-1])


def unpack_last_axis(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_last_axis`: ``(..., ceil(n/5))`` bytes ->
    ``(..., n)`` int8 trits."""
    g = b.shape[-1]
    t = codec.unpack_rows(b.reshape(-1, g))
    return t.reshape(*b.shape[:-1], g * codec.TRITS_PER_BYTE)[..., :n]


class KVPagedStore:
    """Paged KV pages + gather/scatter over block tables."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_kv: int, d_head: int, dtype="bfloat16",
                 codec_name: str = "raw", device=None):
        if codec_name not in ("raw", "trit"):
            raise ValueError(f"codec must be 'raw' or 'trit', "
                             f"got {codec_name!r}")
        self.n_layers, self.num_blocks = n_layers, num_blocks
        self.block_size, self.n_kv, self.d_head = block_size, n_kv, d_head
        self.dtype = KV_DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.codec = codec_name
        dev = device
        if codec_name == "raw":
            kv = (n_layers, num_blocks, block_size, n_kv, d_head)
            self.pages = {"k": torch.zeros(kv, dtype=self.dtype, device=dev),
                          "v": torch.zeros(kv, dtype=self.dtype, device=dev)}
        else:
            pw = codec.packed_size(d_head)
            pk = (n_layers, num_blocks, block_size, n_kv, pw)
            sc = (n_layers, num_blocks, block_size, n_kv)
            u8, f32 = torch.uint8, torch.float32
            self.pages = {"k": torch.zeros(pk, dtype=u8, device=dev),
                          "v": torch.zeros(pk, dtype=u8, device=dev),
                          "k_scale": torch.zeros(sc, dtype=f32, device=dev),
                          "v_scale": torch.zeros(sc, dtype=f32, device=dev)}

    # -- sizing -------------------------------------------------------------

    def bytes_per_block(self) -> int:
        """Physical bytes of one block across all layers (both of K/V)."""
        per = self.block_size * self.n_kv
        if self.codec == "raw":
            elem = per * self.d_head * self.dtype.itemsize
        else:
            elem = per * (codec.packed_size(self.d_head) + 4)  # + f32 scale
        return 2 * self.n_layers * elem

    # -- codec --------------------------------------------------------------

    def _encode(self, rows: torch.Tensor) -> dict:
        """Compute-dtype rows -> stored representation dict pieces: with
        the trit codec, `ternarize_rows` then `pack_last_axis`, in one
        launch of the pack kernel on the card."""
        if self.codec == "raw":
            return {"": rows.to(self.dtype)}
        lead, n = rows.shape[:-1], rows.shape[-1]
        packed, scale = codec.ternarize_pack_rows(rows.reshape(-1, n))
        return {"": packed.reshape(*lead, packed.shape[-1]),
                "_scale": scale.reshape(lead)}

    def _decode(self, packed: torch.Tensor, scale) -> torch.Tensor:
        """Stored rows -> bf16 rows: with the trit codec, each row's
        first d_head trits times its scale, in one launch of the unpack
        kernel on the card."""
        if self.codec == "raw":
            return packed
        lead, g = packed.shape[:-1], packed.shape[-1]
        rows = codec.dequant_rows(packed.reshape(-1, g), scale.reshape(-1),
                                  self.d_head)
        return rows.reshape(*lead, self.d_head)

    # -- gather / scatter -----------------------------------------------------

    def gather(self, pages: dict, tables: torch.Tensor) -> dict:
        """``tables (B, MB)`` -> contiguous KV copy
        ``{"k"/"v": (L, B, MB*block_size, Hk, Dh)}``."""
        tables = tables.to(torch.int64)
        out = {}
        for name in ("k", "v"):
            g = pages[name][:, tables]       # (L, B, MB, BS, Hk, [Dh|PW])
            sc = (pages[f"{name}_scale"][:, tables]
                  if self.codec == "trit" else None)
            l, b, mb, bs = g.shape[:4]
            g = self._decode(g, sc)
            out[name] = g.reshape(l, b, mb * bs, *g.shape[4:])
        return out

    def _scatter(self, pages: dict, blocks, off, kv: dict) -> dict:
        for name in ("k", "v"):
            enc = self._encode(kv[name])
            pages[name][:, blocks, off] = enc[""]
            if self.codec == "trit":
                pages[f"{name}_scale"][:, blocks, off] = enc["_scale"]
        return pages

    def write_rows(self, pages: dict, tables: torch.Tensor,
                   pos: torch.Tensor, rows: dict) -> dict:
        """Scatter one decode step's new rows ``{"k"/"v": (L, B, Hk, Dh)}``
        at per-sequence positions ``pos (B,)`` through the tables."""
        pos = pos.to(torch.int64)
        tables = tables.to(torch.int64)
        b = pos.shape[0]
        blocks = tables[torch.arange(b, device=pos.device),
                        pos // self.block_size]
        return self._scatter(pages, blocks, pos % self.block_size, rows)

    def write_span(self, pages: dict, table: torch.Tensor, start: int,
                   n_real: int, kv: dict) -> dict:
        """Scatter a prefill's suffix rows ``{"k"/"v": (L, S, Hk, Dh)}``
        at positions ``start .. start+n_real-1`` of one sequence.

        ``S`` is the prefill bucket; rows past ``n_real`` (bucket padding)
        are routed to the null block, which never holds live data.
        """
        table = table.to(torch.int64)
        s = kv["k"].shape[1]
        j = torch.arange(s, device=table.device)
        posn = start + j
        valid = j < n_real
        idx = torch.clamp(posn // self.block_size, 0, table.shape[0] - 1)
        blocks = torch.where(valid, table[idx], NULL_BLOCK)
        off = torch.where(valid, posn % self.block_size, 0)
        return self._scatter(pages, blocks, off, kv)

    def copy_blocks(self, pages: dict, src, dst) -> dict:
        """COW payload copies: ``pages[:, dst] = pages[:, src]``."""
        for arr in pages.values():
            arr[:, dst] = arr[:, src]
        return pages

    def apply_copies(self, pairs: list[tuple[int, int]]) -> None:
        if not pairs:
            return
        dev = next(iter(self.pages.values())).device
        src = torch.as_tensor([p[0] for p in pairs], device=dev)
        dst = torch.as_tensor([p[1] for p in pairs], device=dev)
        self.pages = self.copy_blocks(self.pages, src, dst)


class StatePagedStore:
    """State-slot pages: one block = one recurrent-state snapshot.

    ``template`` is a dict of tensors describing one sequence's state
    (the ssm family's ``conv_x``, ``conv_b``, ``conv_c``, ``ssm``
    leaves, each with its layer axis); only shapes, dtypes and the
    device are read.  ``pages`` is a list with one tensor per leaf in
    sorted key order, the reference's leaf order (JAX flattens a dict by
    sorted keys), so a snapshot's pages cross between the packages.
    With ``codec="trit"`` every leaf must hold trits in {-1, 0, +1}; a
    leaf is flattened and packed 5/byte (`pack_last_axis`, the pack
    kernel for a card tensor) — an exact round trip.
    """

    def __init__(self, num_blocks: int, template: dict,
                 codec_name: str = "raw", device=None):
        if codec_name not in ("raw", "trit"):
            raise ValueError(f"codec must be 'raw' or 'trit', "
                             f"got {codec_name!r}")
        self.num_blocks = num_blocks
        self.codec = codec_name
        self.keys = tuple(sorted(template))
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        self.dtypes = [template[k].dtype for k in self.keys]
        dev = device if device is not None else \
            next(iter(template.values())).device
        if codec_name == "raw":
            self.pages = [torch.zeros((num_blocks,) + s, dtype=d, device=dev)
                          for s, d in zip(self.shapes, self.dtypes)]
        else:
            self.pages = [torch.zeros(
                (num_blocks, codec.packed_size(math.prod(s) or 1)),
                dtype=torch.uint8, device=dev) for s in self.shapes]

    def bytes_per_block(self) -> int:
        return sum(pg[0].numel() * pg.element_size() for pg in self.pages)

    # -- ops on ``pages`` ----------------------------------------------------

    def read(self, pages: list, bids) -> dict:
        """``bids (B,)`` -> state dict with a leading batch axis."""
        out = {}
        for k, pg, shape, dt in zip(self.keys, pages, self.shapes,
                                    self.dtypes):
            a = pg[bids]
            if self.codec == "trit":
                n = math.prod(shape) or 1
                a = unpack_last_axis(a, n).reshape(
                    (a.shape[0],) + shape).to(dt)
            out[k] = a
        return out

    def write(self, pages: list, bid, state: dict) -> list:
        """Store one sequence's state dict into block ``bid``."""
        for k, pg in zip(self.keys, pages):
            leaf = state[k]
            if self.codec == "trit":
                leaf = pack_last_axis(leaf.reshape(-1))
            pg[bid] = leaf.to(pg.dtype)
        return pages

    def write_batch(self, pages: list, bids, states: dict) -> list:
        """Scatter a batch of states (leaves with a leading batch axis
        matching ``bids (B,)``) into their blocks."""
        for k, pg in zip(self.keys, pages):
            leaf = states[k]
            if self.codec == "trit":
                leaf = pack_last_axis(leaf.reshape(leaf.shape[0], -1))
            pg[bids] = leaf.to(pg.dtype)
        return pages

    def copy_blocks(self, pages: list, src, dst) -> list:
        for pg in pages:
            pg[dst] = pg[src]
        return pages

    # -- eager wrappers ------------------------------------------------------

    def _ids(self, bids) -> torch.Tensor:
        return torch.as_tensor(bids, dtype=torch.int64,
                               device=self.pages[0].device)

    def write_(self, bid: int, state: dict) -> None:
        self.pages = self.write(self.pages, int(bid), state)

    def read_(self, bids) -> dict:
        return self.read(self.pages, self._ids(bids))

    def apply_copies(self, pairs: list[tuple[int, int]]) -> None:
        if not pairs:
            return
        self.pages = self.copy_blocks(self.pages,
                                      self._ids([p[0] for p in pairs]),
                                      self._ids([p[1] for p in pairs]))
