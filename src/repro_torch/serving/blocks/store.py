"""Physical paged state: block-granular KV pages.

:class:`KVPagedStore` holds the attention families' KV rows in
``(L, num_blocks, block_size, Hk, Dh)`` pages; a per-sequence block
table maps logical positions to physical blocks, and the decode step
*gathers* through the table instead of indexing a contiguous cache.
With ``codec="trit"`` the pages hold **ternarized** rows packed 5
trits/byte (`repro_torch.core.codec` layout) plus one scale per
(position, head) — 1.6 bits per element (paper §III-A).

The reference's methods are pure ``(pages, ...) -> pages`` functions for
jit; here they take the same arguments, write into ``pages`` in place and
return it, and the store keeps the live ``self.pages``.  The reference's
``StatePagedStore`` (SSM state snapshots) comes with the mamba2 family
(ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.core import codec
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


def ternarize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric ternarization over the last axis.

    Returns ``(trits int8, scale f32)`` with ``scale = max|v|`` and a
    0.5-scale dead zone — the TWN-style quantizer the rest of the repo
    uses for activations, applied to KV rows at cache-write time.
    """
    x = v.to(torch.float32)
    scale = x.abs().amax(dim=-1)
    safe = torch.clamp(scale, min=1e-12)[..., None]
    t = torch.where(x.abs() > 0.5 * safe, torch.sign(x),
                    torch.zeros((), device=x.device))
    return t.to(torch.int8), scale


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
        """Compute-dtype rows -> stored representation dict pieces."""
        if self.codec == "raw":
            return {"": rows.to(self.dtype)}
        t, scale = ternarize_rows(rows)
        return {"": pack_last_axis(t), "_scale": scale}

    def _decode(self, packed: torch.Tensor, scale) -> torch.Tensor:
        if self.codec == "raw":
            return packed
        t = unpack_last_axis(packed, self.d_head)
        return (t.to(torch.float32) * scale[..., None]).to(torch.bfloat16)

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
