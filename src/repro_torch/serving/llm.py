"""Autoregressive LLM serving: paged-state slot-resident executor.

The port of the reference's `LLMExecutor` for the dense, vlm (text
only, as the reference serves it), moe and ssm families: a serving loop whose inner decode is one step for the whole
slot batch, rebuilt on the paged-state subsystem
(:mod:`repro_torch.serving.blocks`):

* decode memory is a fixed pool of physical blocks, not a per-slot
  contiguous cache — sequences *share* identical prompt-prefix blocks
  (content-hash chain over token blocks), freed blocks park in an LRU
  set ready for the next matching prompt, and forks are copy-on-write;
* prefill and decode are explicitly separate paths:
  :meth:`LLMExecutor.prefill` matches the prefix cache, gathers the
  cached prefix KV, and runs the model only over the *suffix* from the
  first novel block; :meth:`LLMExecutor.decode` advances every live
  slot one token, gathering per-slot blocks through the block table;
* SSM (mamba2) state slots draw from the same pool: a block holds one
  recurrent-state snapshot at a token-block boundary (the SSM analogue
  of a KV prefix), optionally packed 5 trits/byte for ternary state,
  and each slot holds one working block for its live state.

Every projection of the model runs the packed-trit matmul kernel when
``cfg.quant == "ternary_packed"`` and the tensors are on the card
(`repro_torch.models.common.linear`).

``ServerConfig(paged=False)`` keeps a contiguous cache but runs the
*same* prefill/decode math, so paged-vs-contiguous exactness is testable
by construction.  Exact equality additionally wants
``cfg.attn_kv_chunk <= block_size`` so the flash kv-chunk grid is
identical for full-prompt and suffix prefill.

`LLMExecutor.snapshot` / `restore` give the serving state to
:mod:`repro_torch.serving.snapshot` in the reference's layout.  The
reference's jit variant cache becomes the same bookkeeping of prefill
bucket shapes, so ``n_jit_variants`` keeps its meaning: the shapes seen
plus the decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import decoding as DEC
from repro_torch.models.config import ArchConfig
from repro_torch.serving.blocks import (BlockPool, KVPagedStore, OutOfBlocks,
                                        PagedSequenceManager, PrefixCache,
                                        StatePagedStore, chain_hashes)
from repro_torch.serving.executors import ExecutionReport, Executor

_ATTN_FAMILIES = ("dense", "vlm", "moe")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_len: int = 256
    n_slots: int = 4
    max_new_tokens: int = 32
    eos_id: int = -1              # -1: run to max_new_tokens
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0
    # paged-state knobs
    paged: bool = True
    block_size: int = 16
    num_blocks: Optional[int] = None   # physical blocks incl. null; default
    #                                    (n_slots + 2) tables' worth + null
    kv_codec: str = "raw"              # "raw" | "trit" (lossy, opt-in)
    state_codec: str = "raw"           # "raw" | "trit" (exact for trits)
    prefix_caching: bool = True


@dataclasses.dataclass(frozen=True)
class ExistingPrefix:
    """How much of a prompt was served from the prefix cache
    (JetStream's `ExistingPrefix` shape: the reusable prefix plus its
    backing cache handle — here, physical block ids)."""

    common_prefix_tokens: int
    blocks: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PrefillResult:
    first_token: int
    prefix: ExistingPrefix
    prompt_len: int
    tokens_computed: int     # suffix tokens actually run (excl. padding)


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family no executor serves: the reference's
    `LLMExecutor` has no path for hybrid or encdec either (they run
    through `transformer.forward_logits` and `decoding.decode_step`)."""
    if cfg.family not in _ATTN_FAMILIES + ("ssm",):
        raise NotImplementedError(
            f"LLMExecutor serves {_ATTN_FAMILIES + ('ssm',)}, got "
            f"family={cfg.family!r}: the reference has no serving executor "
            "for it; run it through transformer.forward_logits and "
            "decoding.decode_step")


def _on_device(tree, dev):
    """A dict tree of arrays as tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree).to(dev)


def _bucket(n: int, floor: int) -> int:
    """Smallest power-of-2 >= n, floored — bounds prefill shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


class LLMExecutor(Executor):
    """Slot-resident continuous-batching decode loop over paged state.

    ``params`` are the port's model parameters
    (`repro_torch.models.transformer.init_params` or
    `repro_torch.convert.llm_params_from_numpy`); the executor runs on
    their device.
    """

    def __init__(self, params, cfg: ArchConfig, scfg: ServerConfig):
        check_family(cfg)
        if scfg.max_len % scfg.block_size:
            raise ValueError(
                f"max_len={scfg.max_len} must be a multiple of "
                f"block_size={scfg.block_size}")
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.is_ssm = cfg.family == "ssm"
        self.device = params["embed"].device
        self.slots: list = [None] * scfg.n_slots       # resident Requests
        self.pos = np.zeros((scfg.n_slots,), np.int64)  # host bookkeeping
        self.cur_tok = torch.zeros((scfg.n_slots, 1), dtype=torch.int64,
                                   device=self.device)
        self._tokens: dict[int, list[int]] = {}        # uid -> output tokens
        self._prompts: dict[int, np.ndarray] = {}      # uid -> prompt tokens
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        self._prefill_shapes: set = set()              # prefill variants
        self.prefill_tokens = 0          # prompt tokens admitted
        self.prefill_tokens_computed = 0  # of those, actually run
        self.n_prefills = 0              # model forwards over a prompt
        self.n_decode_steps = 0          # model forwards of one token/slot

        bs = scfg.block_size
        self.blocks_per_seq = scfg.max_len // bs
        nb = scfg.num_blocks or 1 + (scfg.n_slots + 2) * self.blocks_per_seq
        self.cache = PrefixCache()
        self.pool = BlockPool(nb, on_evict=self._on_evict)

        if scfg.paged:
            self._init_paged(nb)
        else:
            self.caches = DEC.init_caches(cfg, scfg.n_slots, scfg.max_len,
                                          device=self.device)

    def _init_paged(self, num_blocks: int) -> None:
        cfg, scfg = self.cfg, self.scfg
        if self.is_ssm:
            self.state_store = StatePagedStore(
                num_blocks, self._empty_state(),
                codec_name=scfg.state_codec)
            # one permanently-held working block per slot
            self._slot_bids = [self.pool.allocate()
                               for _ in range(scfg.n_slots)]
            return
        self.manager = PagedSequenceManager(self.pool, self.cache,
                                            scfg.block_size)
        self.kv_store = KVPagedStore(
            cfg.n_layers, num_blocks, scfg.block_size, cfg.n_kv, cfg.d_head,
            dtype=cfg.kv_dtype, codec_name=scfg.kv_codec, device=self.device)

    def _empty_state(self) -> dict:
        """One sequence's zero SSM state: leaves (L, ...) without the
        batch axis."""
        one = DEC.init_caches(self.cfg, 1, self.scfg.max_len,
                              device=self.device)
        return {k: v[:, 0] for k, v in one["ssm"].items()}

    def _on_evict(self, bid: int, h: str) -> None:
        """LRU eviction callback: drop the cache mapping, leave a trace
        event so cache-pressure stalls are visible on the timeline."""
        self.cache.drop(bid, h)
        self.obs.trace.instant("prefix_evict", cat="prefix", block=bid)
        self.obs.metrics.counter(
            "prefix_evictions_total",
            "cached blocks evicted under pool pressure").inc()

    # -- engine protocol ----------------------------------------------------

    def validate(self, prompt) -> np.ndarray:
        arr = np.asarray(prompt, np.int32)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"expected a non-empty 1-D token prompt, "
                             f"got shape {arr.shape}")
        budget = self.scfg.max_len - self.scfg.max_new_tokens
        if arr.size > budget:
            raise ValueError(
                f"prompt of {arr.size} tokens cannot fit: prompt + "
                f"max_new_tokens ({self.scfg.max_new_tokens}) must stay "
                f"within max_len={self.scfg.max_len} "
                f"(prompt budget {budget})")
        return arr

    def free_capacity(self) -> int:
        free_slots = sum(r is None for r in self.slots)
        if not self.scfg.paged or self.is_ssm:
            return free_slots
        avail = self.pool.n_free + self.pool.n_cached
        return min(free_slots, avail // self.blocks_per_seq)

    def has_resident(self) -> bool:
        return any(r is not None for r in self.slots)

    def execute(self, requests) -> ExecutionReport:
        """Prefill newly admitted requests, advance all active slots one
        step, release finished ones."""
        for req in requests:
            self._admit(req)
        live = sum(r is not None for r in self.slots)
        completions: list = []
        if live == 0:
            return ExecutionReport(completions, 0, self.scfg.n_slots,
                                   tokens_generated={})
        with self.obs.trace.span("decode", tid=0, cat="llm", live=live):
            step_tokens = self._step_tokens()
        self.obs.trace.counter("blocks", {
            "active": self.pool.n_active, "cached": self.pool.n_cached,
            "free": self.pool.n_free})
        tokens_generated: dict[int, int] = {}
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            toks = self._tokens[req.uid]
            plen = len(self._prompts[req.uid])
            finished = False
            emitted = 0
            for tok in step_tokens.get(i, ()):
                toks.append(tok)
                emitted += 1
                # `plen + len(toks) - 1` is the position counter a plain
                # decode loop holds after emitting this token
                if tok == self.scfg.eos_id or \
                        len(toks) >= self.scfg.max_new_tokens or \
                        plen + len(toks) - 1 >= self.scfg.max_len - 1:
                    finished = True
                    break
            tokens_generated[req.uid] = emitted
            if finished:
                completions.append((req.uid, self._tokens.pop(req.uid)))
                self._release(i)
        return ExecutionReport(completions, live, self.scfg.n_slots,
                               tokens_generated=tokens_generated)

    def _step_tokens(self) -> dict[int, list[int]]:
        """One engine step's new tokens per live slot (exactly one)."""
        nxt = self.decode().tolist()
        return {i: [int(nxt[i])]
                for i, r in enumerate(self.slots) if r is not None}

    def extra_stats(self) -> dict:
        """Paged-state accounting for ``engine.stats()``, plus the model
        forwards run (prefills and decode steps)."""
        out = {
            "paged": self.scfg.paged,
            "block_size": self.scfg.block_size,
            "block_occupancy": self.pool.occupancy(),
            "blocks_active": self.pool.n_active,
            "blocks_cached": self.pool.n_cached,
            "blocks_free": self.pool.n_free,
            "evictions": self.pool.evictions,
            "prefix_hit_rate": self.cache.hit_rate,
            "prefix_entries": len(self.cache),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefills": self.n_prefills,
            "decode_steps": self.n_decode_steps,
        }
        if not self.scfg.paged:
            out.update(block_occupancy=None, prefix_hit_rate=None)
        return out

    # -- prefill path --------------------------------------------------------

    def prefill(self, uid: int, tokens: np.ndarray) -> PrefillResult:
        """Run (only the novel part of) a prompt and make ``uid``
        resident in a free slot.  Returns the sampled first token and
        the :class:`ExistingPrefix` served from the cache."""
        slot = self.slots.index(None)
        plen = len(tokens)
        self._prompts[uid] = np.asarray(tokens, np.int64)
        self.prefill_tokens += plen
        self.obs.trace.begin("prefill", tid=uid, cat="request",
                             prompt_len=plen)
        if self.is_ssm:
            res = self._prefill_ssm(uid, slot, tokens)
        elif self.scfg.paged:
            res = self._prefill_paged(uid, slot, tokens)
        else:
            res = self._prefill_contiguous(uid, slot, tokens)
        self.prefill_tokens_computed += res.tokens_computed
        cached = res.prefix.common_prefix_tokens
        self.obs.trace.end("prefill", tid=uid, cat="request",
                           cached=cached, computed=res.tokens_computed)
        self.obs.trace.instant("prefix_hit" if cached else "prefix_miss",
                               tid=uid, cat="prefix", tokens=cached)
        self.obs.metrics.counter(
            "prefix_lookups_total", "prompt prefixes looked up in the "
            "block cache").inc(outcome="hit" if cached else "miss")
        self.obs.metrics.counter(
            "prefill_tokens_total", "prompt tokens by whether the prefix "
            "cache served them").inc(cached, source="cached")
        self.obs.metrics.counter(
            "prefill_tokens_total", "prompt tokens by whether the prefix "
            "cache served them").inc(res.tokens_computed, source="computed")
        self.pos[slot] = plen
        self.cur_tok[slot, 0] = res.first_token
        return res

    def _empty_prefix(self) -> dict:
        shape = (self.cfg.n_layers, 1, 0, self.cfg.n_kv, self.cfg.d_head)
        return {n: torch.zeros(shape, dtype=torch.bfloat16,
                               device=self.device) for n in ("k", "v")}

    def _suffix_forward(self, suffix: np.ndarray, n_cached: int, prefix_kv):
        """One bucketed forward of ``suffix`` tokens at positions
        ``n_cached ..`` over the prefix rows: ``(logits (1, S, V), kv,
        n_real)``.  Prefill and speculative verification share it, and
        its bucket shapes."""
        n_real = len(suffix)
        sb = _bucket(n_real, self.scfg.block_size)
        padded = np.zeros((1, sb), np.int64)
        padded[0, :n_real] = suffix
        self._prefill_shapes.add(("kv", n_cached, sb))
        logits, kv = DEC.prefill_with_prefix(
            self.params, torch.as_tensor(padded, device=self.device),
            prefix_kv, self.cfg)
        return logits, kv, n_real

    def _run_suffix(self, tokens: np.ndarray, n_cached: int, prefix_kv):
        """Shared paged/contiguous suffix prefill: bucket, run, slice."""
        logits, kv, n_real = self._suffix_forward(
            np.asarray(tokens[n_cached:], np.int64), n_cached, prefix_kv)
        self.n_prefills += 1
        return logits[0, n_real - 1], kv, n_real

    def _prefill_paged(self, uid, slot, tokens) -> PrefillResult:
        scfg = self.scfg
        total = min(len(tokens) + scfg.max_new_tokens + 1, scfg.max_len)
        seq = self.manager.create(uid, tokens, total,
                                  probe=scfg.prefix_caching)
        c = seq.n_cached
        bs = scfg.block_size
        table_row = torch.as_tensor(
            self.manager.table_array(uid, self.blocks_per_seq),
            device=self.device)
        prefix_kv = self.kv_store.gather(
            self.kv_store.pages, table_row[None, :c // bs]) if c else \
            self._empty_prefix()
        last_logits, kv, n_real = self._run_suffix(tokens, c, prefix_kv)
        self.kv_store.pages = self.kv_store.write_span(
            self.kv_store.pages, table_row, c, n_real,
            {n: kv[n][:, 0] for n in ("k", "v")})
        if scfg.prefix_caching:
            self.manager.commit(uid)
        first = int(self._sample(last_logits[None])[0])
        self._tokens[uid] = [first]
        self.slots[slot] = _Resident(uid)
        return PrefillResult(first, ExistingPrefix(c, tuple(
            seq.table[:c // bs])), len(tokens), n_real)

    def _prefill_contiguous(self, uid, slot, tokens) -> PrefillResult:
        plen = len(tokens)
        last_logits, kv, n_real = self._run_suffix(tokens, 0,
                                                   self._empty_prefix())
        for n in ("k", "v"):
            dst = self.caches["kv"][n]
            dst[:, slot, :plen] = kv[n][:, 0, :plen].to(dst.dtype)
        first = int(self._sample(last_logits[None])[0])
        self._tokens[uid] = [first]
        self.slots[slot] = _Resident(uid)
        return PrefillResult(first, ExistingPrefix(0, ()), plen, n_real)

    def _prefill_ssm(self, uid, slot, tokens) -> PrefillResult:
        """SSM prefill in block_size segments so recurrent state exists
        at every block boundary — those snapshots are what the prefix
        cache stores (the SSM analogue of cached KV rows)."""
        cfg, scfg = self.cfg, self.scfg
        bs = scfg.block_size
        toks = np.asarray(tokens, np.int64)
        plen = len(toks)
        k_max = (plen - 1) // bs
        c, state, hit_blocks = 0, None, ()
        hashes = chain_hashes(toks, bs)[:k_max]
        if scfg.paged and scfg.prefix_caching:
            _, matched = self.cache.match(toks, bs, max_blocks=k_max)
            if matched:
                bid = matched[-1]
                self.pool.retain(bid)
                state = {k: v[0] for k, v in
                         self.state_store.read_([bid]).items()}
                self.pool.release(bid)
                c, hit_blocks = len(matched) * bs, tuple(matched)
        if state is None:
            state = self._empty_state()

        def run(seg, state, pos):
            logits, caches = DEC.ssm_prefill(
                self.params, torch.as_tensor(seg[None], device=self.device),
                {"ssm": {k: v[:, None] for k, v in state.items()}}, cfg, pos)
            return logits, {k: v[:, 0] for k, v in caches["ssm"].items()}

        logits = None
        pos = c
        for i in range(c // bs, k_max):
            logits, state = run(toks[i * bs:(i + 1) * bs], state, pos)
            pos += bs
            if scfg.paged and scfg.prefix_caching and \
                    self.cache.get(hashes[i]) is None:
                self._commit_snapshot(hashes[i], state)
        if pos < plen:
            logits, state = run(toks[pos:plen], state, pos)
        n_real = plen - c
        self.n_prefills += 1
        if scfg.paged:
            self.state_store.write_(self._slot_bids[slot], state)
        else:
            for k, v in state.items():
                self.caches["ssm"][k][:, slot] = v
        first = int(self._sample(logits[0, -1][None])[0])
        self._tokens[uid] = [first]
        self.slots[slot] = _Resident(uid)
        return PrefillResult(first, ExistingPrefix(c, hit_blocks), plen,
                             n_real)

    def _commit_snapshot(self, h: str, state: dict) -> None:
        """Park one boundary snapshot in the cache; skip when the pool
        is under active pressure rather than failing the prefill."""
        try:
            bid = self.pool.allocate()
        except OutOfBlocks:
            return
        self.state_store.write_(bid, state)
        self.pool.set_hash(bid, h)
        self.cache.insert(h, bid)
        self.pool.release(bid)      # refcount 0 + hash -> parked (LRU)

    # -- decode path ---------------------------------------------------------

    def decode(self) -> torch.Tensor:
        """One decode step for every slot; returns the sampled next
        token per slot (junk rows for empty slots)."""
        pos = torch.as_tensor(self.pos, device=self.device)
        if not self.scfg.paged:
            logits, self.caches = DEC.decode_step(
                self.params, self.cur_tok, self.caches, pos, self.cfg)
        elif self.is_ssm:
            logits, self.state_store.pages = self._decode_ssm(
                self._slot_bids, pos)
        else:
            self._cow_for_decode()
            tables = torch.as_tensor(np.stack([
                self.manager.table_array(r.uid, self.blocks_per_seq)
                if r is not None else
                np.zeros((self.blocks_per_seq,), np.int32)
                for r in self.slots]), device=self.device)
            logits, self.kv_store.pages = self._decode_paged(tables, pos)
        self.n_decode_steps += 1
        nxt = self._sample(logits[:, -1])
        self.pos = self.pos + 1
        self.cur_tok = nxt[:, None]
        return nxt

    def _decode_ssm(self, bids, pos):
        """One decode step over the slots' working blocks ``bids``; the
        new states go back into the same blocks."""
        store = self.state_store
        bids = torch.as_tensor(bids, dtype=torch.int64, device=self.device)
        st = store.read(store.pages, bids)            # leaves (B, L, ...)
        caches = {"ssm": {k: v.transpose(0, 1) for k, v in st.items()}}
        logits, new = DEC.decode_step(self.params, self.cur_tok, caches, pos,
                                      self.cfg)
        per_seq = {k: v.transpose(0, 1) for k, v in new["ssm"].items()}
        return logits, store.write_batch(store.pages, bids, per_seq)

    def _decode_paged(self, tables, pos):
        store = self.kv_store
        kv = store.gather(store.pages, tables)
        logits, new = DEC.decode_step(self.params, self.cur_tok, {"kv": kv},
                                      pos, self.cfg)
        rows_idx = torch.arange(pos.shape[0], device=self.device)
        rows = {n: new["kv"][n][:, rows_idx, pos] for n in ("k", "v")}
        return logits, store.write_rows(store.pages, tables, pos, rows)

    def _cow_for_decode(self) -> None:
        """Make every live slot's write-target block exclusively owned
        (fires only after forks / prefix sharing into the write block)."""
        pairs = []
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            pair = self.manager.ensure_writable(r.uid, int(self.pos[i]))
            if pair is not None:
                pairs.append(pair)
        self.kv_store.apply_copies(pairs)

    # -- engine failure paths ------------------------------------------------

    def evict(self, uid: int) -> bool:
        """Release everything held for ``uid`` (engine failure paths:
        retry, bisect, quarantine, timeout).  Defensive against partial
        admission — a prefill that died mid-way may have registered the
        prompt or the sequence without ever occupying a slot."""
        found = False
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                self._release(i)
                found = True
                break
        self._tokens.pop(uid, None)
        self._prompts.pop(uid, None)
        if self.scfg.paged and not self.is_ssm and self.manager.has(uid):
            self.manager.free(uid)
        return found

    # -- serving-state checkpoint --------------------------------------------

    def snapshot(self) -> tuple[dict, dict]:
        """All mutable serving state as ``(arrays, meta)``, in the
        reference's layout.

        ``arrays`` holds the paged KV pages (the SSM state pages and the
        slots' working blocks under ``slot_bids``; or the contiguous
        caches),
        the slot positions and pending tokens (int32, as the reference
        keeps them) and, under ``rng_key``, the sampling generator's
        state as uint32 words; the trit codec's pages are packed bytes and
        go into the checkpoint as they are.  ``meta`` is JSON-safe host
        bookkeeping (slot residency, emitted tokens, prompts,
        pool/prefix/block-table state, the forward counts).  ``restore()``
        is the exact inverse: a fresh executor built from the same
        ``(params, cfg, scfg)`` continues bit-identically.
        """
        gen = self._gen.get_state().numpy()
        tree: dict = {"pos": self.pos.astype(np.int32),
                      "cur_tok": self.cur_tok.to(torch.int32),
                      "rng_key": gen.view(np.uint32).copy()}
        if self.scfg.paged and self.is_ssm:
            tree["pages"] = self.state_store.pages
            tree["slot_bids"] = np.asarray(self._slot_bids, np.int32)
        elif self.scfg.paged:
            tree["pages"] = self.kv_store.pages
        else:
            tree["caches"] = self.caches
        meta: dict = {
            "slots": [r.uid if r is not None else None
                      for r in self.slots],
            "tokens": {str(u): [int(t) for t in v]
                       for u, v in self._tokens.items()},
            "prompts": {str(u): np.asarray(v).tolist()
                        for u, v in self._prompts.items()},
            "prefill_tokens": int(self.prefill_tokens),
            "prefill_tokens_computed": int(self.prefill_tokens_computed),
            "pool": self.pool.state_dict(),
            "cache": self.cache.state_dict(),
            "prefills": int(self.n_prefills),
            "decode_steps": int(self.n_decode_steps),
        }
        if self.scfg.paged and not self.is_ssm:
            meta["manager"] = self.manager.state_dict()
        return tree, meta

    def restore(self, tree: dict, meta: dict) -> None:
        """Load a :meth:`snapshot` (the port's or the reference's) into
        this executor (same config).

        A reference snapshot's ``rng_key`` is a JAX key, not a generator
        state: the generator is then seeded from its two words (greedy
        decoding never draws from it).
        """
        dev = self.device
        self.pos = np.asarray(tree["pos"], np.int64).copy()
        self.cur_tok = torch.as_tensor(tree["cur_tok"]).to(
            device=dev, dtype=torch.int64).reshape(self.scfg.n_slots, 1)
        key = np.ascontiguousarray(np.asarray(tree["rng_key"], np.uint32))
        state = self._gen.get_state()
        if key.nbytes == state.numel():
            self._gen.set_state(torch.from_numpy(key.view(np.uint8).copy()))
        else:
            self._gen.manual_seed(int(key[0]) << 32 | int(key[-1]))
        if self.scfg.paged and self.is_ssm:
            self.state_store.pages = [torch.as_tensor(p).to(dev)
                                      for p in tree["pages"]]
            self._slot_bids = [int(b) for b in np.asarray(tree["slot_bids"])]
        elif self.scfg.paged:
            self.kv_store.pages = _on_device(tree["pages"], dev)
        else:
            self.caches = _on_device(tree["caches"], dev)
        self.slots = [None if u is None else _Resident(int(u))
                      for u in meta["slots"]]
        self._tokens = {int(u): [int(t) for t in v]
                        for u, v in meta["tokens"].items()}
        self._prompts = {int(u): np.asarray(v, np.int64)
                         for u, v in meta["prompts"].items()}
        self.prefill_tokens = int(meta["prefill_tokens"])
        self.prefill_tokens_computed = int(meta["prefill_tokens_computed"])
        self.n_prefills = int(meta.get("prefills", 0))
        self.n_decode_steps = int(meta.get("decode_steps", 0))
        self.pool.load_state(meta["pool"])
        self.cache.load_state(meta["cache"])
        if self.scfg.paged and not self.is_ssm:
            self.manager.load_state(meta["manager"])

    # -- fork ----------------------------------------------------------------

    def fork(self, uid: int, new_uid: int) -> int:
        """Copy-on-write fork of a resident sequence into a free slot.

        The child shares every block with the parent until either
        writes; divergence costs one block copy at the write point.
        """
        if self.is_ssm or not self.scfg.paged:
            raise NotImplementedError("fork requires paged KV mode")
        src = next(i for i, r in enumerate(self.slots)
                   if r is not None and r.uid == uid)
        dst = self.slots.index(None)
        self.manager.fork(uid, new_uid)
        self.slots[dst] = _Resident(new_uid)
        self._tokens[new_uid] = list(self._tokens[uid])
        self._prompts[new_uid] = self._prompts[uid]
        self.pos[dst] = self.pos[src]
        self.cur_tok[dst] = self.cur_tok[src]
        return dst

    # -- internals ----------------------------------------------------------

    def _admit(self, req) -> None:
        self.prefill(req.uid, req.value)

    def _release(self, slot: int) -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self.pos[slot] = 0                       # empty slots write to NULL
        self.cur_tok[slot, 0] = 0
        self._prompts.pop(req.uid, None)
        if self.scfg.paged and not self.is_ssm and \
                self.manager.has(req.uid):
            self.manager.free(req.uid)

    def _sample(self, lg: torch.Tensor) -> torch.Tensor:
        """lg (B, V_padded) -> sampled token ids (B,) int64."""
        lg = lg[:, : self.cfg.vocab]
        if self.scfg.temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.to(torch.float32) / self.scfg.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    @property
    def n_jit_variants(self) -> int:
        return len(self._prefill_shapes) + 1     # + the decode step


class _Resident:
    """Slot marker for sequences admitted via prefill() directly
    (engine requests carry .uid already; this mirrors that shape)."""

    __slots__ = ("uid",)

    def __init__(self, uid: int):
        self.uid = uid
