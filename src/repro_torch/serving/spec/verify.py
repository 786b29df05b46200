"""`VerifyWorker` — score k proposals in one batched target forward.

The target model already has a prefix-aware prefill
(:func:`repro_torch.models.decoding.prefill_with_prefix`) that runs a
token span against gathered cached KV; verification is that same path
pointed at the *decode frontier* instead of a prompt: gather the
block-aligned committed prefix, run ``replay + [pending] + proposals``
as one bucketed suffix, and read the target's distribution for every
proposal position plus the bonus position out of the returned logits
rows.

Writing the suffix KV back is where speculation could corrupt a
sequence: the span overlaps committed rows, and if the verify fails
midway (OOM, eviction pressure during COW) the sequence must stay
exactly as it was.  The worker therefore never writes into the live
sequence's blocks — it **forks a shadow** (`manager.fork` — pure
refcount sharing), COWs the span into the shadow, writes there, and
only on success frees the original and adopts the shadow under the
live id.  Rollback on any exception is `free(shadow)`: a refcount
release, never a payload restore.

SSM targets have no positional rows to page; instead the suffix runs
through :func:`~repro_torch.models.decoding.ssm_prefill_states`, which
keeps the state after *every* step, and commit picks the state matching
the accepted run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decoding as DEC
from repro_torch.serving.llm import _bucket

_VERIFY_FLOOR = 8      # pow2 bucket floor of the SSM verify length


class VerifyWorker:
    """Batched proposal scoring against a `LLMExecutor`'s paged state."""

    def __init__(self, executor):
        self.ex = executor
        self._buckets: set = set()      # SSM verify lengths seen

    # -- attention targets ---------------------------------------------------

    def verify_kv(self, slot: int, uid: int, committed: np.ndarray,
                  cur: int, proposals: np.ndarray, pos: int) -> np.ndarray:
        """One target forward over ``[pending] + proposals``.

        ``committed`` are the tokens whose KV rows are already paged in
        (``len(committed) == pos``); ``cur`` is the pending token at
        position ``pos``.  Returns ``(k+1, V)`` float32 target logits rows
        for positions ``pos+1 .. pos+k+1``.  The executor's paged KV ends
        up holding rows through ``pos+k`` under ``uid`` (garbage past the
        accept point is rewritten by the next verify and never attended:
        decode masks by position).
        """
        ex = self.ex
        bs = ex.scfg.block_size
        k = len(proposals)
        if len(committed) != pos:
            raise AssertionError(
                f"verify out of sync: {len(committed)} committed tokens "
                f"but slot position {pos}")
        c = (pos // bs) * bs
        suffix = np.concatenate([
            np.asarray(committed[c:], np.int64),
            np.asarray([cur], np.int64),
            np.asarray(proposals, np.int64)])
        shadow = -uid
        mgr, store = ex.manager, ex.kv_store
        mgr.fork(uid, shadow)
        try:
            pairs = mgr.ensure_span_writable(shadow, c, pos + k + 1)
            store.apply_copies(pairs)
            table_row = torch.as_tensor(
                mgr.table_array(shadow, ex.blocks_per_seq),
                device=ex.device)
            prefix_kv = store.gather(
                store.pages, table_row[None, :c // bs]) if c else \
                ex._empty_prefix()
            logits, kv, n_real = ex._suffix_forward(suffix, c, prefix_kv)
            store.pages = store.write_span(
                store.pages, table_row, c, n_real,
                {n: kv[n][:, 0] for n in ("k", "v")})
        except Exception:
            mgr.free(shadow)
            raise
        mgr.free(uid)
        mgr.adopt(shadow, uid)
        r = pos - c                         # row index of the pending token
        return logits[0, r:r + k + 1, :ex.cfg.vocab].float().cpu().numpy()

    # -- SSM targets ---------------------------------------------------------

    def verify_ssm(self, slot: int, uid: int, cur: int,
                   proposals: np.ndarray, pos: int) -> tuple:
        """Run ``[pending] + proposals`` keeping every per-step state.

        Returns ``((k+1, V) float32 target rows, states)``; pass
        ``states`` and the accept count to :meth:`commit_ssm` — the slot
        state is not touched until then, so rejection needs no rollback.
        The reference pads the scan to a power-of-two bucket; here only
        the ``k + 1`` real steps run (a padding step would cost a whole
        forward), and the bucket is counted.
        """
        ex = self.ex
        if not ex.is_ssm or not ex.scfg.paged:
            raise ValueError("verify_ssm needs a paged SSM target")
        toks = np.concatenate([[cur], np.asarray(proposals, np.int64)])
        self._buckets.add(("ssm", _bucket(len(toks), _VERIFY_FLOOR)))
        st = ex.state_store.read_([ex._slot_bids[slot]])
        caches = {"ssm": {k: v[0][:, None] for k, v in st.items()}}
        logits, states = DEC.ssm_prefill_states(
            ex.params, torch.as_tensor(toks[None], device=ex.device), caches,
            ex.cfg, pos)
        return logits[0, :, :ex.cfg.vocab].float().cpu().numpy(), states

    def commit_ssm(self, slot: int, states, j: int) -> None:
        """Adopt the state after the pending token + ``j`` accepted
        proposals (step index ``j``)."""
        ex = self.ex
        ex.state_store.write_(ex._slot_bids[slot],
                              {k: v[j][:, 0]
                               for k, v in states["ssm"].items()})

    @property
    def n_jit_variants(self) -> int:
        """The SSM verify lengths' buckets (attention targets share the
        prefill's bucket shapes)."""
        return len(self._buckets)
