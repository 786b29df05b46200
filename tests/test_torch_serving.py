"""The port's serving plane: block pool, prefix cache, sequence manager,
KV pages, and the engine's scheduling, cancellation and routing.

Mirrors the reference's allocator and engine cases
(tests/test_paged_state.py, tests/test_serving_engine.py); where those
serve a CNN program, these serve a stub `Executor` (the port's
`ProgramExecutor` has its own suite, tests/test_torch_cnn_serving.py).
The KV page layout
and the trit KV codec are held against the reference's
`repro.serving.blocks` on the same rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import blocks as jblocks
from repro_torch.serving import (CutieEngine, DeadlineScheduler,
                                 ExecutionReport, Executor, FaultPolicy,
                                 ModelRegistry, RequestCancelled,
                                 RequestStatus, get_scheduler)
from repro_torch.serving.blocks import (NULL_BLOCK, BlockPool, KVPagedStore,
                                        OutOfBlocks, PagedSequenceManager,
                                        PrefixCache, chain_hashes,
                                        pack_last_axis, unpack_last_axis)

# ---------------------------------------------------------------------------
# BlockPool: allocate / retain / release / evict / COW
# ---------------------------------------------------------------------------


def test_pool_lifecycle_and_null_block():
    pool = BlockPool(5)
    assert pool.capacity == 4 and pool.n_free == 4
    a, b = pool.allocate(), pool.allocate()
    assert NULL_BLOCK not in (a, b)
    assert pool.n_active == 2
    with pytest.raises(ValueError):
        pool.retain(NULL_BLOCK)
    pool.release(a)
    assert pool.n_free == 3                  # anonymous block -> free list
    with pytest.raises(ValueError):
        pool.release(a)                      # double release


def test_pool_parks_hashed_blocks_and_evicts_lru():
    dropped = []
    pool = BlockPool(4, on_evict=lambda bid, h: dropped.append((bid, h)))
    x, y, z = pool.allocate(), pool.allocate(), pool.allocate()
    pool.set_hash(x, "hx")
    pool.set_hash(y, "hy")
    pool.release(x)                          # parks (LRU-oldest)
    pool.release(y)                          # parks
    pool.release(z)                          # anonymous -> free
    assert pool.n_cached == 2 and pool.n_free == 1
    got = [pool.allocate(), pool.allocate()]  # free first, then evict x
    assert pool.evictions == 1 and dropped == [(x, "hx")]
    assert x in got
    pool.allocate()                          # evicts y
    with pytest.raises(OutOfBlocks):
        pool.allocate()


def test_pool_retain_cow_and_stale_ids():
    pool = BlockPool(5)
    a = pool.allocate()
    pool.set_hash(a, "h")
    pool.release(a)
    assert pool.n_cached == 1
    pool.retain(a)                           # prefix hit on a parked block
    assert pool.n_cached == 0 and pool.refcount(a) == 1
    b = pool.allocate()
    assert pool.writable(b) == (b, None)     # exclusive: in-place ok
    pool.retain(b)                           # now shared (ref 2)
    new, pair = pool.writable(b)
    assert new != b and pair == (b, new)
    nb, pairb = pool.writable(a)             # hash-registered: shared
    assert nb != a and pairb == (a, nb)
    c = pool.allocate()
    pool.release(c)                          # anonymous -> free list
    with pytest.raises(ValueError, match="stale"):
        pool.retain(c)


# ---------------------------------------------------------------------------
# PrefixCache and PagedSequenceManager
# ---------------------------------------------------------------------------


def test_chain_hashes_match_the_reference():
    toks = np.arange(12) % 7
    assert chain_hashes(toks, 4) == jblocks.chain_hashes(toks, 4)
    other = np.concatenate([np.arange(4) + 50, np.arange(4, 8)])
    assert chain_hashes(other, 4)[1] != chain_hashes(np.arange(8), 4)[1]


def test_prefix_cache_match_clamp_and_hit_rate():
    cache = PrefixCache()
    toks = np.arange(12)
    hs = chain_hashes(toks, 4)
    for i, h in enumerate(hs):
        cache.insert(h, i + 1)
    hs_m, bids = cache.match(toks, 4, max_blocks=2)   # clamped
    assert bids == [1, 2] and hs_m == hs[:2]
    assert cache.hit_rate == 8 / 12
    cache.drop(99, hs[0])                    # stale bid: no-op
    assert cache.get(hs[0]) == 1
    cache.drop(1, hs[0])
    assert cache.get(hs[0]) is None


def _mgr(num_blocks=12, bs=4):
    pool = BlockPool(num_blocks)
    cache = PrefixCache()
    pool.on_evict = cache.drop
    return PagedSequenceManager(pool, cache, bs)


def test_manager_prefix_reuse_commit_and_probe():
    m = _mgr()
    toks = np.arange(10)
    s1 = m.create(1, toks, total_len=12)
    assert s1.n_cached == 0
    m.commit(1)
    s2 = m.create(2, toks, total_len=12)
    assert s2.n_cached == 8 and s2.table[:2] == s1.table[:2]
    assert s2.table[2] != s1.table[2]        # private tail
    m.commit(2)                              # duplicate chain: no steal
    assert m.cache.get(chain_hashes(toks, 4)[0]) == s1.table[0]
    s3 = m.create(3, np.arange(8), total_len=12)
    assert s3.n_cached == 4                  # last prompt token recomputed
    s4 = m.create(4, toks, 12, probe=False)
    assert s4.n_cached == 0


def test_manager_fork_cow_eviction_and_collisions():
    m = _mgr()
    toks = np.arange(10)
    m.create(1, toks, 12)
    m.commit(1)
    with pytest.raises(ValueError, match="already exists"):
        m.create(1, toks, 12)
    m.fork(1, 2)
    assert m.get(2).table == m.get(1).table
    assert m.ensure_writable(2, 9) is not None
    assert m.get(2).table[2] != m.get(1).table[2]
    assert m.ensure_writable(1, 9) is None
    m.free(2)
    m.free(1)
    assert m.pool.n_active == 0 and m.pool.n_cached == 2
    # pressure evicts the parked prefix; a recommit hits again
    m2 = _mgr(num_blocks=7, bs=4)
    m2.create(1, toks, 12)
    m2.commit(1)
    m2.free(1)
    m2.create(2, np.arange(18) + 90, 20)
    assert m2.pool.evictions >= 1
    m2.free(2)
    s3 = m2.create(3, toks, 12)
    assert s3.n_cached < 8
    m2.commit(3)
    m2.free(3)
    assert m2.create(4, toks, 12).n_cached == 8


# ---------------------------------------------------------------------------
# KV pages: layout and the trit codec, against the reference
# ---------------------------------------------------------------------------


def test_trit_pack_roundtrip_matches_reference_bytes():
    rng = np.random.default_rng(0)
    t = rng.integers(-1, 2, size=(6, 37)).astype(np.int8)
    packed = pack_last_axis(torch.as_tensor(t))
    assert packed.shape == (6, 8)
    assert np.array_equal(packed.numpy(),
                          np.asarray(jblocks.pack_last_axis(jnp.asarray(t))))
    assert np.array_equal(unpack_last_axis(packed, 37).numpy(), t)


@pytest.mark.parametrize("codec", ["raw", "trit"])
def test_kv_store_gather_scatter_matches_reference(codec):
    rng = np.random.default_rng(1)
    args = (2, 6, 4, 2, 8)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    pos = np.array([3, 6], np.int32)
    rows = {n: rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
            for n in ("k", "v")}
    js = jblocks.KVPagedStore(*args, codec_name=codec)
    js.pages = js.write_rows(js.pages, jnp.asarray(tables), jnp.asarray(pos),
                             {n: jnp.asarray(r, jnp.bfloat16)
                              for n, r in rows.items()})
    want = js.gather(js.pages, jnp.asarray(tables))
    st = KVPagedStore(*args, codec_name=codec, device="cpu")
    st.pages = st.write_rows(st.pages, torch.as_tensor(tables),
                             torch.as_tensor(pos),
                             {n: torch.as_tensor(r).to(torch.bfloat16)
                              for n, r in rows.items()})
    got = st.gather(st.pages, torch.as_tensor(tables))
    assert got["k"].shape == (2, 2, 8, 2, 8)
    for n in ("k", "v"):
        assert np.array_equal(got[n].float().numpy(),
                              np.asarray(want[n], np.float32))
    assert st.bytes_per_block() == js.bytes_per_block()


def test_trit_kv_store_ties_zeros_and_signed_zeros_match_reference():
    """A prefill span of bf16 rows with exact ties at half the row's max,
    an all-zero row, a row of -0.0 and -0.0 among live values, written
    and gathered through the trit store's codec forms: pages, scales and
    gathered bf16 bits equal the reference store's."""
    rng = np.random.default_rng(3)
    l, s, hk, dh = 2, 6, 2, 13
    rows = {}
    for name in ("k", "v"):
        x = rng.standard_normal((l, s, hk, dh)).astype(np.float32)
        x[:, 0, 0] = 0.0
        x[:, 1, 0] = -0.0
        x[:, 2, 1, ::2] = -0.0
        x[:, 3, :, 0] = -4.0                 # max |x| = 4: ties at +-2
        x[:, 3, :, 1:] = np.clip(x[:, 3, :, 1:], -4.0, 4.0)
        x[:, 3, :, 2::3] = 2.0
        x[:, 3, :, 3::3] = -2.0
        rows[name] = np.asarray(torch.as_tensor(x).to(torch.bfloat16)
                                .float())
    table = np.array([1, 2], np.int32)
    js = jblocks.KVPagedStore(l, 4, 4, hk, dh, codec_name="trit")
    js.pages = js.write_span(js.pages, jnp.asarray(table), 1, 5,
                             {n: jnp.asarray(r, jnp.bfloat16)
                              for n, r in rows.items()})
    want = js.gather(js.pages, jnp.asarray(table[None]))
    st = KVPagedStore(l, 4, 4, hk, dh, codec_name="trit", device="cpu")
    st.pages = st.write_span(st.pages, torch.as_tensor(table), 1, 5,
                             {n: torch.as_tensor(r).to(torch.bfloat16)
                              for n, r in rows.items()})
    got = st.gather(st.pages, torch.as_tensor(table[None]))
    for n in st.pages:
        assert np.array_equal(st.pages[n].numpy(), np.asarray(js.pages[n]))
    for n in ("k", "v"):
        assert np.array_equal(got[n].view(torch.int16).numpy(),
                              np.asarray(want[n]).view(np.int16))


def test_kv_store_write_span_routes_padding_to_null_block():
    st = KVPagedStore(1, 4, 4, 1, 4, device="cpu")
    table = torch.as_tensor([1, 2])
    kv = {n: torch.ones((1, 8, 1, 4), dtype=torch.bfloat16)
          for n in ("k", "v")}
    st.pages = st.write_span(st.pages, table, 2, 3, kv)   # 3 real rows
    real = st.gather(st.pages, table[None])["k"][0, 0, :, 0, 0].float()
    assert (real[2:5] == 1.0).all()
    assert (real[:2] == 0).all() and (real[5:] == 0).all()


# ---------------------------------------------------------------------------
# the engine over a stub executor
# ---------------------------------------------------------------------------


class _Stub(Executor):
    """One-shot executor: result = f(value), up to ``cap`` per batch."""

    def __init__(self, fn=lambda v: v * 2, cap: int = 1):
        self.fn, self.cap = fn, cap
        self.batches: list = []

    def free_capacity(self) -> int:
        return self.cap

    def execute(self, requests) -> ExecutionReport:
        self.batches.append([r.uid for r in requests])
        return ExecutionReport([(r.uid, self.fn(r.value)) for r in requests],
                               len(requests), self.cap)


def _engine(scheduler="fcfs", cap=1, **kw):
    eng = CutieEngine(scheduler, **kw)
    eng.register("m", _Stub(cap=cap))
    return eng


@pytest.mark.parametrize("scheduler,kw,order", [
    ("fcfs", [{}, {}, {}], [0, 1, 2]),
    ("priority", [{"priority": 0}, {"priority": 5}, {"priority": 1}],
     [1, 2, 0]),
    ("deadline", [{"deadline": 10.0}, {}, {"deadline": 0.1}], [2, 0, 1]),
])
def test_scheduler_completion_order(scheduler, kw, order):
    eng = _engine(scheduler)
    hs = [eng.submit(i, model="m", **k) for i, k in enumerate(kw)]
    assert [h.uid for h in eng.stream()] == [hs[i].uid for i in order]
    if scheduler == "deadline":
        assert isinstance(eng.scheduler, DeadlineScheduler)


def test_batch_formation_respects_policy():
    eng = _engine("priority", cap=2)
    hs = [eng.submit(i, model="m", priority=p)
          for i, p in enumerate((0, 3, 1, 2))]
    assert eng.step()
    done = {h.uid for h in hs if h.status is RequestStatus.DONE}
    assert done == {hs[1].uid, hs[3].uid}    # the two highest priorities
    with pytest.raises(ValueError, match="unknown scheduler"):
        get_scheduler("shortest-job-first")


def test_cancellation_before_and_after_admission():
    eng = _engine()
    keep = eng.submit(1, model="m")
    drop = eng.submit(2, model="m")
    assert drop.cancel() is True
    assert drop.status is RequestStatus.CANCELLED
    with pytest.raises(RequestCancelled):
        drop.result()
    assert eng.run() == {keep.uid: 2}
    assert keep.cancel() is False            # after completion: no-op
    assert drop.cancel() is False            # already cancelled
    assert eng.cancel(99_999) is False       # unknown uid
    assert eng.stats()["n_cancelled"] == 1


def test_routing_hot_swap_and_registry():
    eng = CutieEngine("fcfs")
    eng.register("a", _Stub(lambda v: v + 1))
    eng.register("b", _Stub(lambda v: v * 10))
    ha, hb = eng.submit(3, model="a"), eng.submit(3, model="b")
    eng.run()
    assert (ha.request.result, hb.request.result) == (4, 30)
    with pytest.raises(ValueError, match="model= is required"):
        eng.submit(3)
    queued = eng.submit(5, model="a")        # queued against the old one
    eng.register("a", _Stub(lambda v: -v))   # hot-swap
    assert queued.result() == -5
    reg = ModelRegistry()
    with pytest.raises(TypeError, match="cannot register"):
        reg.register("cnn", object())
    with pytest.raises(ValueError, match="unknown model"):
        reg["nope"]


def test_failed_batch_retries_then_fails_at_the_handle():
    eng = CutieEngine("fcfs", policy=FaultPolicy(backoff_base=0.0,
                                                 quarantine_after=None))
    eng.register("m", _Stub(lambda v: 1 / 0))
    h = eng.submit(1, model="m")
    eng.step()                               # does not raise
    with pytest.raises(ZeroDivisionError):
        h.result()
    assert h.status is RequestStatus.FAILED
    assert h.request.retries == eng.policy.max_retries + 1
    assert eng.stats()["faults"]["n_retries"] == eng.policy.max_retries
