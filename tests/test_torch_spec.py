"""The port's speculative decoding (`repro_torch.serving.spec`) against
the JAX reference and against the port's own plain greedy decode.

Rejection sampling and the adaptive budget are host numpy in both
packages: held token for token, generator state included.  The draft
and verify workers run the reduced llama3.2-1B from the reference's
``init_params`` (carried across with `convert.llm_params_from_numpy`);
their logits rows agree within ``LOGIT_TOL`` and their tokens under the
top-2 margin rule (tests/test_torch_llm.py).

The end-to-end scenarios are tests/test_spec_decode.py's, held against
the port's plain `LLMExecutor` on the same weights.  A verify forward
(the suffix prefill's flash attention) and a decode step (cached decode
attention) sum in other orders, in the port as in the reference, so a
greedy speculative token may differ from the plain one only where the
plain decode's top-2 margin is at most 2 x LOGIT_TOL; the request is
not compared past that step.  A self-draft proposes the decode step's
argmax, so the verify may reject it only where the verify row holds the
proposal within 2 x LOGIT_TOL of its own argmax.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro.serving.blocks import BlockPool as JBlockPool
from repro.serving.spec import AdaptiveK as JAdaptiveK
from repro.serving.spec import DraftWorker as JDraftWorker
from repro.serving.spec import SpecConfig as JSpecConfig
from repro.serving.spec import VerifyWorker as JVerifyWorker
from repro.serving.spec import greedy_accept as jgreedy_accept
from repro.serving.spec import sample_accept as jsample_accept
from repro_torch import configs, convert
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import (BlockPool, CutieEngine, LLMExecutor,
                                 ServerConfig, SpecConfig, SpecExecutor)
from repro_torch.serving.spec import (AdaptiveK, DraftWorker, VerifyWorker,
                                      greedy_accept, sample_accept)

LOGIT_TOL = 2.0 ** -4
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(4)]
_KW = dict(n_slots=2, max_new_tokens=8, max_len=64, block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The decode loops run thousands of tiny ops: with torch's default
    intra-op threads they spin against the other test workers for the
    CPU; one thread per worker keeps the file short under ``-n 6``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# rejection sampling and adaptive k: the reference's numpy, token for token
# ---------------------------------------------------------------------------


def _rows(winners, vocab=8):
    """Logit rows whose argmax is `winners[i]`."""
    out = np.full((len(winners), vocab), -4.0)
    for i, w in enumerate(winners):
        out[i, w] = 4.0
    return out


def _accept_cases(seed: int, n: int = 60):
    """Seeded (proposals, draft rows, target rows): proposals are the
    target's argmax with a random run corrupted, so every accept length
    from 0 to k occurs."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k, vocab = int(rng.integers(1, 6)), int(rng.integers(4, 40))
        target = rng.standard_normal((k + 1, vocab)) * 2
        draft = target[:k] + rng.standard_normal((k, vocab))
        props = np.argmax(target[:k], axis=-1)
        cut = int(rng.integers(0, k + 1))
        props[cut:] = rng.integers(0, vocab, k - cut)
        yield props.astype(np.int32), draft, target


def test_greedy_accept_matches_reference():
    for props, _, target in _accept_cases(0):
        assert greedy_accept(props, target) == jgreedy_accept(props, target)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_accept_matches_reference(temperature):
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for props, draft, target in _accept_cases(1):
        got = sample_accept(props, draft, target, temperature, rng)
        want = jsample_accept(props, draft, target, temperature, jrng)
        assert got == want
        assert rng.bit_generator.state == jrng.bit_generator.state


def test_adaptive_k_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(5):
        kw = dict(k_max=int(rng.integers(1, 8)), window=int(rng.integers(
            2, 20)), min_samples=int(rng.integers(1, 10)))
        kw["k_min"] = int(rng.integers(1, kw["k_max"] + 1))
        ak, jak = AdaptiveK(SpecConfig(**kw)), JAdaptiveK(JSpecConfig(**kw))
        assert ak.stats() == jak.stats()
        for _ in range(40):
            p = int(rng.integers(1, kw["k_max"] + 1))
            a = int(rng.integers(0, p + 1))
            ak.observe(p, a)
            jak.observe(p, a)
            assert ak.k() == jak.k() and ak.stats() == jak.stats()


def test_greedy_accept_prefix_match():
    target = _rows([3, 5, 2, 7])
    assert greedy_accept(np.array([3, 5, 2]), target) == ([3, 5, 2, 7], 3)
    assert greedy_accept(np.array([3, 1, 2]), target) == ([3, 5], 1)
    assert greedy_accept(np.array([0, 5, 2]), target) == ([3], 0)


def test_sample_accept_agreement_and_residual():
    rng = np.random.default_rng(0)
    target = _rows([3, 5, 2, 7])
    emitted, j = sample_accept(np.array([3, 5, 2]), target[:3], target,
                               temperature=1.0, rng=rng)
    assert j == 3 and emitted[:3] == [3, 5, 2]
    draft = _rows([6, 5, 2])
    hits = 0
    for _ in range(50):
        emitted, j = sample_accept(np.array([6, 5, 2]), draft, target,
                                   temperature=1.0, rng=rng)
        if j == 0:
            hits += 1
            assert emitted[0] != 6
    assert hits > 40


def test_sample_accept_first_token_is_distributed_as_target():
    """Draws a draft token from q, runs the acceptance, and counts the
    first emitted token: its distribution is p whatever q is (chi-square
    at the 0.1% level, 7 degrees of freedom: 24.32)."""
    rng = np.random.default_rng(11)
    vocab, n = 8, 8000
    target = np.log(np.array([[.30, .20, .15, .10, .10, .08, .05, .02],
                              [1, 1, 1, 1, 1, 1, 1, 1.]]))
    draft = np.log(np.array([[.05, .05, .10, .10, .20, .20, .10, .20]]))
    q = np.exp(draft[0]) / np.exp(draft[0]).sum()
    counts = np.zeros(vocab)
    for _ in range(n):
        d = rng.choice(vocab, p=q)
        emitted, _ = sample_accept(np.array([d]), draft, target, 1.0, rng)
        counts[emitted[0]] += 1
    p = np.exp(target[0]) / np.exp(target[0]).sum()
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts / n)


def test_adaptive_k_tracks_acceptance():
    spec = SpecConfig(k_max=6, k_min=1, window=16, min_samples=4)
    ak = AdaptiveK(spec)
    assert ak.k() == 6
    for _ in range(8):
        ak.observe(6, 0)
    assert ak.k() == 1
    ak = AdaptiveK(spec)
    for _ in range(8):
        ak.observe(6, 6)
    assert ak.k() == 6
    ak = AdaptiveK(spec)
    for _ in range(8):
        ak.observe(4, 2)
    assert ak.k() == 1
    st = ak.stats()
    assert st["acceptance_rate"] == 0.5 and st["k_current"] == 1


def test_spec_config_validation():
    with pytest.raises(ValueError):
        SpecConfig(k_max=0)
    with pytest.raises(ValueError):
        SpecConfig(k_max=2, k_min=3)


# ---------------------------------------------------------------------------
# the draft and verify workers against the reference's
# ---------------------------------------------------------------------------


@functools.cache
def _reference(quant: str):
    """The reference's reduced 2-layer llama3.2-1B params, as numpy."""
    jcfg = jreduce(jconfigs.get("llama3_2_1b")).replace(n_layers=2,
                                                        quant=quant)
    return jax.tree.map(np.asarray, JTF.init_params(
        jcfg, jax.random.PRNGKey(0))), jcfg


@functools.cache
def _model(layers: int, quant: str = "none"):
    """Both packages' configs and params of the reference's model cut to
    its first ``layers`` layers."""
    jp, jcfg = _reference(quant)
    jp = dict(jp, layers=jax.tree.map(lambda a: a[:layers], jp["layers"]))
    jcfg = jcfg.replace(n_layers=layers)
    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(
        n_layers=layers, quant=quant)
    return jp, jcfg, convert.llm_params_from_numpy(jp, cfg,
                                                   device="cpu"), cfg


@functools.cache
def _random_draft(layers: int, quant: str):
    """A draft of the same shape drawn by the port from another seed."""
    from repro_torch.models import transformer as TF

    cfg = _model(layers, quant)[3]
    return TF.init_params(cfg, torch.Generator().manual_seed(1)), cfg


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _margin(row) -> float:
    top = np.sort(_f32(row))[-2:]
    return float(top[1] - top[0])


def _same_under_margin(got, want, want_rows):
    """Tokens equal up to the first difference, which must sit at a top-2
    margin of at most 2 x LOGIT_TOL in ``want_rows``; returns the number
    of positions compared."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            m = _margin(want_rows[j])
            assert m <= 2 * LOGIT_TOL, \
                f"token {j}: {a} vs {b} at margin {m}"
            return j
    return len(want)


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
def test_draft_propose_matches_reference(quant):
    jp, jcfg, p, cfg = _model(2, quant=quant)
    scfg, jscfg = ServerConfig(**_KW), JServerConfig(**_KW)
    d = DraftWorker(p, cfg, scfg, BlockPool(40))
    jd = JDraftWorker(jp, jcfg, jscfg, JBlockPool(40))
    prompt = _PROMPTS[1]
    for w in (d, jd):
        w.admit(0, 7, prompt, 4)
    toks = np.concatenate([prompt, [9]])
    for k, extra in ((4, ()), (3, (17, 33))):
        toks = np.concatenate([toks, np.asarray(extra, np.int64)])
        props, lgs = d.propose(0, 7, toks, k)
        jprops, jlgs = jd.propose(0, 7, toks, k)
        assert props.shape == (k,) and lgs.shape == (k, cfg.vocab)
        n = _same_under_margin(props, jprops, jlgs)
        err = np.abs(lgs[:n + 1] - _f32(jlgs[:n + 1])).max()
        assert err <= LOGIT_TOL, err
        for w in (d, jd):           # nothing accepted: catch up from here
            w.commit(0, len(toks))
    assert d.n_jit_variants == jd.n_jit_variants == 2     # buckets 32, 8
    assert d.n_steps == (len(prompt) + 1 + 3) + (2 + 2)


def _prefilled(ex, prompt):
    """``ex`` with ``prompt`` prefilled into slot 0 under uid 1."""
    return ex.prefill(1, prompt).first_token


def _decode_rows(ex, toks) -> np.ndarray:
    """The plain decode step's logits rows for slot 0 fed ``toks`` one by
    one (the port's `LLMExecutor.decode` without the sampling)."""
    rows = []
    for t in toks:
        ex.cur_tok[0, 0] = int(t)
        ex._cow_for_decode()
        tables = torch.as_tensor(ex.manager.table_array(
            1, ex.blocks_per_seq))[None]
        logits, ex.kv_store.pages = ex._decode_paged(
            tables, torch.as_tensor(ex.pos))
        rows.append(logits[0, -1, :ex.cfg.vocab].float().numpy())
        ex.pos = ex.pos + 1
    return np.stack(rows)


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
def test_verify_rows_match_reference_and_decode(quant):
    jp, jcfg, p, cfg = _model(2, quant=quant)
    kw = dict(_KW, n_slots=1)
    prompt = _PROMPTS[2]
    jex = JLLM(jp, jcfg, JServerConfig(**kw))
    cur = _prefilled(jex, prompt)
    ex = LLMExecutor(p, cfg, ServerConfig(**kw))
    _prefilled(ex, prompt)
    props = np.random.default_rng(3).integers(0, cfg.vocab, 3)
    rows = VerifyWorker(ex).verify_kv(0, 1, prompt, cur, props, len(prompt))
    jrows = JVerifyWorker(jex).verify_kv(0, 1, prompt, cur, props,
                                         len(prompt))
    assert rows.dtype == np.float32 and rows.shape == (4, cfg.vocab)
    assert np.abs(rows - jrows).max() <= LOGIT_TOL
    plain = LLMExecutor(p, cfg, ServerConfig(**kw))
    _prefilled(plain, prompt)
    dec = _decode_rows(plain, np.concatenate([[cur], props]))
    assert np.abs(rows - dec).max() <= LOGIT_TOL
    # the verify wrote the span under the live id: a second verify from
    # the next position sees the first one's rows
    more = VerifyWorker(ex).verify_kv(
        0, 1, np.concatenate([prompt, [cur]]), int(props[0]), props[1:],
        len(prompt) + 1)
    assert np.abs(more - rows[1:]).max() <= LOGIT_TOL


def test_verify_rolls_back_on_failure():
    """An exception between fork and adopt leaves the pool's counts,
    the block table and the live blocks' payloads exactly as they were
    (the shadow's copy-on-write blocks go back to the free list)."""
    _, _, p, cfg = _model(1)
    ex = LLMExecutor(p, cfg, ServerConfig(**dict(_KW, n_slots=1)))
    ex.prefill(1, _PROMPTS[0])
    seq = ex.manager.get(1)
    before = (ex.pool.n_active, ex.pool.n_free, ex.pool.n_cached,
              list(seq.table), seq.tokens.tolist(),
              {n: t[:, seq.table].clone()
               for n, t in ex.kv_store.pages.items()})

    def boom(*a, **kw):
        raise RuntimeError("injected")

    copies: list = []
    apply_copies = ex.kv_store.apply_copies
    ex.kv_store.apply_copies = lambda pairs: (copies.extend(pairs),
                                              apply_copies(pairs))
    ex._suffix_forward = boom
    with pytest.raises(RuntimeError, match="injected"):
        VerifyWorker(ex).verify_kv(0, 1, _PROMPTS[0], 5, np.array([1, 2]),
                                   len(_PROMPTS[0]))
    seq = ex.manager.get(1)
    after = (ex.pool.n_active, ex.pool.n_free, ex.pool.n_cached,
             list(seq.table), seq.tokens.tolist())
    assert after == before[:5]
    assert not ex.manager.has(-1)
    for n, t in before[5].items():
        assert torch.equal(ex.kv_store.pages[n][:, seq.table], t)
    assert copies          # the shadow's span blocks were copied on write


# ---------------------------------------------------------------------------
# SpecExecutor end-to-end against the port's plain greedy decode
# ---------------------------------------------------------------------------


def _record_margins(ex) -> dict:
    """Wrap a plain executor: per request uid, the logits row of every
    token it samples (prefill, then each decode step)."""
    rows: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        lg32 = lg[:, :ex.cfg.vocab].float().numpy()
        if admitting:
            rows.setdefault(admitting.pop(), []).append(lg32[0])
        else:
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(lg32[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


def _serve(ex, prompts=_PROMPTS, **submit_kw):
    eng = CutieEngine("fcfs")
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm", **submit_kw) for pr in prompts]
    out = eng.run()
    return [out[h.uid] for h in hs], [h.uid for h in hs], eng


@functools.cache
def _plain(layers, quant="none", max_new=8, kv_codec="raw"):
    _, _, p, cfg = _model(layers, quant=quant)
    ex = LLMExecutor(p, cfg, ServerConfig(paged=True, **dict(
        _KW, max_new_tokens=max_new, kv_codec=kv_codec)))
    rows = _record_margins(ex)
    out, uids, _ = _serve(ex)
    return out, [rows[u] for u in uids]


def _check_against_plain(out, plain):
    """Every request's tokens equal the plain serve's under the margin
    rule; returns the number of tokens compared."""
    want, rows = plain
    n = 0
    for g, w, r in zip(out, want, rows):
        assert len(g) == len(w)
        n += _same_under_margin(g, w, r)
    return n


def _record_verifies(ex) -> list:
    """Wrap a spec executor: (proposals, verify rows) of every verify."""
    seen: list = []
    propose, verify = ex.draft.propose, ex.verifier.verify_kv

    def propose_(slot, uid, tokens, k):
        props, lgs = propose(slot, uid, tokens, k)
        seen.append([props])
        return props, lgs

    def verify_(*a):
        rows = verify(*a)
        seen[-1].append(rows)
        return rows

    ex.draft.propose, ex.verifier.verify_kv = propose_, verify_
    return seen


def _self_draft_rejections_at_near_ties(seen) -> None:
    """A self-draft's proposal is the decode step's argmax: the verify
    may reject it only where its own row holds it within 2 x LOGIT_TOL of
    the row's argmax."""
    for props, rows in seen:
        for j, d in enumerate(props):
            if int(np.argmax(rows[j])) != int(d):
                gap = float(rows[j].max() - rows[j][d])
                assert gap <= 2 * LOGIT_TOL, (j, gap)
                break


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
@pytest.mark.parametrize("layers", [1, 2])
def test_spec_greedy_random_draft(layers, quant):
    """A draft drawn from another seed agrees with the target on almost
    nothing: every verify rejects early, and the output must still be
    the plain greedy trajectory under the margin rule."""
    _, _, p, cfg = _model(layers, quant=quant)
    dp, dcfg = _random_draft(layers, quant)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), dp, dcfg)
    out, _, _ = _serve(ex)
    assert _check_against_plain(out, _plain(layers, quant)) > 0
    spec = ex.extra_stats()["spec"]
    assert spec["verify_steps"] > 0
    assert spec["accepted_tokens"] < spec["proposed_tokens"]
    assert spec["k_current"] == SpecConfig().k_min


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
@pytest.mark.parametrize("layers", [1, 2])
def test_spec_greedy_self_draft(layers, quant):
    """The target as its own draft: every proposal is the target's decode
    argmax, the stress case for multi-token commits, draft catch-up and
    the stop rule."""
    _, _, p, cfg = _model(layers, quant=quant)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p, cfg)
    seen = _record_verifies(ex)
    out, _, eng = _serve(ex)
    assert _check_against_plain(out, _plain(layers, quant)) > 0
    _self_draft_rejections_at_near_ties(seen)
    spec = ex.extra_stats()["spec"]
    assert spec["acceptance_rate"] > 0.5
    assert spec["tokens_per_verify"] > 2.0
    assert eng.stats()["tokens_per_step"]["llm"] > 1.0


@pytest.mark.parametrize("quant", ["none", "ternary_packed"])
def test_spec_greedy_partial_draft(quant):
    """A layer-truncated draft sharing the target's weights accepts some
    proposals and rejects mid-run."""
    _, _, p, cfg = _model(2, quant=quant)
    dcfg = cfg.replace(n_layers=1)
    dp = dict(p, layers=p["layers"][:1])
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **dict(
        _KW, max_new_tokens=12)), dp, dcfg)
    out, _, _ = _serve(ex)
    assert _check_against_plain(out, _plain(2, quant, max_new=12)) > 0
    spec = ex.extra_stats()["spec"]
    assert 0 < spec["accepted_tokens"] < spec["proposed_tokens"]


def test_spec_k_zero_disables_speculation_per_request():
    """spec_k=0 runs the masked plain decode: the same batched step as
    `LLMExecutor`'s, so the tokens are equal outright."""
    _, _, p, cfg = _model(1)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p, cfg)
    out, _, eng = _serve(ex, spec_k=0)
    assert out == _plain(1)[0]
    spec = ex.extra_stats()["spec"]
    assert spec["verify_steps"] == 0 and spec["plain_steps"] > 0
    assert ex.extra_stats()["decode_steps"] == spec["plain_steps"]
    assert eng.stats()["tokens_per_step"]["llm"] <= 1.0


def test_spec_k_caps_proposals():
    _, _, p, cfg = _model(1)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p, cfg,
                      spec=SpecConfig(k_max=4))
    out, _, _ = _serve(ex, spec_k=2)
    assert _check_against_plain(out, _plain(1)) > 0
    spec = ex.extra_stats()["spec"]
    assert spec["verify_steps"] > 0
    assert spec["proposed_tokens"] <= 2 * spec["verify_steps"]


def test_spec_stats_ride_engine_stats_and_tags():
    _, _, p, cfg = _model(1)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p, cfg)
    seen = _record_verifies(ex)
    eng = CutieEngine("fcfs")
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm",
                     tag="interactive" if i % 2 else "batch")
          for i, pr in enumerate(_PROMPTS)]
    out = eng.run()
    assert _check_against_plain([out[h.uid] for h in hs], _plain(1)) > 0
    _self_draft_rejections_at_near_ties(seen)
    st = eng.stats()
    spec = st["paged_state"]["llm"]["spec"]
    assert spec["acceptance_rate"] > 0.5
    assert spec["draft_jit_variants"] >= 1
    assert spec["verify_jit_variants"] == 0
    assert st["tokens_per_step"]["llm"] > 1.0
    for tag in ("interactive", "batch"):
        assert st["by_tag"][tag]["tokens_per_step"] > 1.0
    snap = eng.obs.metrics.snapshot()
    assert snap["spec_proposed_tokens_total"]["series"][""] > 0
    assert snap["spec_accepted_per_step"]["kind"] == "histogram"
    names = {ev["name"] for ev in eng.trace_export()["traceEvents"]}
    assert {"spec_propose", "spec_verify", "spec_accept"} <= names


def test_spec_requires_paged_and_matching_vocab():
    _, _, p, cfg = _model(1)
    with pytest.raises(ValueError, match="paged"):
        SpecExecutor(p, cfg, ServerConfig(paged=False, **_KW), p, cfg)
    with pytest.raises(ValueError, match="vocab"):
        SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p,
                     cfg.replace(vocab=cfg.vocab + 1))
    # the reference's spec executor has no hybrid or encdec path: a
    # target or a draft of either family is refused up front
    for fam in ("hybrid", "encdec"):
        with pytest.raises(NotImplementedError, match="no serving executor"):
            SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p,
                         cfg.replace(family=fam))
        with pytest.raises(NotImplementedError, match="no serving executor"):
            SpecExecutor(p, cfg.replace(family=fam),
                         ServerConfig(paged=True, **_KW), p, cfg)
    ex = SpecExecutor(p, cfg, ServerConfig(paged=True, **_KW), p, cfg)
    with pytest.raises(NotImplementedError, match="snapshot"):
        ex.snapshot()
    # an attention target has no SSM state to verify over
    # (tests/test_torch_ssm.py serves SSM targets)
    with pytest.raises(ValueError, match="paged SSM target"):
        ex.verifier.verify_ssm(0, 1, 0, np.array([1]), 0)
    # the pool is widened for the draft's tables and the shadow forks
    assert ex.pool.num_blocks == 1 + 4 * 8 * 2 + 4
    assert ex.free_capacity() == 2


def test_spec_trit_kv_serve():
    """The paged KV rows ternarized 5 per byte (``kv_codec="trit"``) on
    the target and the draft.  The verify re-encodes the replayed rows
    ``committed[c:pos]`` from its own forward, which attended to the
    dequantized prefix (the reference's behaviour), so the pages hold
    other trits than the plain serve's and the tokens are not held to
    it past the prefill: the first tokens are equal, and every request
    completes."""
    _, _, p, cfg = _model(2, quant="ternary_packed")
    scfg = ServerConfig(paged=True, **dict(_KW, kv_codec="trit"))
    dp = dict(p, layers=p["layers"][:1])
    ex = SpecExecutor(p, cfg, scfg, dp, cfg.replace(n_layers=1))
    assert ex.kv_store.codec == ex.draft.store.codec == "trit"
    out, _, _ = _serve(ex)
    want, _ = _plain(2, "ternary_packed", kv_codec="trit")
    assert [t[0] for t in out] == [t[0] for t in want]
    assert [len(t) for t in out] == [len(t) for t in want]
    assert ex.extra_stats()["spec"]["verify_steps"] > 0
    assert ex.pool.n_active == 0


def test_verify_re_encodes_the_replayed_rows_trit():
    """After a verify with the trit codec, positions ``c .. pos+k`` of
    the sequence hold the encoding of the verify forward's own rows,
    the replayed committed rows included."""
    _, _, p, cfg = _model(2, quant="ternary_packed")
    ex = LLMExecutor(p, cfg, ServerConfig(**dict(_KW, n_slots=1,
                                                 kv_codec="trit")))
    prompt = _PROMPTS[3]
    cur = _prefilled(ex, prompt)
    kvs: list = []
    forward = ex._suffix_forward

    def forward_(*a):
        out = forward(*a)
        kvs.append(out[1])
        return out

    ex._suffix_forward = forward_
    pos, props = len(prompt), np.array([3, 4])
    VerifyWorker(ex).verify_kv(0, 1, prompt, cur, props, pos)
    c = (pos // 8) * 8
    n = pos + len(props) + 1 - c
    table = torch.as_tensor(ex.manager.table_array(1, ex.blocks_per_seq))
    got = ex.kv_store.gather(ex.kv_store.pages, table[None])
    for name in ("k", "v"):
        rows = kvs[0][name][:, 0, :n]
        enc = ex.kv_store._encode(rows)
        want = ex.kv_store._decode(enc[""], enc["_scale"])
        assert torch.equal(got[name][:, 0, c:c + n], want)


def test_spec_sampling_serves_full_requests():
    """temperature > 0: the draft samples from its own generator, the
    acceptance is distribution-preserving; every request completes."""
    _, _, p, cfg = _model(1)
    scfg = ServerConfig(paged=True, **dict(_KW, temperature=0.8))
    ex = SpecExecutor(p, cfg, scfg, p, cfg)
    out, _, _ = _serve(ex)
    assert [len(t) for t in out] == [_KW["max_new_tokens"]] * len(_PROMPTS)
    assert all(0 <= t < cfg.vocab for seq in out for t in seq)
    assert ex.pool.n_active == 0
