"""The port's ssm family (mamba2) against the JAX reference, on the CPU
at the reduced mamba2-780m config (`reduce_for_smoke`: 2 layers,
d_model 64, state 16, head dim 16, chunk 16, ``ternary_packed``): the
SSD scan, the mixer's forward and decode step, the token-by-token
prefill, `StatePagedStore`, `LLMExecutor` over SSM state slots and the
speculative serve with SSM targets and drafts.

Parameters are the reference's ``init_params`` carried across with
`repro_torch.convert.llm_params_from_numpy`; inputs come from numpy
seeds.

Tolerances, stated once:

* the SSD scan on the same inputs (f32): within ``F32_RTOL`` of the
  largest |value| (f32 sums in other orders);
* the SSD scan's and one mixer's VJPs in float32 throughout (the mixer's
  params cast to f32 under ``quant="none"``): every cotangent within
  ``VJP_F32_RTOL`` of its largest |value| against ``jax.vjp``;
* a mixer's f32 state, whose inputs are bf16 projections that may land
  a bf16 ulp (2**-8 relative) apart: within ``STATE_RTOL`` of its
  largest |value|;
* bf16 outputs of a mixer or of the model (logits): within ``LOGIT_TOL``
  (tests/test_torch_llm.py's rule: bf16 rounded at the same places, f32
  sums in other orders);
* `ssm_prefill_states` against sequential decode steps, a state page's
  round trip, and a trit snapshot's packed bytes: bit for bit;
* the chunked forward's last logits against the token-by-token prefill
  (two algorithms, each rounding its activations to bf16): the
  reference's own ``test_decode_matches_prefill`` rule, correlation above
  0.99 and every logit within 0.3;
* engine-served greedy tokens: equal, except where the reference's own
  top-2 logit margin at that step is within 2 x ``LOGIT_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import decoding as JDEC
from repro.models import mamba2 as JM
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import CutieEngine as JEngine
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro.serving import SpecExecutor as JSpec
from repro.serving.blocks import StatePagedStore as JStateStore
from repro_torch import configs, convert
from repro_torch.models import decoding as DEC
from repro_torch.models import mamba2
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import (CutieEngine, LLMExecutor, ServerConfig,
                                 SpecExecutor, restore_serving_state,
                                 save_serving_state)
from repro_torch.serving.blocks import StatePagedStore

LOGIT_TOL = 2.0 ** -4
F32_RTOL = 1e-5
STATE_RTOL = 2.0 ** -6
VJP_F32_RTOL = 1e-4
BLOCK = 8
ARCH = "mamba2_780m"
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(4)]
_KW = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=BLOCK)

_MODELS: dict = {}


def _model(layers=2, seed=0):
    """Both packages' reduced configs and params (the reference's init)."""
    if (layers, seed) not in _MODELS:
        kw = dict(quant="ternary_packed", n_layers=layers)
        jcfg = jreduce(jconfigs.get(ARCH)).replace(**kw)
        cfg = reduce_for_smoke(configs.get(ARCH)).replace(**kw)
        # jitted: one compile instead of one per eager op
        jp = jax.jit(JTF.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(seed))
        p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
        _MODELS[layers, seed] = (jp, jcfg, p, cfg)
    return _MODELS[layers, seed]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= tol, f"max |err| {err} > {tol}"


def _close_rel(got, want, rtol=F32_RTOL):
    _close(got, want, rtol * float(np.abs(_f32(want)).max()))


def _both(a, dtype):
    t = torch.as_tensor(np.asarray(a, np.float32))
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)
    return t, jnp.asarray(a, jnp.float32)


def _mixer(jp, layer=0):
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["mixer"])
    return jl, convert._tree(jax.tree.map(np.asarray, jl), "cpu")


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def test_config_is_the_reference_config():
    assert dataclasses.asdict(configs.get("mamba2-780m")) == \
        dataclasses.asdict(jconfigs.get(ARCH))


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "initial"])
def test_ssd_chunked_matches_reference(initial):
    rng = np.random.default_rng(1)
    b, l, h, pd, g, n = 2, 32, 4, 16, 1, 16
    x, jx = _both(rng.standard_normal((b, l, h, pd)), "bfloat16")
    dt, jdt = _both(np.log1p(np.exp(rng.standard_normal((b, l, h)))),
                    "float32")
    al, jal = _both(np.log(np.linspace(1.0, 16.0, h)), "float32")
    bm, jbm = _both(rng.standard_normal((b, l, g, n)), "bfloat16")
    cm, jcm = _both(rng.standard_normal((b, l, g, n)), "bfloat16")
    s0, js0 = (_both(rng.standard_normal((b, h, pd, n)), "float32")
               if initial else (None, None))
    y, st = mamba2.ssd_chunked(x, dt, al, bm, cm, chunk=16, initial_state=s0)
    jy, jst = JM.ssd_chunked(jx, jdt, jal, jbm, jcm, chunk=16,
                             initial_state=js0)
    assert y.dtype == st.dtype == torch.float32
    _close_rel(y, jy)
    _close_rel(st, jst)


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(_f32(got) - want).max() / np.abs(want).max())


def test_ssd_chunked_vjp_f32_matches_reference():
    # the SSD backward against jax.vjp, in float32 throughout: a fault in
    # the port's backward shows here, where bf16 rounding (ROADMAP.md §3)
    # cannot hide it; every cotangent within VJP_F32_RTOL of its largest
    # |value| (measured at most 3.0e-6, the dt cotangent)
    rng = np.random.default_rng(5)
    b, l, h, pd, g, n = 2, 32, 4, 16, 1, 16
    arrays = [rng.standard_normal((b, l, h, pd)),
              np.log1p(np.exp(rng.standard_normal((b, l, h)))),
              np.log(np.linspace(1.0, 16.0, h)),
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, l, g, n)),
              rng.standard_normal((b, h, pd, n))]
    gy = rng.standard_normal((b, l, h, pd)).astype(np.float32)
    gs = rng.standard_normal((b, h, pd, n)).astype(np.float32)
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in arrays]
    y, st = mamba2.ssd_chunked(*ts[:5], chunk=16, initial_state=ts[5])
    ((y * torch.from_numpy(gy)).sum()
     + (st * torch.from_numpy(gs)).sum()).backward()

    def jfn(x, dt, al, bm, cm, s0):
        return JM.ssd_chunked(x, dt, al, bm, cm, chunk=16, initial_state=s0)

    (jy, jst), vjp = jax.vjp(jfn, *[jnp.asarray(a, jnp.float32)
                                    for a in arrays])
    _close_rel(y.detach(), jy)
    _close_rel(st.detach(), jst)
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    for name, t, w in zip(("x", "dt", "a_log", "B", "C", "state"), ts, want):
        assert _rel_err(t.grad, w) <= VJP_F32_RTOL, name


def test_mixer_apply_vjp_f32_matches_reference():
    # one reduced mamba2 mixer, params cast to float32 (quant="none"), its
    # apply's VJP against jax.vjp: every parameter leaf and the input
    # within VJP_F32_RTOL of its largest |value| (measured at most 4.2e-6)
    kw = dict(quant="none", n_layers=1)
    jcfg = jreduce(jconfigs.get(ARCH)).replace(**kw)
    cfg = reduce_for_smoke(configs.get(ARCH)).replace(**kw)
    jp = jax.jit(JTF.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(3))
    jl = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                      jp["layers"]["mixer"])
    lp = convert._tree(jl, "cpu")
    leaves = []
    for path, t in _leaf_items(lp):
        t.requires_grad_(True)
        leaves.append((path, t))
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    tu = torch.tensor(u, requires_grad=True)
    out = mamba2.apply(lp, tu, cfg)
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    jout, vjp = jax.vjp(lambda p, x: JM.apply(p, x, jcfg),
                        jax.tree.map(jnp.asarray, jl), jnp.asarray(u))
    assert out.dtype == torch.float32
    _close_rel(out.detach(), jout)
    jg, ju = vjp(jnp.asarray(g))
    assert _rel_err(tu.grad, ju) <= VJP_F32_RTOL, "input"
    for path, t in leaves:
        w = jg
        for k in path:
            w = w[k]
        assert _rel_err(t.grad, w) <= VJP_F32_RTOL, "/".join(path)


def _leaf_items(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, path + (k,))
        else:
            yield path + (k,), v


def test_mixer_apply_and_decode_step_match_reference():
    jp, jcfg, p, cfg = _model()
    jl, lp = _mixer(jp)
    rng = np.random.default_rng(2)
    u, ju = _both(rng.standard_normal((2, 16, cfg.d_model)), "bfloat16")
    out, st = mamba2.apply(lp, u, cfg, return_state=True)
    jout, jst = JM.apply(jl, ju, jcfg, return_state=True)
    _close(out, jout, LOGIT_TOL)
    _close_rel(st, jst, STATE_RTOL)
    state = mamba2.init_state(cfg, 2)
    jstate = JM.init_state(jcfg, 2)
    for key in state:
        assert state[key].dtype == {"ssm": torch.float32}.get(
            key, torch.bfloat16)
        assert tuple(state[key].shape) == jstate[key].shape
    state = {k: _both(rng.standard_normal(v.shape), str(v.dtype))
             for k, v in jstate.items()}
    y, new = mamba2.decode_step(lp, u[:, :1], cfg,
                                {k: v[0] for k, v in state.items()})
    jy, jnew = JM.decode_step(jl, ju[:, :1], jcfg,
                              {k: v[1] for k, v in state.items()})
    _close(y, jy, LOGIT_TOL)
    _close_rel(new["ssm"], jnew["ssm"], STATE_RTOL)
    for key in ("conv_x", "conv_b", "conv_c"):
        assert new[key].dtype == torch.bfloat16
        _close(new[key], jnew[key], LOGIT_TOL)


def test_ssm_prefill_states_equal_sequential_decode_and_reference():
    jp, jcfg, p, cfg = _model()
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    caches = DEC.init_caches(cfg, 2, 16)
    logits, states = DEC.ssm_prefill_states(p, torch.as_tensor(toks),
                                            caches, cfg)
    c = caches
    for i in range(toks.shape[1]):
        lg, c = DEC.decode_step(p, torch.as_tensor(toks[:, i:i + 1]), c, i,
                                cfg)
        assert torch.equal(lg[:, 0], logits[:, i])
        for k, v in c["ssm"].items():
            assert torch.equal(v, states["ssm"][k][i])
    jlogits, jc = JDEC.ssm_prefill(jp, jnp.asarray(toks),
                                   JDEC.init_caches(jcfg, 2, 16), jcfg)
    _close(logits, jlogits, LOGIT_TOL)
    _close_rel(c["ssm"]["ssm"], jc["ssm"]["ssm"], STATE_RTOL)
    flog, fc = DEC.ssm_prefill(p, torch.as_tensor(toks), caches, cfg)
    assert torch.equal(flog, logits) and all(
        torch.equal(fc["ssm"][k], c["ssm"][k]) for k in c["ssm"])


def test_forward_logits_and_loss_match_reference_and_prefill():
    jp, jcfg, p, cfg = _model()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 16))
    full = TF.forward_logits(p, {"tokens": torch.as_tensor(toks)}, cfg)
    jfull = JTF.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(full, jfull, LOGIT_TOL)
    step, _ = DEC.ssm_prefill(p, torch.as_tensor(toks),
                              DEC.init_caches(cfg, 1, 16), cfg)
    a, f = _f32(step[0, -1]), _f32(full[0, -1])
    assert np.corrcoef(a, f)[0, 1] > 0.99
    np.testing.assert_allclose(a, f, rtol=0.3, atol=0.3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, _ = JTF.forward_loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tloss, tm = TF.forward_loss(
        p, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    assert abs(float(tloss) - float(jloss)) <= LOGIT_TOL
    assert float(tm["lb_loss"]) == float(tm["z_loss"]) == 0.0


# ---------------------------------------------------------------------------
# StatePagedStore
# ---------------------------------------------------------------------------


def test_state_store_trit_snapshots_are_exact():
    """The reference's case (int8 trit leaves), then trit-valued leaves of
    the serve's state shapes (bf16 conv buffers, f32 state): the round
    trip is exact and the packed pages are the reference's bytes."""
    rng = np.random.default_rng(2)
    state = {"a": rng.integers(-1, 2, (2, 9)).astype(np.int8),
             "b": rng.integers(-1, 2, (5,)).astype(np.int8)}
    _, _, _, cfg = _model()
    one = DEC.init_caches(cfg, 1, 16)["ssm"]
    ssm_state = {k: rng.integers(-1, 2, v[:, 0].shape).astype(np.float32)
                 for k, v in one.items()}
    for host, dtypes in ((state, {}), (ssm_state, {
            k: v.dtype for k, v in one.items()})):
        tmpl = {k: torch.as_tensor(v).to(dtypes.get(k, torch.int8))
                for k, v in host.items()}
        st = StatePagedStore(4, {k: torch.zeros_like(v)
                                 for k, v in tmpl.items()},
                             codec_name="trit")
        jst = JStateStore(4, {k: jnp.zeros(v.shape, str(v.dtype).split(
            ".")[-1]) for k, v in tmpl.items()}, codec_name="trit")
        st.write_(2, tmpl)
        jst.write_(2, {k: jnp.asarray(v, str(tmpl[k].dtype).split(".")[-1])
                       for k, v in host.items()})
        back = st.read_([2])
        for k, v in tmpl.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k][0], v)
        assert st.bytes_per_block() == jst.bytes_per_block()
        for mine, theirs in zip(st.pages, jst.pages, strict=True):
            assert np.array_equal(mine.numpy(), np.asarray(theirs))
    assert st.pages[0].shape[-1] == -(-ssm_state["conv_b"].size // 5)


def test_state_store_raw_round_trip_and_copies():
    _, _, _, cfg = _model()
    one = DEC.init_caches(cfg, 1, 16)["ssm"]
    tmpl = {k: v[:, 0] for k, v in one.items()}
    st = StatePagedStore(5, tmpl)
    rng = np.random.default_rng(5)
    a = {k: torch.as_tensor(rng.standard_normal(v.shape)).to(v.dtype)
         for k, v in tmpl.items()}
    st.write_(3, a)
    st.apply_copies([(3, 1)])
    back = st.read_([1, 3])
    for k, v in a.items():
        assert torch.equal(back[k][0], v) and torch.equal(back[k][1], v)
    assert st.keys == tuple(sorted(tmpl))
    assert st.bytes_per_block() == sum(v.numel() * v.element_size()
                                       for v in tmpl.values())
    with pytest.raises(ValueError, match="codec"):
        StatePagedStore(2, tmpl, codec_name="int4")


# ---------------------------------------------------------------------------
# LLMExecutor over SSM state slots
# ---------------------------------------------------------------------------


def _serve(engine_cls, executor, prompts=_PROMPTS):
    eng = engine_cls("fcfs")
    eng.register("llm", executor)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    out = eng.run()
    return [out[h.uid] for h in hs], executor, eng, [h.uid for h in hs]


def _record_logits(ex) -> dict:
    """Keep, per request uid, the logits row a reference executor sampled
    each emitted token from."""
    rows: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        lg32 = np.asarray(lg, np.float32)
        if admitting:
            rows.setdefault(admitting.pop(), []).append(lg32[0])
        else:
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(lg32[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


def _margin_rule(got, want, rows, uids, vocab):
    for uid, g, w in zip(uids, got, want):
        assert len(g) == len(w)
        for j, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            top = np.sort(rows[uid][j][:vocab])[-2:]
            assert top[1] - top[0] <= 2 * LOGIT_TOL, \
                f"token {j} differs ({a} vs {b}) at margin {top[1] - top[0]}"
            break


def test_engine_tokens_match_reference():
    jp, jcfg, p, cfg = _model()
    jex = JLLM(jp, jcfg, JServerConfig(**_KW))
    rows = _record_logits(jex)
    want, _, _, juids = _serve(JEngine, jex)
    got, ex, eng, _ = _serve(CutieEngine, LLMExecutor(p, cfg,
                                                      ServerConfig(**_KW)))
    _margin_rule(got, want, rows, juids, cfg.vocab)
    st = eng.stats()["paged_state"]["llm"]
    assert st == {**st, **{k: v for k, v in jex.extra_stats().items()
                           if k in ("prefix_hit_rate", "prefill_tokens",
                                    "prefill_tokens_computed",
                                    "prefix_entries")}}
    assert ex.free_capacity() == _KW["n_slots"]


def test_paged_identical_to_contiguous_with_prefix_snapshots():
    _, _, p, cfg = _model()
    out_c, _, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=False, **_KW)))
    out_p, ex, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=True, **_KW)))
    assert out_c == out_p
    st = ex.extra_stats()
    assert st["prefix_hit_rate"] > 0.5
    assert st["prefill_tokens_computed"] < st["prefill_tokens"]
    with pytest.raises(NotImplementedError, match="paged KV"):
        ex.fork(1, 2)


def _record(ex) -> list:
    seen, sample = [], ex._sample

    def sample_(lg):
        seen.append(lg.detach().clone())
        return sample(lg)

    ex._sample = sample_
    return seen


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_snapshot_restore_mid_decode(tmp_path, paged):
    """An engine snapshotted mid-decode and restored into a fresh one
    finishes with the uninterrupted serve's tokens and logits bits."""
    _, _, p, cfg = _model()
    kw = dict(_KW, paged=paged)

    def engine():
        eng = CutieEngine("fcfs")
        ex = LLMExecutor(p, cfg, ServerConfig(**kw))
        eng.register("llm", ex)
        return eng, ex

    ref, rex = engine()
    want_logits = _record(rex)
    for pr in _PROMPTS:
        ref.submit(pr, model="llm")
    want = ref.run()
    eng, ex = engine()
    got_logits = _record(ex)
    for pr in _PROMPTS:
        eng.submit(pr, model="llm")
    for _ in range(3):
        eng.step()
    tree, _ = ex.snapshot()
    assert ("slot_bids" in tree) == paged
    path = save_serving_state(eng, str(tmp_path / "ck"))
    eng2, ex2 = engine()
    rest_logits = _record(ex2)
    handles = restore_serving_state(eng2, path.rsplit("/", 1)[0])
    eng2.run()
    for old_uid, h in handles.items():
        assert h.request.result == want[old_uid]
    both = got_logits + rest_logits
    assert len(both) == len(want_logits)
    for a, b in zip(both, want_logits):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# speculative decoding with SSM targets and drafts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["random", "self"])
def test_spec_serve_matches_plain_and_reference(draft):
    """A random 1-layer mamba2 draft (every verify rejects early) and the
    target as its own draft (every proposal accepted): the greedy tokens
    are the port's plain serve's; with the random draft, the reference's
    spec serve's too, under the margin rule."""
    jp, jcfg, p, cfg = _model(1)
    jdp, jdcfg, dp, dcfg = (_model(1, seed=1) if draft == "random"
                            else (jp, jcfg, p, cfg))
    kw = dict(_KW, max_new_tokens=8)
    plain, _, _, _ = _serve(CutieEngine, LLMExecutor(p, cfg,
                                                     ServerConfig(**kw)))
    got, ex, eng, _ = _serve(CutieEngine, SpecExecutor(
        p, cfg, ServerConfig(**kw), dp, dcfg))
    assert got == plain
    if draft == "random":
        jex = JSpec(jp, jcfg, JServerConfig(**kw), jdp, jdcfg)
        jplain_ex = JLLM(jp, jcfg, JServerConfig(**kw))
        rows = _record_logits(jplain_ex)
        jplain, _, _, juids = _serve(JEngine, jplain_ex)
        want, _, _, _ = _serve(JEngine, jex)
        assert want == jplain               # the reference's own rule
        _margin_rule(got, want, rows, juids, cfg.vocab)
    spec = ex.extra_stats()["spec"]
    assert spec["verify_steps"] > 0
    if draft == "self":
        assert spec["acceptance_rate"] == 1.0
        assert spec["tokens_per_verify"] > 2.0
    else:
        assert spec["accepted_tokens"] < spec["proposed_tokens"]
    assert spec["verify_jit_variants"] == 1
    assert ex.pool.num_blocks == 1 + 4 * 8 + 4      # an SSM draft: x1
    assert ex.free_capacity() == kw["n_slots"]
