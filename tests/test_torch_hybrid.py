"""The port's hybrid family (zamba2-2.7b: mamba2 layers plus ONE shared
attention + MLP block applied after every ``attn_every``-th layer)
against the JAX reference, on the CPU at the reduced config
(`reduce_for_smoke`: 4 mamba2 layers, the shared block after layers 2
and 4, d_model 64, state 16, head dim 16, chunk 16).

Parameters are the reference's ``init_params`` carried across with
`repro_torch.convert.llm_params_from_numpy`; inputs come from numpy
seeds.

Tolerances, stated once:

* one block (a mamba2 layer, or the shared block) on the reference's own
  input: within ``BLOCK_ULPS`` bf16 ulps of the output's largest |value|
  (bf16 rounded at the same places, f32 sums in other orders: one ulp
  apart at most, measured);
* whole-model logits: within ``HYBRID_LOGIT_TOL``.  The residual stream
  grows to |h| about 10 through six blocks, and the chunked SSD scan and
  attention carry each block's one-ulp differences on (measured: 0.06
  with ``quant="none"``, 0.12 ``ternary_packed``, 0.30 ``ternary``, max
  |logit| about 3.5), so the whole model is held at 2**-1 while each
  block is held tightly;
* losses within ``LOSS_TOL`` (tests/test_torch_llm_train.py's);
* gradients of ``forward_loss`` (``ternary``): each leaf's relative L2
  error within ``GRAD_RTOL``, or within twice the reference's own
  spread: the relative L2 distance between the reference's gradients at
  its parameters and with half the embedding moved by one bf16 ulp
  (`check_gradients`).  Under ternary weights the mixers' B, C and dt
  gradients move by up to 0.27-0.38 under that nudge in the reference
  itself (the port's differ by up to 0.32);
* the first mixer's f32 state within ``STATE_RTOL`` of its largest
  |value| (tests/test_torch_ssm.py's), every mixer's within
  ``HYBRID_STATE_RTOL`` (their inputs carry the blocks' differences on:
  measured up to 0.02 of the largest |value| after 6 tokens), KV rows
  within ``HYBRID_LOGIT_TOL``;
* `ssm_prefill_states` against sequential decode steps: bit for bit;
* the token-by-token decode against the chunked forward: the reference's
  own ``test_decode_matches_prefill`` rule (correlation above 0.99, every
  logit within 0.3 + 0.3 |logit|, the step's argmax among the forward's
  top 5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro_torch import configs, convert
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import LLMExecutor, ServerConfig, SpecExecutor

ARCH = "zamba2_2_7b"
BLOCK_ULPS = 2
HYBRID_LOGIT_TOL = 2.0 ** -1
LOSS_TOL = 2.0 ** -6
GRAD_RTOL = 2.0 ** -4
STATE_RTOL = 2.0 ** -6
HYBRID_STATE_RTOL = 2.0 ** -4
QUANTS = ("none", "ternary", "ternary_packed")

_MODELS: dict = {}


def _model(quant="ternary_packed"):
    """Both packages' reduced configs and params (the reference's init)."""
    if quant not in _MODELS:
        jcfg = jreduce(jconfigs.get(ARCH)).replace(quant=quant)
        cfg = reduce_for_smoke(configs.get(ARCH)).replace(quant=quant)
        # jitted: one compile instead of one per eager op
        jp = jax.jit(JTF.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
        _MODELS[quant] = (jp, jcfg, p, cfg)
    return _MODELS[quant]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _err(got, want) -> float:
    return float(np.abs(_f32(got) - _f32(want)).max())


def _close(got, want, tol):
    err = _err(got, want)
    assert err <= tol, f"max |err| {err} > {tol}"


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want's largest |value|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(_f32(want)).max())) - 7)
    return _err(got, want) / ulp


def _state_close(got, want):
    """SSM states (L, ...): the first layer's within STATE_RTOL of its
    largest |value|, every layer's within HYBRID_STATE_RTOL."""
    got, want = _f32(got), _f32(want)
    for layers, rtol in ((slice(0, 1), STATE_RTOL),
                         (slice(None), HYBRID_STATE_RTOL)):
        err = np.abs(got[layers] - want[layers]).max()
        assert err <= rtol * np.abs(want[layers]).max(), (layers, err)


def _tokens(cfg, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_config_and_reduced_config_are_the_reference_ones():
    assert dataclasses.asdict(configs.get("zamba2-2.7b")) == \
        dataclasses.asdict(jconfigs.get(ARCH))
    cfg = reduce_for_smoke(configs.get(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreduce(jconfigs.get(ARCH)))
    assert (cfg.attn_every, cfg.n_layers) == (2, 4)


def test_convert_keeps_the_shared_block():
    jp, _, p, cfg = _model()
    assert len(p["layers"]) == cfg.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        want = np.asarray(jp["shared_attn"]["attn"][name]["w_packed"])
        got = p["shared_attn"]["attn"][name]["w_packed"]
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_f32(p["shared_attn"]["ln1"]["scale"]),
                          _f32(jp["shared_attn"]["ln1"]["scale"]))


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ("none", "ternary_packed"))
def test_blocks_match_reference_layer_by_layer(quant):
    """Each mamba2 layer and each application of the shared block, on the
    reference's own input."""
    jp, jcfg, p, cfg = _model(quant)
    toks = _tokens(cfg)
    jx = JTF._embed(jp, jnp.asarray(toks), jcfg)
    pos, jpos = torch.arange(toks.shape[1])[None], jnp.arange(
        toks.shape[1])[None]
    ssm_block = jax.jit(lambda lp, x: JTF.ssm_block(lp, x, jcfg))
    shared = jax.jit(lambda lp, x: JTF.dense_block(lp, x, jcfg, jpos))
    apps = 0
    for i, lp in enumerate(p["layers"]):
        jl = jax.tree.map(lambda a, i=i: a[i], jp["layers"])
        jy = ssm_block(jl, jx)
        y = TF.ssm_block(lp, torch.as_tensor(_f32(jx)).to(torch.bfloat16),
                         cfg)
        assert _ulps(y, jy) <= BLOCK_ULPS, ("ssm", i)
        jx = jy
        if (i + 1) % cfg.attn_every == 0:
            jy = shared(jp["shared_attn"], jx)
            y = TF.dense_block(p["shared_attn"], torch.as_tensor(
                _f32(jx)).to(torch.bfloat16), cfg, pos)
            assert _ulps(y, jy) <= BLOCK_ULPS, ("shared", i)
            jx, apps = jy, apps + 1
    assert apps == cfg.n_layers // cfg.attn_every == 2


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_logits_and_loss_match_reference(quant):
    jp, jcfg, p, cfg = _model(quant)
    toks = _tokens(cfg, s=13)
    lg = TF.forward_logits(p, {"tokens": torch.as_tensor(toks)}, cfg)
    jlg = jax.jit(lambda q, b: JTF.forward_logits(q, b, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    assert lg.shape == jlg.shape == (2, 1, TF.vocab_padded(cfg))
    _close(lg, jlg, HYBRID_LOGIT_TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, m = TF.forward_loss(p, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    jloss, _ = jax.jit(lambda q, b: JTF.forward_loss(q, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert float(m["lb_loss"]) == float(m["z_loss"]) == 0.0


def _leaf_paths(tree, prefix=()):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nudged(jp):
    """The reference's parameters with half the embedding's entries moved
    up by one bf16 ulp (2**-7 relative)."""
    e = np.asarray(jp["embed"]).astype(np.float32)
    up = np.random.default_rng(9).random(e.shape) < 0.5
    return dict(jp, embed=jnp.asarray(np.where(up, e * (1 + 2.0 ** -7), e),
                                      jnp.bfloat16))


def check_gradients(jp, jcfg, cfg, batch):
    """``forward_loss``'s gradients in both packages, leaf by leaf (the
    port's layers stacked as the reference's, as the training loop keeps
    them): each leaf's relative L2 error within GRAD_RTOL, or within
    twice the reference's own spread, the relative L2 distance between
    its gradients at its parameters and at `_nudged` ones.  Returns
    (leaves, the largest error, the largest spread)."""
    p = TF.stack_layers(convert.llm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    paths = [path for path, _ in _leaf_paths(p)]
    leaves = [_at(p, path).requires_grad_(True) for path in paths]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _ = TF.forward_loss(TF.unstack_layers(p), tb, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad = jax.jit(jax.grad(lambda q: JTF.forward_loss(q, jb, jcfg)[0]))
    jgrads, jnudged = jgrad(jp), jgrad(_nudged(jp))
    worst = spread_max = 0.0
    for path, g in zip(paths, grads):
        want = _f32(_at(jgrads, path))
        got = np.zeros_like(want) if g is None else _f32(g)
        assert got.shape == want.shape, path
        norm = np.linalg.norm(want)
        err = np.linalg.norm(got - want) / norm
        spread = np.linalg.norm(_f32(_at(jnudged, path)) - want) / norm
        assert err <= max(GRAD_RTOL, 2 * spread), (path, err, spread)
        worst, spread_max = max(worst, err), max(spread_max, spread)
    return len(paths), worst, spread_max


def test_forward_loss_gradients_match_reference():
    jp, jcfg, _, cfg = _model("ternary")
    toks = _tokens(cfg, s=17, seed=5)
    n, _, spread = check_gradients(jp, jcfg, cfg, {"tokens": toks[:, :-1],
                                                   "labels": toks[:, 1:]})
    assert n == 29
    # the SSD mixers' B, C and dt gradients under ternary weights move by
    # a quarter when half the embedding moves by one ulp
    assert spread > GRAD_RTOL


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ("none", "ternary_packed"))
def test_init_caches_and_decode_steps_match_reference(quant):
    jp, jcfg, p, cfg = _model(quant)
    b, steps, max_len = 2, 6, 16
    caches = DEC.init_caches(cfg, b, max_len)
    jc = JDEC.init_caches(jcfg, b, max_len)
    assert set(caches) == set(jc) == {"ssm", "kv"}
    for part in caches:
        for k, v in caches[part].items():
            assert tuple(v.shape) == jc[part][k].shape, (part, k)
            assert str(v.dtype).split(".")[-1] == str(jc[part][k].dtype)
    assert caches["kv"]["k"].shape[0] == cfg.n_layers // cfg.attn_every
    toks = _tokens(cfg, b, steps, seed=1)
    jstep = jax.jit(lambda q, t, c, i: JDEC.decode_step(q, t, c, i, jcfg))
    for i in range(steps):
        lg, caches = DEC.decode_step(p, torch.as_tensor(toks[:, i:i + 1]),
                                     caches, torch.full((b,), i), cfg)
        jlg, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                        jnp.full((b,), i, jnp.int32))
        _close(lg, jlg, HYBRID_LOGIT_TOL)
    _state_close(caches["ssm"]["ssm"], jc["ssm"]["ssm"])
    for k in ("k", "v"):
        _close(caches["kv"][k][:, :, :steps], jc["kv"][k][:, :, :steps],
               HYBRID_LOGIT_TOL)
        assert not caches["kv"][k][:, :, steps:].any()


def test_shared_block_reads_one_weight_set_and_writes_distinct_caches(
        monkeypatch):
    """The j-th application of the shared block in a decode step runs the
    one ``shared_attn`` dict on KV cache j."""
    _, _, p, cfg = _model()
    seen, body = [], DEC._decode_body

    def body_(h, lp, ck, cv, **kw):
        seen.append((lp, ck.data_ptr(), cv.data_ptr()))
        return body(h, lp, ck, cv, **kw)

    monkeypatch.setattr(DEC, "_decode_body", body_)
    caches = DEC.init_caches(cfg, 1, 8)
    DEC.decode_step(p, torch.tensor([[3]]), caches, torch.tensor([0]), cfg)
    n = cfg.n_layers // cfg.attn_every
    assert len(seen) == n
    assert all(lp is p["shared_attn"] for lp, _, _ in seen)
    assert len({ptr for _, ptr, _ in seen}) == n
    assert [ptr for _, ptr, _ in seen] == [caches["kv"]["k"][j].data_ptr()
                                           for j in range(n)]
    rows = caches["kv"]["k"][:, 0, 0]
    assert rows.any() and not torch.equal(rows[0], rows[1])


def test_ssm_prefill_states_equal_sequential_decode_and_reference():
    jp, jcfg, p, cfg = _model()
    toks = _tokens(cfg, 2, 6, seed=3)
    logits, states = DEC.ssm_prefill_states(p, torch.as_tensor(toks),
                                            DEC.init_caches(cfg, 2, 16), cfg)
    assert set(states) == {"ssm", "kv"}
    c = DEC.init_caches(cfg, 2, 16)
    for i in range(toks.shape[1]):
        lg, c = DEC.decode_step(p, torch.as_tensor(toks[:, i:i + 1]), c, i,
                                cfg)
        assert torch.equal(lg[:, 0], logits[:, i])
        for part in c:
            for k, v in c[part].items():
                assert torch.equal(v, states[part][k][i]), (part, k, i)
    jlogits, jstates = JDEC.ssm_prefill_states(
        jp, jnp.asarray(toks), JDEC.init_caches(jcfg, 2, 16), jcfg)
    _close(logits, jlogits, HYBRID_LOGIT_TOL)
    for part in states:
        for k, v in states[part].items():
            assert tuple(v.shape) == jstates[part][k].shape, (part, k)
    _state_close(states["ssm"]["ssm"][:, 0], jstates["ssm"]["ssm"][:, 0])
    flog, fc = DEC.ssm_prefill(p, torch.as_tensor(toks),
                               DEC.init_caches(cfg, 2, 16), cfg)
    assert torch.equal(flog, logits)
    assert all(torch.equal(fc[part][k], c[part][k])
               for part in c for k in c[part])


def test_decode_matches_prefill():
    """The reference's own property (tests/test_arch_smoke.py
    ``test_decode_matches_prefill``) on the port, at its seed and
    sizes."""
    jp, jcfg, _, cfg = _model("none")
    jp1 = jax.jit(JTF.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1))
    p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp1), cfg,
                                      device="cpu")
    b, s = 1, 8
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)))
    full = TF.forward_logits(p, {"tokens": toks}, cfg)
    caches = DEC.init_caches(cfg, b, 16)
    for i in range(s):
        logits, caches = DEC.decode_step(p, toks[:, i:i + 1], caches,
                                         torch.full((b,), i), cfg)
    a, f = _f32(logits[:, -1]).ravel(), _f32(full[:, -1]).ravel()
    assert np.corrcoef(a, f)[0, 1] > 0.99
    np.testing.assert_allclose(a, f, rtol=0.3, atol=0.3)
    assert np.argmax(a) in np.argsort(f)[-5:]


# ---------------------------------------------------------------------------
# what the reference does not serve
# ---------------------------------------------------------------------------


def test_executors_and_attention_prefills_refuse_hybrid():
    _, _, p, cfg = _model()
    with pytest.raises(NotImplementedError, match="no serving executor"):
        LLMExecutor(p, cfg, ServerConfig())
    dense = reduce_for_smoke(configs.get("llama3.2-1b")).replace(
        vocab=cfg.vocab)
    gen = torch.Generator()
    gen.manual_seed(0)
    dp = TF.init_params(dense, gen)
    with pytest.raises(NotImplementedError, match="no serving executor"):
        SpecExecutor(dp, dense, ServerConfig(), p, cfg)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="SSM prefill"):
        DEC.prefill_with_cache(p, {"tokens": toks}, cfg, 8)
    with pytest.raises(NotImplementedError, match="attention-family"):
        DEC.prefill_with_prefix(p, toks, {"k": torch.zeros(1, 1, 1, 0)},
                                cfg)
    with pytest.raises(ValueError):
        TF.init_params(cfg.replace(family="rnn"), gen)
