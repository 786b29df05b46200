"""The port's encdec family (whisper-medium: a non-causal encoder over
precomputed frames with learned positions, a causal rope decoder with
cross-attention) against the JAX reference, on the CPU at the reduced
config (`reduce_for_smoke`: 2 encoder and 2 decoder layers, 16 frames,
d_model 64, GELU MLP, layernorm).

Parameters are the reference's ``init_params`` carried across with
`repro_torch.convert.llm_params_from_numpy`; inputs come from numpy
seeds.

Tolerances, stated once:

* attention on the same bf16 inputs: within ``ATTN_TOL`` (f32 sums in
  other orders, one bf16 rounding; tests/test_torch_llm_train.py's);
* the encoder output, the cross cache, logits and KV rows: within
  ``LOGIT_TOL`` (tests/test_torch_llm.py's rule: bf16 rounded at the same
  places, f32 sums in other orders; measured up to 0.037 at |value| up
  to 3.6);
* losses within ``LOSS_TOL`` (tests/test_torch_llm_train.py's);
* gradients of ``forward_loss`` (``ternary``): each leaf's relative L2
  error within ``GRAD_RTOL``, or within twice the reference's own spread
  under a one-ulp nudge of half its embedding
  (tests/test_torch_hybrid.py's `check_gradients`; measured 0.018);
* the teacher-forced decode against one forward over the same tokens:
  the last logits within ``LOGIT_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as JATT
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro_torch import configs, convert
from repro_torch.models import attention as ATT
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import LLMExecutor, ServerConfig
from test_torch_hybrid import GRAD_RTOL, check_gradients

ARCH = "whisper_medium"
ATTN_TOL = 2.0 ** -6
LOGIT_TOL = 2.0 ** -4
LOSS_TOL = 2.0 ** -6
QUANTS = ("none", "ternary", "ternary_packed")

_MODELS: dict = {}


def _model(quant="ternary_packed"):
    """Both packages' reduced configs and params (the reference's init)."""
    if quant not in _MODELS:
        jcfg = jreduce(jconfigs.get(ARCH)).replace(quant=quant)
        cfg = reduce_for_smoke(configs.get(ARCH)).replace(quant=quant)
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


def _close(got, want, tol):
    err = float(np.abs(_f32(got) - _f32(want)).max())
    assert err <= tol, f"max |err| {err} > {tol}"


def _both(a, dtype=torch.bfloat16):
    t = torch.as_tensor(np.asarray(a, np.float32)).to(dtype)
    return t, jnp.asarray(_f32(t), str(dtype).split(".")[-1])


def _inputs(cfg, b=2, s=9, seed=0):
    """Decoder tokens (B, S) and encoder frames (B, enc_seq, D) f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)),
            rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(
                np.float32))


def _cross(p, jp, cfg, jcfg, frames):
    """Both packages' cross caches from their own `encode` of the same
    frames: ``{"k"/"v": (L, B, enc_seq, Hk, Dh)}``."""
    enc = TF.encode(p, torch.as_tensor(frames), cfg)
    jenc = jax.jit(lambda q, f: JTF.encode(q, f, jcfg))(jp,
                                                        jnp.asarray(frames))
    kv = [TF._xattn_kv(lp["xattn"], enc, cfg) for lp in p["layers"]]
    jk, jv = jax.jit(jax.vmap(lambda lp: JTF._xattn_kv(lp, jenc, jcfg)))(
        jp["layers"]["xattn"])
    return (enc, jenc, {"k": torch.stack([k for k, _ in kv]),
                        "v": torch.stack([v for _, v in kv])},
            {"k": jk, "v": jv})


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------


def test_config_and_reduced_config_are_the_reference_ones():
    assert dataclasses.asdict(configs.get("whisper-medium")) == \
        dataclasses.asdict(jconfigs.get(ARCH))
    cfg = reduce_for_smoke(configs.get(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreduce(jconfigs.get(ARCH)))
    assert (cfg.enc_layers, cfg.enc_seq) == (2, 16)


def test_convert_keeps_encoder_and_decoder_trees():
    jp, _, p, cfg = _model()
    assert p["dec_pos"] is None and jp["dec_pos"] is None
    assert len(p["enc_layers"]) == cfg.enc_layers
    assert len(p["layers"]) == cfg.n_layers
    assert np.array_equal(_f32(p["enc_pos"]), _f32(jp["enc_pos"]))
    assert np.array_equal(_f32(p["ln_enc"]["bias"]),
                          _f32(jp["ln_enc"]["bias"]))
    assert set(p["layers"][0]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                   "mlp"}
    assert np.array_equal(
        p["layers"][1]["xattn"]["wk"]["w_packed"].numpy(),
        np.asarray(jp["layers"]["xattn"]["wk"]["w_packed"][1]))
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="enc_layers"):
        convert.llm_params_from_numpy(tree, cfg.replace(enc_layers=3),
                                      device="cpu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,t", [(40, 40), (9, 37), (16, 1500 // 50)])
def test_noncausal_flash_attention_matches_reference(s, t):
    """The non-causal grid: T != S, and kv tails that are not a multiple
    of the chunk (masked), queries padded up to their chunk grid."""
    rng = np.random.default_rng(s + t)
    q, jq = _both(rng.standard_normal((2, s, 4, 16)))
    k, jk = _both(rng.standard_normal((2, t, 4, 16)))
    v, jv = _both(rng.standard_normal((2, t, 4, 16)))
    got = ATT.flash_attention(q, k, v, q_chunk=16, kv_chunk=16,
                              causal=False)
    want = JATT.flash_attention(jq, jk, jv, causal=False, q_chunk=16,
                                kv_chunk=16)
    assert got.shape == (2, s, 4, 16) and got.dtype == torch.bfloat16
    _close(got, want, ATTN_TOL)


def test_attention_forms_and_cross_decode_match_reference():
    """Self-attention without causality or rope (the encoder), the
    cross-attention with the encoder's keys and values, and its decode
    form, which reads the static cache and writes nothing."""
    jp, jcfg, p, cfg = _model("none")
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = p["layers"][0]
    rng = np.random.default_rng(1)
    x, jx = _both(rng.standard_normal((2, 7, cfg.d_model)))
    e, je = _both(rng.standard_normal((2, cfg.enc_seq, cfg.d_model)))
    pos, jpos = torch.arange(7)[None], jnp.arange(7)[None]
    y, (k, v) = ATT.attention(lp["attn"], x, cfg, positions=pos,
                              causal=False, rope=False)
    jy, (jk, jv) = JATT.attention(jl["attn"], jx, jcfg, positions=jpos,
                                  causal=False, rope=False)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, LOGIT_TOL)
    kv = TF._xattn_kv(lp["xattn"], e, cfg)
    jkv = JTF._xattn_kv(jl["xattn"], je, jcfg)
    y, (k, v) = ATT.attention(lp["xattn"], x, cfg, positions=pos,
                              causal=False, rope=False, kv_override=kv)
    jy, _ = JATT.attention(jl["xattn"], jx, jcfg, positions=jpos,
                           causal=False, rope=False, kv_override=jkv)
    assert k is kv[0] and v is kv[1]
    _close(y, jy, LOGIT_TOL)
    cache = {"k": kv[0].clone(), "v": kv[1].clone()}
    y, new = ATT.decode_attention(lp["xattn"], x[:, :1], cfg, cache,
                                  torch.tensor([3, 5]), rope=False,
                                  cross=True)
    jy, jnew = JATT.decode_attention(
        jl["xattn"], jx[:, :1], jcfg, {"k": jkv[0], "v": jkv[1]},
        jnp.asarray([3, 5], jnp.int32), rope=False, cross=True)
    _close(y, jy, LOGIT_TOL)
    assert torch.equal(new["k"], kv[0]) and torch.equal(new["v"], kv[1])


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ("none", "ternary_packed"))
def test_encode_and_cross_cache_match_reference(quant):
    jp, jcfg, p, cfg = _model(quant)
    _, frames = _inputs(cfg)
    enc, jenc, cross, jcross = _cross(p, jp, cfg, jcfg, frames)
    assert enc.shape == (2, cfg.enc_seq, cfg.d_model)
    assert enc.dtype == torch.bfloat16
    _close(enc, jenc, LOGIT_TOL)
    for k in ("k", "v"):
        assert tuple(cross[k].shape) == jcross[k].shape == (
            cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv, cfg.d_head)
        _close(cross[k], jcross[k], LOGIT_TOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_logits_and_loss_match_reference(quant):
    jp, jcfg, p, cfg = _model(quant)
    toks, frames = _inputs(cfg, s=10, seed=2)
    tb = {"tokens": torch.as_tensor(toks), "frames": torch.as_tensor(frames)}
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    lg = TF.forward_logits(p, tb, cfg)
    jlg = jax.jit(lambda q, b: JTF.forward_logits(q, b, jcfg))(jp, jb)
    assert lg.shape == jlg.shape == (2, 1, TF.vocab_padded(cfg))
    _close(lg, jlg, LOGIT_TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": frames}
    loss, m = TF.forward_loss(p, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    jloss, jm = jax.jit(lambda q, b: JTF.forward_loss(q, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert float(m["tokens"]) == float(jm["tokens"]) == toks[:, 1:].size


def test_forward_loss_gradients_match_reference():
    """tests/test_torch_hybrid.py's `check_gradients` rule, every leaf of
    the encoder and the decoder (``dec_pos`` is None in both)."""
    jp, jcfg, _, cfg = _model("ternary")
    toks, frames = _inputs(cfg, s=13, seed=5)
    n, worst, _ = check_gradients(jp, jcfg, cfg, {
        "tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames})
    # embed, head, ln_f (2), enc_pos, ln_enc (2), the stacked encoder
    # layers' 10 leaves and the decoder layers' 16
    assert n == 1 + 1 + 2 + 1 + 2 + 10 + 16
    assert worst <= GRAD_RTOL


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ("none", "ternary_packed"))
def test_decode_steps_match_reference_and_forward(quant):
    """Caches with a cross cache built from `encode` in each package; a
    teacher-forced decode over the tokens, step by step against the
    reference's, and its last logits against one forward."""
    jp, jcfg, p, cfg = _model(quant)
    toks, frames = _inputs(cfg, s=7, seed=3)
    b, s = toks.shape
    caches = DEC.init_caches(cfg, b, 16)
    jc = JDEC.init_caches(jcfg, b, 16)
    assert set(caches) == set(jc) == {"kv", "cross"}
    for part in caches:
        for k, v in caches[part].items():
            assert tuple(v.shape) == jc[part][k].shape, (part, k)
    assert caches["cross"]["k"].shape[2] == cfg.enc_seq
    _, _, cross, jcross = _cross(p, jp, cfg, jcfg, frames)
    caches["cross"], jc["cross"] = cross, jcross
    kept = {k: v.clone() for k, v in cross.items()}
    jstep = jax.jit(lambda q, t, c, i: JDEC.decode_step(q, t, c, i, jcfg))
    for i in range(s):
        lg, caches = DEC.decode_step(p, torch.as_tensor(toks[:, i:i + 1]),
                                     caches, torch.full((b,), i), cfg)
        jlg, jc = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                        jnp.full((b,), i, jnp.int32))
        _close(lg, jlg, LOGIT_TOL)
    for k in ("k", "v"):
        assert torch.equal(caches["cross"][k], kept[k])
        _close(caches["kv"][k][:, :, :s], jc["kv"][k][:, :, :s], LOGIT_TOL)
    full = TF.forward_logits(p, {"tokens": torch.as_tensor(toks),
                                 "frames": torch.as_tensor(frames)}, cfg)
    _close(lg[:, -1], full[:, -1], LOGIT_TOL)


def test_executor_and_prefills_refuse_encdec():
    _, _, p, cfg = _model()
    with pytest.raises(NotImplementedError, match="no serving executor"):
        LLMExecutor(p, cfg, ServerConfig())
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="encdec"):
        DEC.prefill_with_cache(p, {"tokens": toks}, cfg, 8)
    with pytest.raises(NotImplementedError, match="attention-family"):
        DEC.prefill_with_prefix(p, toks, {"k": torch.zeros(1, 1, 1, 0)},
                                cfg)
