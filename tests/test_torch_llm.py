"""The port's dense LLM stack and its serving path against the JAX
reference, at the reduced llama3.2-1B config (2 layers, d_model 64).

Parameters are drawn by the reference's ``init_params`` and carried
across with `repro_torch.convert.llm_params_from_numpy`; inputs come from
a numpy seed.  Every projection is ``quant="ternary_packed"``, so on the
CPU each runs the packed matmul kernel's plain version.

Tolerance: logits are O(1-4) in bf16; the two packages round bf16 at the
same places but sum f32 in other orders, so a value may land one or two
bf16 ulps apart per layer (2**-6 at magnitude 2-4).  ``LOGIT_TOL`` =
2**-4 bounds that for logits and cache rows.  A greedy token may then
differ only where the reference's top-2 logit margin is below
2 x LOGIT_TOL; the engine test checks that rule at every difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as JATT
from repro.models import common as JC
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import CutieEngine as JEngine
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro_torch import configs, convert
from repro_torch.models import attention as ATT
from repro_torch.models import common as C
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import CutieEngine, LLMExecutor, ServerConfig

LOGIT_TOL = 2.0 ** -4
BLOCK = 8
# attn_kv_chunk = block_size keeps the flash kv grid of a suffix prefill
# equal to the full prompt's (serving/llm.py), for paged == contiguous
OVERRIDES = dict(n_layers=2, quant="ternary_packed", attn_kv_chunk=BLOCK)
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(4)]
_KW = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=BLOCK)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduce(jconfigs.get("llama3_2_1b")).replace(**OVERRIDES)
    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(**OVERRIDES)
    jp = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    return jp, jcfg, p, cfg


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=LOGIT_TOL):
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= tol, f"max |err| {err} > {tol}"


def _bf16(a):
    return (torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16),
            jnp.asarray(a, jnp.bfloat16))


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


def test_convert_keeps_every_leaf(model):
    jp, jcfg, p, cfg = model
    assert len(p["layers"]) == cfg.n_layers
    for name in ("wq", "wk", "wv", "wo"):
        for i in range(cfg.n_layers):
            want = np.asarray(jp["layers"]["attn"][name]["w_packed"][i])
            got = p["layers"][i]["attn"][name]["w_packed"]
            assert got.dtype == torch.uint8 and np.array_equal(got.numpy(),
                                                               want)
    assert p["embed"].dtype == torch.bfloat16
    assert np.array_equal(_f32(p["embed"]), _f32(jp["embed"]))
    assert TF.vocab_padded(cfg) == JTF.vocab_padded(jcfg)


def test_linear_and_attention_match_reference(model):
    jp, jcfg, p, cfg = model
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    lp = p["layers"][0]
    rng = np.random.default_rng(1)
    xt, xj = _bf16(rng.standard_normal((2, 21, cfg.d_model)))
    _close(C.linear(lp["mlp"]["gate"], xt, quant=cfg.quant),
           JC.linear(jl["mlp"]["gate"], xj, quant=jcfg.quant))
    _close(C.linear(lp["mlp"]["down"], _bf16(np.ones((1, cfg.d_ff)))[0],
                    quant=cfg.quant),
           JC.linear(jl["mlp"]["down"], jnp.ones((1, cfg.d_ff), jnp.bfloat16),
                     quant=jcfg.quant))
    pos_t = torch.arange(21)[None]
    y, (k, v) = ATT.attention(lp["attn"], xt, cfg, positions=pos_t)
    jy, (jk, jv) = JATT.attention(jl["attn"], xj, jcfg,
                                  positions=jnp.arange(21)[None])
    for got, want in ((y, jy), (k, jk), (v, jv)):
        assert got.dtype == torch.bfloat16
        _close(got, want)


def test_prefill_decode_and_prefix_prefill_match_reference(model):
    jp, jcfg, p, cfg = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 19))
    jl, jc = JDEC.prefill_with_cache(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                     32)
    tl, tc = DEC.prefill_with_cache(p, {"tokens": torch.as_tensor(toks)},
                                    cfg, 32)
    assert tl.shape == (2, 1, TF.vocab_padded(cfg))
    _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(TF.forward_logits(p, {"tokens": torch.as_tensor(toks)}, cfg), jl)
    # one decode step at per-row positions, from each side's own cache
    tok = rng.integers(0, cfg.vocab, (2, 1))
    pos = np.array([19, 19])
    jd, _ = JDEC.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg)
    td, tc2 = DEC.decode_step(p, torch.as_tensor(tok), tc,
                              torch.as_tensor(pos), cfg)
    _close(td, jd)
    assert tc2["kv"]["k"][:, :, 19].abs().sum() > 0     # row written
    # suffix prefill over 16 cached prefix rows
    pk = {n: jc["kv"][n][:, :, :16] for n in ("k", "v")}
    jsl, jskv = JDEC.prefill_with_prefix(jp, jnp.asarray(toks[:, 16:]), pk,
                                         jcfg)
    tsl, tskv = DEC.prefill_with_prefix(
        p, torch.as_tensor(toks[:, 16:]),
        {n: torch.as_tensor(_f32(a)).to(torch.bfloat16)
         for n, a in pk.items()}, cfg)
    _close(tsl, jsl)
    _close(tskv["v"], jskv["v"])


# ---------------------------------------------------------------------------
# engine-served tokens
# ---------------------------------------------------------------------------


def _serve(engine_cls, executor, prompts=_PROMPTS):
    eng = engine_cls("fcfs")
    eng.register("llm", executor)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    out = eng.run()
    return [out[h.uid] for h in hs], executor, eng, [h.uid for h in hs]


def _record_logits(ex) -> dict:
    """Wrap a reference executor so that it keeps, per request uid, the
    logits row it sampled each emitted token from (prefill, then each
    decode step)."""
    rows: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        lg32 = np.asarray(lg, np.float32)
        if admitting:                             # a prefill's first token
            rows.setdefault(admitting.pop(), []).append(lg32[0])
        else:                                     # one decode step
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(lg32[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


@pytest.mark.parametrize("kv_codec", ["raw", "trit"])
def test_engine_tokens_match_reference(model, kv_codec):
    """Greedy tokens served by the port's CutieEngine + LLMExecutor equal
    the reference's, except where the reference's own top-2 logit margin
    at that step is within 2 x LOGIT_TOL (then the request is not compared
    further: the sequences have diverged).  ``trit`` stores the paged KV
    rows ternarized 5 per byte, on both sides."""
    jp, jcfg, p, cfg = model
    kw = dict(_KW, kv_codec=kv_codec)
    jex = JLLM(jp, jcfg, JServerConfig(**kw))
    rows = _record_logits(jex)
    want, _, _, juids = _serve(JEngine, jex)
    got, ex, eng, _ = _serve(CutieEngine, LLMExecutor(p, cfg,
                                                      ServerConfig(**kw)))
    for uid, g, w in zip(juids, got, want):
        assert len(g) == len(w) == _KW["max_new_tokens"]
        assert [int(np.argmax(r[:cfg.vocab])) for r in rows[uid]] == w
        for j, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            top = np.sort(rows[uid][j][:cfg.vocab])[-2:]
            assert top[1] - top[0] <= 2 * LOGIT_TOL, \
                f"token {j} differs ({a} vs {b}) at margin {top[1] - top[0]}"
            break
    st = eng.stats()["paged_state"]["llm"]
    assert st["prefix_hit_rate"] > 0.5 and st["evictions"] == 0
    assert st["prefills"] == len(_PROMPTS) and st["decode_steps"] > 0
    assert ex.n_jit_variants >= 2


@pytest.mark.parametrize("case", ["shared_prefix", "eviction_pressure"])
def test_paged_identical_to_contiguous(model, case):
    _, _, p, cfg = model
    prompts, kw = _PROMPTS, dict(_KW)
    if case == "eviction_pressure":
        # distinct prefixes: every finished prompt parks 2 committed
        # blocks, so a 10-block pool runs dry by the 4th admission
        prompts = [np.concatenate([[i], np.arange(21) % 40])
                   for i in range(4)]
    out_c, _, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=False, **kw)), prompts)
    tight = dict(num_blocks=10) if case == "eviction_pressure" else {}
    out_p, ex, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=True, **kw, **tight)), prompts)
    assert out_c == out_p                    # token-for-token identical
    st = ex.extra_stats()
    if case == "eviction_pressure":
        assert st["evictions"] > 0
    else:
        assert st["prefill_tokens_computed"] < st["prefill_tokens"]


class _Req:
    def __init__(self, uid, value):
        self.uid, self.value = uid, value


def test_fork_is_copy_on_write_and_does_not_perturb_parent(model):
    _, _, p, cfg = model
    scfg = ServerConfig(paged=True, n_slots=2, max_new_tokens=6,
                        max_len=64, block_size=BLOCK)
    prompt = np.asarray(_PROMPTS[0], np.int32)

    def drain(ex, reqs=()):
        outs = dict(ex.execute(list(reqs)).completions)
        for _ in range(40):
            if not ex.has_resident():
                break
            outs.update(ex.execute([]).completions)
        return outs

    base = drain(LLMExecutor(p, cfg, scfg), [_Req(1, prompt)])
    ex = LLMExecutor(p, cfg, scfg)
    ex.execute([_Req(1, prompt)])            # prefill + first decode
    ex.fork(1, 2)
    assert ex.manager.get(2).table == ex.manager.get(1).table
    outs = drain(ex)
    assert outs[1] == base[1] and outs[2] == base[1]
    assert ex.pool.n_active == 0


# ---------------------------------------------------------------------------
# validation and the surfaces that wait for later slices
# ---------------------------------------------------------------------------


def test_validation_errors(model):
    _, _, p, cfg = model
    ex = LLMExecutor(p, cfg, ServerConfig(n_slots=1, max_len=32,
                                          max_new_tokens=8, block_size=8))
    ex.validate(np.arange(24))               # 24 + 8 == 32: fits
    with pytest.raises(ValueError, match="max_new_tokens"):
        ex.validate(np.arange(25))
    with pytest.raises(ValueError, match="non-empty"):
        ex.validate(np.zeros((0,), np.int32))
    tight = LLMExecutor(p, cfg, ServerConfig(
        paged=True, n_slots=4, max_len=64, block_size=8, max_new_tokens=4,
        num_blocks=1 + 2 * 8))
    assert tight.free_capacity() == 2        # 16 blocks / 8 per seq
    with pytest.raises(ValueError, match="multiple"):
        LLMExecutor(p, cfg, ServerConfig(max_len=60, block_size=8))


def test_unported_surfaces_name_their_roadmap_item(model):
    _, _, p, cfg = model
    with pytest.raises(NotImplementedError, match="item 10"):
        configs.get("mamba2-780m")
    with pytest.raises(NotImplementedError, match="item 10"):
        TF.init_params(cfg.replace(family="moe"), torch.Generator())
    with pytest.raises(NotImplementedError, match="item 10"):
        LLMExecutor(p, cfg.replace(family="ssm"), ServerConfig())
    ex = LLMExecutor(p, cfg, ServerConfig())
    with pytest.raises(NotImplementedError, match="item 8"):
        ex.snapshot()
    with pytest.raises(NotImplementedError, match="item 6"):
        C.linear({"w": torch.zeros(2, 2)}, torch.zeros(1, 2),
                 quant="ternary")
