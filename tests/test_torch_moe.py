"""The port's moe family against the JAX reference, on the CPU: the MoE
layer (`repro_torch.models.moe`), the deepseek-moe and qwen3-moe stacks
at reduced size (`reduce_for_smoke`: 2 layers, d_model 64, 8 experts,
top-2; deepseek with its leading dense layer and a shared expert,
qwen3-moe with qk-norm and no shared expert), their engine-served tokens
and the full-size parameter trees.

Parameters are the reference's ``init_params`` carried across with
`repro_torch.convert.llm_params_from_numpy`; inputs come from numpy
seeds.

Tolerances, stated once:

* routing (top-k indices, the kept mask, the dispatch slots) on inputs
  whose router logits are exact in f32 (trit inputs, router weights in
  eighths): equal, ties included;
* one MoE layer on the same bf16 input: ``lb_loss`` and ``z_loss``
  within ``AUX_RTOL`` relative (the f32 router matmul sums in another
  order), the output within ``MOE_ULPS`` bf16 ulps of its largest
  magnitude (the reduced init draws the experts with fan-in E, so
  outputs reach about 64; the expert matmuls round to bf16 at the same
  places and sum in f32 in other orders, so an element may land one ulp
  of its terms apart);
* whole-model logits and the aux losses of `forward_loss`: within
  ``LOGIT_TOL`` (tests/test_torch_llm.py's rule: bf16 rounded at the
  same places, f32 sums in other orders);
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
from repro.models import moe as JMOE
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import CutieEngine as JEngine
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro_torch import configs, convert
from repro_torch.models import decoding as DEC
from repro_torch.models import moe
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import CutieEngine, LLMExecutor, ServerConfig

LOGIT_TOL = 2.0 ** -4
MOE_ULPS = 2
AUX_RTOL = 1e-5
BLOCK = 8
ARCHS = ("deepseek_moe_16b", "qwen3_moe_30b_a3b")
OVERRIDES = dict(quant="ternary_packed", attn_kv_chunk=BLOCK)
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(4)]
_KW = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=BLOCK)


_MODELS: dict = {}


def _model(arch):
    """Both packages' reduced configs and params (the reference's init)."""
    if arch not in _MODELS:
        jcfg = jreduce(jconfigs.get(arch)).replace(**OVERRIDES)
        cfg = reduce_for_smoke(configs.get(arch)).replace(**OVERRIDES)
        # jitted: one compile instead of one per eager op
        jp = jax.jit(JTF.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")
        _MODELS[arch] = (jp, jcfg, p, cfg)
    return _MODELS[arch]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= tol, f"max |err| {err} > {tol}"


def _moe_tol(want) -> float:
    """``MOE_ULPS`` bf16 ulps of the largest |value| of ``want``."""
    top = float(np.abs(_f32(want)).max())
    return MOE_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


def _bf16(a):
    return (torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16),
            jnp.asarray(a, jnp.bfloat16))


def _moe_params(jp, layer=0):
    """One MoE layer's parameters from the reference's stacked tree, in
    both packages."""
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["moe"])
    return jl, convert._tree(jax.tree.map(np.asarray, jl), "cpu")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def test_moe_apply_matches_reference():
    """deepseek's MoE layer (shared expert); qwen3-moe's runs in the
    stack tests below."""
    jp, jcfg, _, cfg = _model("deepseek_moe_16b")
    jl, lp = _moe_params(jp)
    x, jx = _bf16(np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)))
    y, aux = moe.apply(lp, x, cfg)
    jy, jaux = JMOE.apply(jl, jx, jcfg)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    _close(y, jy, _moe_tol(jy))
    for k in ("lb_loss", "z_loss"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=AUX_RTOL)
    # "ep" without a mesh is the dense dispatch, as in the reference
    y_ep, _ = moe.apply(lp, x, cfg.replace(moe_impl="ep"))
    assert torch.equal(y_ep, y)


def _reference_routing(router, xt, cfg, cap):
    """The reference's routing and dispatch (`repro.models.moe`
    `_apply_dense`, lines 80-100) on ``xt``."""
    logits = xt.astype(jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.topk)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(cfg.n_experts),
                             side="left")
    pos = jnp.arange(flat_e.size) - start[sorted_e]
    keep = pos < cap
    slot = jnp.where(keep, sorted_e * cap + pos, 0)
    return [np.asarray(a) for a in (idx, order, keep, slot)]


@pytest.mark.parametrize("case", ["ties", "overflow"])
def test_routing_matches_reference_on_ties_and_overflow(case):
    """Router logits exact in f32: trit inputs, router weights in eighths.
    ``ties``: every expert's column repeated, so each token's top-2 are
    tied pairs (the lower index first, as ``jax.lax.top_k``); ``overflow``:
    experts 0 and 1 win every token of 160, so 32 assignments each
    overflow the capacity of 128 and drop."""
    jp, jcfg, _, cfg = _model("deepseek_moe_16b")
    jl, _ = _moe_params(jp)
    rng = np.random.default_rng(7)
    e, d = cfg.n_experts, cfg.d_model
    t = 40 if case == "ties" else 160
    x = rng.integers(-1, 2, size=(1, t, d)).astype(np.float32)
    r = rng.integers(-8, 9, size=(d, e)).astype(np.float32) / 8
    if case == "ties":
        r[:, 1::2] = r[:, 0::2]
    else:
        r[:, :2] = 0
        x[..., 0] = 1
        r[0, :2] = (64, 64)
    jl = dict(jl, router=jnp.asarray(r))
    lp = convert._tree(jax.tree.map(np.asarray, jl), "cpu")
    xt, jx = _bf16(x)
    cap = moe._capacity(t, cfg)
    assert cap == JMOE._capacity(t, jcfg) == 128
    want = _reference_routing(jl["router"], jx.reshape(t, d), jcfg, cap)
    _, _, _, idx = moe.route(lp, xt.reshape(t, d), cfg)
    order, _, _, keep, slot = moe.dispatch(idx, cap, e)
    for got, w in zip((idx, order, keep, slot), want):
        assert np.array_equal(got.numpy(), w)
    if case == "ties":
        assert (want[0][:, 0] % 2 == 0).all()       # the lower of a pair
        assert (want[0][:, 1] == want[0][:, 0] + 1).all()
    else:
        assert int((~want[2]).sum()) == 2 * (t - cap)
    y, aux = moe.apply(lp, xt, cfg)
    jy, jaux = JMOE.apply(jl, jx, jcfg)
    _close(y, jy, _moe_tol(jy))
    for k in ("lb_loss", "z_loss"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=AUX_RTOL)


def test_moe_combine_is_the_reference_scatter_add_order():
    """The combine against the reference's bf16 scatter-add
    (``zeros.at[token_of].add(contrib)``) on the same rows, bit for bit:
    rows of mixed magnitude, so the order of the adds shows in bf16;
    two calls give the same bits."""
    rng = np.random.default_rng(9)
    t, k, e, d = 24, 3, 8, 16
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    order = moe.dispatch(torch.as_tensor(idx), 128, e)[0]
    contrib = (rng.standard_normal((t * k, d))
               * 2.0 ** rng.integers(-8, 9, (t * k, 1)))
    ct, cj = _bf16(contrib)
    got = moe.combine(ct, order, t, k)
    assert torch.equal(got, moe.combine(ct, order, t, k))
    token_of = np.asarray(order) // k
    want = jnp.zeros((t, d), jnp.bfloat16).at[token_of].add(cj)
    assert np.array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_and_loss_match_reference(arch):
    jp, jcfg, p, cfg = _model(arch)
    assert len(p.get("dense_layers", ())) == cfg.first_dense
    assert len(p["layers"]) == cfg.n_layers - cfg.first_dense
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 19))
    jl, jc = JDEC.prefill_with_cache(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                     32)
    tl, tc = DEC.prefill_with_cache(p, {"tokens": torch.as_tensor(toks)},
                                    cfg, 32)
    _close(tl, jl, LOGIT_TOL)
    _close(tc["kv"]["k"], jc["kv"]["k"], LOGIT_TOL)
    _close(TF.forward_logits(p, {"tokens": torch.as_tensor(toks)}, cfg), jl,
           LOGIT_TOL)
    tok = rng.integers(0, cfg.vocab, (2, 1))
    pos = np.array([19, 19])
    jd, _ = JDEC.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jcfg)
    td, _ = DEC.decode_step(p, torch.as_tensor(tok), tc,
                            torch.as_tensor(pos), cfg)
    _close(td, jd, LOGIT_TOL)
    pk = {n: jc["kv"][n][:, :, :16] for n in ("k", "v")}
    jsl, jskv = JDEC.prefill_with_prefix(jp, jnp.asarray(toks[:, 16:]), pk,
                                         jcfg)
    tsl, tskv = DEC.prefill_with_prefix(
        p, torch.as_tensor(toks[:, 16:]),
        {n: torch.as_tensor(_f32(a)).to(torch.bfloat16)
         for n, a in pk.items()}, cfg)
    _close(tsl, jsl, LOGIT_TOL)
    _close(tskv["v"], jskv["v"], LOGIT_TOL)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jm = JTF.forward_loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tloss, tm = TF.forward_loss(
        p, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    assert tm["lb_loss"] > 0 and tm["z_loss"] > 0
    for got, want in ((tloss, jloss), (tm["lb_loss"], jm["lb_loss"]),
                      (tm["z_loss"], jm["z_loss"])):
        assert abs(float(got) - float(want)) <= LOGIT_TOL


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


def test_engine_tokens_match_reference():
    """deepseek-moe (leading dense layer, shared expert) served by both
    packages' CutieEngine + LLMExecutor, paged with prefix caching."""
    jp, jcfg, p, cfg = _model("deepseek_moe_16b")
    jex = JLLM(jp, jcfg, JServerConfig(**_KW))
    rows = _record_logits(jex)
    want, _, _, juids = _serve(JEngine, jex)
    got, ex, eng, _ = _serve(CutieEngine, LLMExecutor(p, cfg,
                                                      ServerConfig(**_KW)))
    for uid, g, w in zip(juids, got, want):
        assert len(g) == len(w) == _KW["max_new_tokens"]
        for j, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            top = np.sort(rows[uid][j][:cfg.vocab])[-2:]
            assert top[1] - top[0] <= 2 * LOGIT_TOL, \
                f"token {j} differs ({a} vs {b}) at margin {top[1] - top[0]}"
            break
    st = eng.stats()["paged_state"]["llm"]
    assert st["prefix_hit_rate"] > 0.5 and st["evictions"] == 0


def test_paged_identical_to_contiguous():
    _, _, p, cfg = _model("deepseek_moe_16b")
    out_c, _, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=False, **_KW)))
    out_p, ex, _, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=True, **_KW)))
    assert out_c == out_p
    st = ex.extra_stats()
    assert st["prefill_tokens_computed"] < st["prefill_tokens"]


def test_convert_checks_the_layer_stacks():
    jp, jcfg, _, cfg = _model("deepseek_moe_16b")
    tree = jax.tree.map(np.asarray, jp)
    assert tree["dense_layers"]["mlp"]["up"]["w_packed"].shape[0] == 1
    assert tree["layers"]["moe"]["gate_proj"].shape[1:] == (
        cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    with pytest.raises(ValueError, match="first_dense"):
        convert.llm_params_from_numpy(tree, cfg.replace(n_layers=3),
                                      device="cpu")
    with pytest.raises(ValueError, match="first_dense"):
        convert.llm_params_from_numpy(
            {k: v for k, v in tree.items() if k != "dense_layers"}, cfg,
            device="cpu")


# ---------------------------------------------------------------------------
# the full-size parameter trees, on the meta device
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_tree(arch, monkeypatch):
    """Every leaf's name, shape and dtype equal to ``jax.eval_shape`` of
    the reference's ``init_params`` (its stacked layer axes unstacked),
    allocating nothing."""
    from repro_torch.models import common as C

    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = jax.eval_shape(lambda k: JTF.init_params(jcfg, k),
                          jax.random.PRNGKey(0))

    class MetaGen:
        device = torch.device("meta")

    monkeypatch.setattr(C, "_normal", lambda gen, shape: torch.empty(
        tuple(shape), device="meta"))
    got = dict(_flatten(TF.init_params(cfg, MetaGen())))
    n = 0
    for path, leaf in _flatten(want):
        stack, rest = path.split("/", 1) if "/" in path else (path, "")
        if stack in TF.LAYER_LISTS:
            for i in range(leaf.shape[0]):
                t = got[f"{stack}/{i}/{rest}"]
                assert tuple(t.shape) == tuple(leaf.shape[1:]), path
                assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
                n += 1
        else:
            assert tuple(got[path].shape) == tuple(leaf.shape), path
            n += 1
    assert n == len(got)
