"""The port's vlm family (llava-next-mistral-7b: precomputed patch
embeddings through a 2-layer bf16 projector, prepended to the text of a
mistral-style dense backbone) against the JAX reference, on the CPU at
the reduced config (`reduce_for_smoke`: 2 layers, d_model 64, 8 image
tokens of width 32), the ``launch.train`` CLI for the encdec and vlm
families, and the full-size parameter trees of the hybrid, encdec and
vlm configs (on the meta device).

Parameters are the reference's ``init_params`` carried across with
`repro_torch.convert.llm_params_from_numpy`; inputs come from numpy
seeds.  The reference serves vlm as a text-only attention family
(`LLMExecutor`, `SpecExecutor`), and so does the port.

Tolerances, stated once:

* the projector, logits, cache rows: within ``LOGIT_TOL``
  (tests/test_torch_llm.py's rule: bf16 rounded at the same places, f32
  sums in other orders);
* losses within ``LOSS_TOL`` (tests/test_torch_llm_train.py's);
* gradients of ``forward_loss`` (``ternary``): each leaf's relative L2
  error within ``GRAD_RTOL``, or within twice the reference's own spread
  under a one-ulp nudge of half its embedding
  (tests/test_torch_hybrid.py's `check_gradients`; measured 0.022);
* engine-served and speculative greedy tokens: equal, except where the
  compared serve's own top-2 logit margin at the first differing step is
  within 2 x ``LOGIT_TOL`` (tests/test_torch_spec.py's rule);
* the training CLI's ``frames`` and ``patches``: bit for bit with the
  reference's ``data_fn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import train as jlaunch_train
from repro.models import common as JC
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import CutieEngine as JEngine
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro_torch import configs, convert
from repro_torch.launch import train as launch_train
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import (CutieEngine, LLMExecutor, ServerConfig,
                                 SpecExecutor)
from test_torch_hybrid import GRAD_RTOL, check_gradients

ARCH = "llava_next_mistral_7b"
LOGIT_TOL = 2.0 ** -4
LOSS_TOL = 2.0 ** -6
QUANTS = ("none", "ternary", "ternary_packed")
BLOCK = 8
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(4)]
_KW = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=BLOCK)

_MODELS: dict = {}


def _model(quant="ternary_packed"):
    """Both packages' reduced configs and params (the reference's init);
    attn_kv_chunk = block_size keeps paged == contiguous exact."""
    if quant not in _MODELS:
        kw = dict(quant=quant, attn_kv_chunk=BLOCK)
        jcfg = jreduce(jconfigs.get(ARCH)).replace(**kw)
        cfg = reduce_for_smoke(configs.get(ARCH)).replace(**kw)
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


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "patches": rng.normal(size=(b, cfg.img_tokens, cfg.d_vision))
            .astype(np.float32)}


# ---------------------------------------------------------------------------
# config, parameters, projector
# ---------------------------------------------------------------------------


def test_config_and_reduced_config_are_the_reference_ones():
    assert dataclasses.asdict(configs.get("llava-next-mistral-7b")) == \
        dataclasses.asdict(jconfigs.get(ARCH))
    cfg = reduce_for_smoke(configs.get(ARCH))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreduce(jconfigs.get(ARCH)))
    assert (cfg.img_tokens, cfg.d_vision) == (8, 32)
    assert set(configs.registry()) == set(jconfigs.ARCH_IDS)


def test_projector_is_plain_bf16_and_matches_reference():
    jp, _, p, cfg = _model()
    fc1 = p["mm_proj"]["fc1"]
    assert set(fc1) == {"w"} and fc1["w"].dtype == torch.bfloat16
    assert tuple(fc1["w"].shape) == (cfg.d_vision, cfg.d_model)
    assert np.array_equal(_f32(fc1["w"]), _f32(jp["mm_proj"]["fc1"]["w"]))
    patches = _batch(cfg)["patches"]
    got = TF.project_patches(p, torch.as_tensor(patches))
    img = JC.linear(jp["mm_proj"]["fc1"], jnp.asarray(patches, jnp.bfloat16))
    want = JC.linear(jp["mm_proj"]["fc2"], jax.nn.gelu(img))
    assert got.dtype == torch.bfloat16
    _close(got, want, LOGIT_TOL)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", QUANTS)
def test_forward_loss_and_logits_match_reference(quant):
    """`forward_loss` with patches (the loss on text positions only) and
    `forward_logits`, which reads the tokens only, as the reference's."""
    jp, jcfg, p, cfg = _model(quant)
    batch = _batch(cfg)
    loss, m = TF.forward_loss(p, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, cfg)
    jloss, jm = jax.jit(lambda q, b: JTF.forward_loss(q, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert float(m["tokens"]) == float(jm["tokens"]) == \
        batch["tokens"].size
    toks = {"tokens": torch.as_tensor(batch["tokens"])}
    lg = TF.forward_logits(p, dict(toks, patches=torch.zeros(1)), cfg)
    jlg = JTF.forward_logits(jp, {"tokens": jnp.asarray(batch["tokens"])},
                             jcfg)
    _close(lg, jlg, LOGIT_TOL)
    assert torch.equal(lg, TF.forward_logits(p, toks, cfg))


def test_forward_loss_gradients_match_reference():
    """tests/test_torch_hybrid.py's `check_gradients` rule, the
    projector's leaves included."""
    jp, jcfg, _, cfg = _model("ternary")
    n, worst, _ = check_gradients(jp, jcfg, cfg, _batch(cfg, seed=5))
    # embed, head, ln_f, the projector's two weights, the stacked layers'
    # 9 leaves
    assert n == 1 + 1 + 1 + 2 + 9
    assert worst <= GRAD_RTOL


def test_prefill_decode_and_prefix_prefill_match_reference():
    jp, jcfg, p, cfg = _model()
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 19))
    lg, caches = DEC.prefill_with_cache(
        p, {"tokens": torch.as_tensor(toks)}, cfg, 32)
    jlg, jc = JDEC.prefill_with_cache(jp, {"tokens": jnp.asarray(toks)},
                                      jcfg, 32)
    _close(lg, jlg, LOGIT_TOL)
    for k in ("k", "v"):
        _close(caches["kv"][k], jc["kv"][k], LOGIT_TOL)
    nxt = np.array([[5], [7]])
    pos = np.full((2,), 19)
    lg, caches = DEC.decode_step(p, torch.as_tensor(nxt), caches,
                                 torch.as_tensor(pos), cfg)
    jlg, jc = JDEC.decode_step(jp, jnp.asarray(nxt), jc,
                               jnp.asarray(pos, jnp.int32), jcfg)
    _close(lg, jlg, LOGIT_TOL)
    c = BLOCK
    pre = {k: v[:, :, :c] for k, v in caches["kv"].items()}
    jpre = {k: v[:, :, :c] for k, v in jc["kv"].items()}
    lg, kv = DEC.prefill_with_prefix(p, torch.as_tensor(toks[:, c:]), pre,
                                     cfg)
    jlg, jkv = JDEC.prefill_with_prefix(jp, jnp.asarray(toks[:, c:]), jpre,
                                        jcfg)
    _close(lg, jlg, LOGIT_TOL)
    for k in ("k", "v"):
        _close(kv[k], jkv[k], LOGIT_TOL)


# ---------------------------------------------------------------------------
# serving (text only, as the reference serves vlm)
# ---------------------------------------------------------------------------


def _record_rows(ex, vocab) -> dict:
    """Per request uid, the logits row of every token an executor samples
    (prefill, then each decode step)."""
    rows: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        lg32 = _f32(lg)[:, :vocab]
        if admitting:
            rows.setdefault(admitting.pop(), []).append(lg32[0])
        else:
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(lg32[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


def _serve(engine_cls, ex, prompts=_PROMPTS):
    eng = engine_cls("fcfs")
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    out = eng.run()
    return [out[h.uid] for h in hs], [h.uid for h in hs]


def _margin_rule(got, want, rows):
    """Tokens equal up to the first difference, which must sit at a top-2
    margin of at most 2 x LOGIT_TOL of the compared serve's row."""
    for g, w, r in zip(got, want, rows):
        assert len(g) == len(w)
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                top = np.sort(r[j])[-2:]
                assert top[1] - top[0] <= 2 * LOGIT_TOL, (j, a, b)
                break


def test_engine_tokens_match_reference_and_paged_equals_contiguous():
    jp, jcfg, p, cfg = _model()
    jex = JLLM(jp, jcfg, JServerConfig(**_KW))
    rows = _record_rows(jex, cfg.vocab)
    want, juids = _serve(JEngine, jex)
    got, _ = _serve(CutieEngine, LLMExecutor(p, cfg, ServerConfig(**_KW)))
    _margin_rule(got, want, [rows[u] for u in juids])
    contiguous, _ = _serve(CutieEngine, LLMExecutor(
        p, cfg, ServerConfig(paged=False, **_KW)))
    assert contiguous == got


def test_spec_serve_with_vlm_target_and_draft():
    """A self-draft runs the attention path of both workers; greedy tokens
    follow the port's plain serve under the margin rule."""
    _, _, p, cfg = _model()
    ex = LLMExecutor(p, cfg, ServerConfig(**_KW))
    rows = _record_rows(ex, cfg.vocab)
    plain, uids = _serve(CutieEngine, ex)
    spec = SpecExecutor(p, cfg, ServerConfig(**_KW), p, cfg)
    got, _ = _serve(CutieEngine, spec)
    _margin_rule(got, plain, [rows[u] for u in uids])
    assert spec.extra_stats()["spec"]["verify_steps"] > 0


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def _data_fn(module, monkeypatch, argv):
    """The ``data_fn`` a launch module's ``main`` hands its training loop
    (the loop itself is not run)."""
    seen = {}

    def train(loss_fn, params, data_fn, *a, **kw):
        seen["data_fn"] = data_fn
        return {"history": [{"step": 0, "loss": 0.0}],
                "restored_from": None, "stragglers": []}

    monkeypatch.setattr(module.loop, "train", train)
    module.main(argv)
    return seen["data_fn"]


@pytest.mark.parametrize("arch,stub", [("llava-next-mistral-7b", "patches"),
                                       ("whisper-medium", "frames")])
def test_launch_train_data_is_the_reference_data(arch, stub, monkeypatch):
    argv = ["--arch", arch, "--steps", "2", "--seq", "16", "--batch", "2"]
    with monkeypatch.context() as m:
        jfn = _data_fn(jlaunch_train, m, argv + ["--mesh", "none"])
    with monkeypatch.context() as m:
        fn = _data_fn(launch_train, m, argv + ["--device", "cpu"])
    for step in (0, 1):
        got, want = fn(step), jfn(step)
        assert set(got) == set(want) == {"tokens", "labels", stub}
        assert got[stub].dtype == torch.float32
        assert np.array_equal(got[stub].numpy(), np.asarray(want[stub]))
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    if stub == "patches":
        cfg = reduce_for_smoke(configs.get(arch))
        assert got["tokens"].shape == (2, 16 - cfg.img_tokens)


def test_launch_train_runs_vlm_on_cpu(capsys):
    res = launch_train.main(["--device", "cpu", "--arch",
                             "llava-next-mistral-7b", "--steps", "2",
                             "--quant", "ternary", "--seq", "16", "--batch",
                             "2", "--log-every", "1"])
    assert [r["step"] for r in res["history"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in res["history"])
    assert "final: step=1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the full-size parameter trees of the three families, on the meta device
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "whisper_medium", ARCH])
def test_full_size_parameter_tree(arch, monkeypatch):
    """Every leaf's name, shape and dtype equal to ``jax.eval_shape`` of
    the reference's ``init_params`` (its stacked layer axes unstacked),
    allocating nothing; whisper's ``dec_pos`` is None in both."""
    from repro_torch.models import common as C

    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    want = jax.eval_shape(lambda k: JTF.init_params(jcfg, k),
                          jax.random.PRNGKey(0))

    class MetaGen:
        device = torch.device("meta")

    monkeypatch.setattr(C, "_normal", lambda gen, shape: torch.empty(
        tuple(shape), device="meta"))
    tree = TF.init_params(cfg, MetaGen())
    assert ("dec_pos" in tree) == (cfg.family == "encdec")
    assert tree.get("dec_pos") is None
    got = dict(_flatten(tree))
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
            assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype)
            n += 1
    assert n == len(got)
