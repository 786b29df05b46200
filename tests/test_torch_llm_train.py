"""The port's LLM training path against the JAX reference: the chunked
cross-entropy, ``forward_loss`` (quant ``none`` and ``ternary``, the two
bf16 execution flags on and off), the synthetic token pipeline, the
training loop (plain, INQ, ternary gradient compression), its
checkpointed preempt-and-resume, and the ``launch.train`` CLI, at the
reduced llama3.2-1B config.

Parameters are drawn by the reference's ``init_params`` and carried
across with `convert.llm_params_from_numpy`; inputs come from a numpy
seed.  Tolerances: the f32 cross-entropy within rtol 1e-5; losses of
bf16 models within ``LOSS_TOL`` = 2**-6 (the two packages round bf16
activations at the same places and sum f32 in other orders); the QAT
trits of bf16 weights bit for bit (their TWN sums accumulate in f32, as
XLA's do).  After a training step the losses are held within
``STEP_TOL`` = 2**-4 (about 1% of the loss): Adam's first updates are
``lr * sign(g)``, and 0.1-0.4% of the bf16 gradient entries lie within
rounding of zero and take the other sign in the other package (the
step-0 gradients agree within 0.7% of each leaf's largest).  A preempted
and resumed run on the CPU equals an uninterrupted one bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import inq as jinq
from repro.core import ternary as JT
from repro.data import tokens as jtokens
from repro.models import attention as JATT
from repro.models import common as JC
from repro.models import losses as jlosses
from repro.models import transformer as JTF
from repro.models.config import ShapeSpec as JShapeSpec
from repro.models.config import reduce_for_smoke as jreduce
from repro.optim import adam as jadam
from repro.train import loop as jloop
from repro_torch import configs, convert
from repro_torch.core import inq
from repro_torch.core import ternary as T
from repro_torch.data import tokens
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as ATT
from repro_torch.models import common as C
from repro_torch.models import losses
from repro_torch.models import transformer as TF
from repro_torch.models.config import ShapeSpec, reduce_for_smoke
from repro_torch.optim import adam
from repro_torch.train import loop

LOSS_TOL, STEP_TOL = 2.0 ** -6, 2.0 ** -4
SEQ, BATCH = 32, 4


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@functools.cache
def _model(quant="ternary", **flags):
    kw = dict(n_layers=2, quant=quant, **flags)
    jcfg = jreduce(jconfigs.get("llama3_2_1b")).replace(**kw)
    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(**kw)
    jp = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jcfg, cfg


def _port_params(jp, cfg):
    """The reference's tree as the port's training params (layers
    stacked, as the reference keeps them)."""
    return TF.stack_layers(convert.llm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))


def _batch(vocab, step=0):
    src = tokens.for_arch(reduce_for_smoke(configs.get("llama3.2-1b")),
                          ShapeSpec("t", SEQ, BATCH, "train"))
    b = src.batch(step)
    return b, {k: torch.as_tensor(v, dtype=torch.int64)
               for k, v in b.items()}


# ---------------------------------------------------------------------------
# the loss, the flags and the QAT quantizer
# ---------------------------------------------------------------------------


def test_chunked_xent_matches_reference():
    """f32 hidden and head, a mask and a ragged tail (37 positions in
    chunks of 16)."""
    rng = np.random.default_rng(0)
    b, s, d, v = 3, 37, 24, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got, cnt = losses.chunked_xent(
            torch.tensor(x), torch.tensor(w), torch.tensor(labels), chunk=16,
            mask=None if m is None else torch.tensor(m))
        want, jcnt = jlosses.chunked_xent(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels, jnp.int32),
            chunk=16, mask=None if m is None else jnp.asarray(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(cnt) == float(jcnt)


def test_chunked_xent_gradient_matches_unchunked():
    """The checkpointed chunk loop's gradients equal one unchunked pass."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 40, 8)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.standard_normal((8, 30)), dtype=torch.float32,
                     requires_grad=True)
    labels = torch.tensor(rng.integers(0, 30, (2, 40)))
    grads = []
    for chunk in (16, 40):
        loss, _ = losses.chunked_xent(x, w, labels, chunk=chunk)
        grads.append(torch.autograd.grad(loss, (x, w)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_bf16_ternarize_ste_bit_identical():
    """QAT trits and scales of bf16 weights: the TWN sums accumulate in
    f32 and round to bf16 at each op, as the reference's under XLA."""
    rng = np.random.default_rng(2)
    for shape in ((64, 128), (2048, 96), (100, 37)):
        w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
        got = T.ternarize_ste(torch.tensor(w).to(torch.bfloat16), axis=(0,))
        want = JT.ternarize_ste(jnp.asarray(w, jnp.bfloat16), axis=(0,))
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_f32(got), _f32(want))


def test_flag_attention_and_rmsnorm_match_reference():
    """``attn_bf16_scores``: bf16 score tiles with f32 m/l; and
    ``norm_bf16_mul``: an f32 reduction, the normalize in bf16."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 40, 4, 16)) for _ in range(3))

    def both(a):
        return (torch.tensor(a, dtype=torch.float32).to(torch.bfloat16),
                jnp.asarray(a, jnp.bfloat16))

    (qt, qj), (kt, kj), (vt, vj) = both(q), both(k), both(v)
    for flag in (False, True):
        got = ATT.flash_attention(qt, kt, vt, q_chunk=16, kv_chunk=16,
                                  q_offset=3, bf16_scores=flag)
        want = JATT.flash_attention(qj, kj, vj, causal=True, q_chunk=16,
                                    kv_chunk=16, q_offset=3,
                                    bf16_scores=flag)
        assert got.dtype == torch.bfloat16
        assert np.abs(_f32(got) - _f32(want)).max() <= 2.0 ** -6
    x = rng.standard_normal((3, 5, 64)) * 3
    scale = rng.standard_normal(64)
    (xt, xj), (st, sj) = both(x), both(scale)
    for flag in (False, True):
        got = C.rmsnorm({"scale": st}, xt, bf16_mul=flag)
        want = JC.rmsnorm({"scale": sj}, xj, bf16_mul=flag)
        assert got.dtype == torch.bfloat16
        assert np.abs(_f32(got) - _f32(want)).max() <= \
            2.0 ** -7 * np.abs(_f32(want)).max()


@pytest.mark.parametrize("flags", [
    {}, {"attn_bf16_scores": True, "norm_bf16_mul": True}])
@pytest.mark.parametrize("quant", ["none", "ternary"])
def test_forward_loss_matches_reference(quant, flags):
    jp, jcfg, cfg = _model(quant, **flags)
    p = TF.unstack_layers(_port_params(jp, cfg))
    b, bt = _batch(cfg.vocab)
    loss, m = TF.forward_loss(p, bt, cfg)
    jloss, jm = JTF.forward_loss(jp, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jcfg)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    assert abs(float(m["xent"]) - float(jm["xent"])) <= LOSS_TOL
    assert float(m["tokens"]) == float(jm["tokens"]) == SEQ * BATCH
    assert float(m["lb_loss"]) == float(m["z_loss"]) == 0.0


def test_remat_keeps_loss_and_gradients():
    """``cfg.remat`` checkpoints each block: the loss and the gradients
    are those without it, bit for bit."""
    jp, _, cfg = _model("ternary")
    _, bt = _batch(cfg.vocab)
    outs = []
    for remat in ("none", "full", "block"):
        p = _port_params(jp, cfg)
        leaves = [p["embed"], p["layers"]["mlp"]["up"]["w"]]
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = TF.forward_loss(TF.unstack_layers(p), bt,
                                  cfg.replace(remat=remat))
        outs.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for a, b in zip(grads, outs[0][1]):
            assert torch.equal(a, b)


def test_forward_loss_unported_families_name_item_10():
    """The three families item 10 waited for run `forward_loss` (held
    against the reference in tests/test_torch_{hybrid,encdec,vlm}.py):
    each reduced config gives a finite loss on its own inputs; the vlm
    family's dense backbone on the llama parameters gives the dense loss
    when its image is empty, and an unknown family is refused."""
    _, _, cfg = _model("none")
    p = TF.unstack_layers(_port_params(_model("none")[0], cfg))
    b, bt = _batch(cfg.vocab)
    gen = torch.Generator()
    gen.manual_seed(0)
    for arch in ("zamba2-2.7b", "whisper-medium", "llava-next-mistral-7b"):
        rcfg = reduce_for_smoke(configs.get(arch))
        rng = np.random.default_rng(0)
        batch = dict(bt)
        if rcfg.family == "encdec":
            batch["frames"] = torch.as_tensor(rng.normal(size=(
                BATCH, rcfg.enc_seq, rcfg.d_model)), dtype=torch.float32)
        if rcfg.family == "vlm":
            batch["patches"] = torch.as_tensor(rng.normal(size=(
                BATCH, rcfg.img_tokens, rcfg.d_vision)), dtype=torch.float32)
        loss, m = TF.forward_loss(TF.init_params(rcfg, gen), batch, rcfg)
        assert np.isfinite(float(loss)) and float(m["tokens"]) == SEQ * BATCH
    vcfg = cfg.replace(family="vlm", d_vision=8)
    vp = dict(p, mm_proj={"fc1": {"w": torch.zeros(8, cfg.d_model,
                                                   dtype=torch.bfloat16)},
                          "fc2": {"w": torch.zeros(cfg.d_model, cfg.d_model,
                                                   dtype=torch.bfloat16)}})
    loss, _ = TF.forward_loss(vp, dict(bt, patches=torch.zeros(BATCH, 0, 8)),
                              vcfg)
    assert torch.equal(loss, TF.forward_loss(p, bt, cfg)[0])
    with pytest.raises(ValueError):
        TF.forward_loss(p, bt, cfg.replace(family="rnn"))


def test_synthetic_tokens_bit_identical():
    for arch, seq, batch, seed in (("llama3_2_1b", 64, 3, 0),
                                   ("qwen2_5_32b", 17, 2, 5)):
        jcfg = jconfigs.get(arch)
        cfg = configs.get(arch)
        src = tokens.for_arch(cfg, ShapeSpec("t", seq, batch, "train"),
                              seed=seed)
        jsrc = jtokens.for_arch(jcfg, JShapeSpec("t", seq, batch, "train"),
                                seed=seed)
        for step in (0, 1, 7):
            got, want = src.batch(step), jsrc.batch(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
        assert np.array_equal(src.batch_slice(3, 1, 2)["tokens"],
                              jsrc.batch_slice(3, 1, 2)["tokens"])


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

_SETTINGS = {
    "plain": {},
    "inq": {"inq": "default"},
    "ternary_grads": {"grad_compress": "ternary"},
}


def _loop_cfgs(setting, steps, **kw):
    extra = dict(_SETTINGS[setting])
    jkw, kw2 = dict(kw, **extra), dict(kw, **extra)
    if "inq" in extra:
        jkw["inq"], kw2["inq"] = jinq.INQConfig(), inq.INQConfig()
    return (jloop.TrainLoopConfig(total_steps=steps, log_every=1, **jkw),
            loop.TrainLoopConfig(total_steps=steps, log_every=1, **kw2))


def _port_train(cfg, params, tcfg, steps):
    src = tokens.for_arch(cfg, ShapeSpec("t", SEQ, BATCH, "train"))

    def data_fn(step):
        return {k: torch.as_tensor(v, dtype=torch.int64)
                for k, v in src.batch(step).items()}

    return loop.train(
        lambda p, b: TF.forward_loss(TF.unstack_layers(p), b, cfg), params,
        data_fn, tcfg, adam.AdamConfig(total_steps=steps, warmup_steps=1))


@pytest.mark.parametrize("setting", sorted(_SETTINGS))
def test_three_train_steps_match_reference(setting):
    jp, jcfg, cfg = _model("ternary")
    jtcfg, tcfg = _loop_cfgs(setting, 3)
    jsrc = jtokens.for_arch(jcfg, JShapeSpec("t", SEQ, BATCH, "train"))
    own = jax.tree.map(lambda a: jnp.array(a, copy=True), jp)  # donated
    want = jloop.train(lambda p, b: JTF.forward_loss(p, b, jcfg), own,
                       jsrc.batch, jtcfg,
                       jadam.AdamConfig(total_steps=3, warmup_steps=1))
    got = _port_train(cfg, _port_params(jp, cfg), tcfg, 3)
    assert [r["step"] for r in got["history"]] == [0, 1, 2]
    for g, w in zip(got["history"], want["history"]):
        tol = LOSS_TOL if g["step"] == 0 else STEP_TOL
        assert abs(g["loss"] - w["loss"]) <= tol, (g, w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=2e-2)
        if setting == "ternary_grads":
            assert abs(g["grad_sparsity"] - w["grad_sparsity"]) <= 2e-2
        if setting == "inq":
            assert g["inq_frac"] == w["inq_frac"]
    if setting == "inq":             # the schedule reaches 1.0 at step 2
        assert inq.frozen_fraction(got["inq_state"]) == 1.0
        st = got["inq_state"]["layers"]["attn"]["wq"]["w"]
        eff = inq.apply(st, got["params"]["layers"]["attn"]["wq"]["w"])
        assert torch.equal(eff, st["q"])


@pytest.mark.parametrize("setting", ["plain", "inq"])
def test_preempt_and_resume_bit_identical(setting, tmp_path):
    _, _, cfg = _model("ternary")
    jp = _model("ternary")[0]
    steps = 6
    _, full_cfg = _loop_cfgs(setting, steps)
    full = _port_train(cfg, _port_params(jp, cfg), full_cfg, steps)
    _, cut = _loop_cfgs(setting, steps, ckpt_dir=str(tmp_path),
                        ckpt_every=3, fail_at_step=4)
    with pytest.raises(loop.PreemptionError, match="step 4"):
        _port_train(cfg, _port_params(jp, cfg), cut, steps)
    _, resume = _loop_cfgs(setting, steps, ckpt_dir=str(tmp_path),
                           ckpt_every=3)
    res = _port_train(cfg, _port_params(jp, cfg), resume, steps)
    assert res["restored_from"] == 3
    assert [r["step"] for r in res["history"]] == [4, 5]
    for g, w in zip(res["history"], full["history"][4:]):
        assert {k: v for k, v in g.items() if k != "dt_s"} == \
            {k: v for k, v in w.items() if k != "dt_s"}
    for a, b in zip(loop._leaves(res["params"]),
                    loop._leaves(full["params"])):
        assert torch.equal(a, b)


class _OneRankOfTwo:
    """Rank 0's view of a ``data:2`` mesh, without a process group: the
    loop shards its params before it draws a batch."""
    axis_names, shape, size, device = ("data",), {"data": 2}, 2, "cpu"

    def coord(self, axis):
        return 0

    def axis_size(self, axis):
        return self.shape.get(axis, 1)


@pytest.mark.parametrize("kw,cfg_kw", [({"mesh": _OneRankOfTwo()}, {}),
                                       ({"pspecs": {}}, {}),
                                       ({}, {"elastic": False})],
                         ids=["mesh", "pspecs", "elastic"])
def test_loop_refuses_a_mesh(kw, cfg_kw, tmp_path):
    """The mesh loop's refusals (tests/test_torch_model_mesh.py trains on
    real meshes): a batch whose rows do not divide the data shards (it
    would count twice in the global token mean), specs without a mesh.
    ``elastic=False`` without a mesh is the reference's plain restore."""
    params = {"w": torch.ones((4, 2))}

    def loss_fn(p, batch):
        return (p["w"] * batch["x"].sum()).sum(), {}

    def data_fn(step):
        return {"x": torch.ones((3, 2))}

    if "elastic" in cfg_kw:
        tcfg = loop.TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                                    ckpt_every=1, **cfg_kw)
        loop.train(loss_fn, params, data_fn, tcfg)
        res = loop.train(loss_fn, params, data_fn, loop.TrainLoopConfig(
            total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=1, **cfg_kw))
        assert res["restored_from"] == 1
        return
    with pytest.raises(ValueError, match="data shards|without a mesh"):
        loop.train(loss_fn, params, data_fn,
                   loop.TrainLoopConfig(total_steps=1, **cfg_kw), **kw)


def test_launch_train_cli(tmp_path, capsys):
    hist = tmp_path / "h.jsonl"
    res = launch_train.main(["--device", "cpu", "--steps", "3",
                             "--quant", "ternary", "--seq", "16",
                             "--batch", "2", "--log-every", "1",
                             "--history", str(hist)])
    assert [r["step"] for r in res["history"]] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["history"])
    assert len(hist.read_text().splitlines()) == 3
    assert "final: step=2" in capsys.readouterr().out
    # the encdec family trains through the CLI (its frames drawn as the
    # reference's: tests/test_torch_vlm.py)
    res = launch_train.main(["--device", "cpu", "--arch", "whisper-medium",
                             "--steps", "1", "--seq", "16", "--batch", "2"])
    assert [r["step"] for r in res["history"]] == [0]
    assert np.isfinite(res["history"][0]["loss"])
