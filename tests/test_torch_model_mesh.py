"""The port's LLM model mesh (`repro_torch.launch.mesh`, `shardings`,
`steps`, `roofline`) against the reference's, on gloo in spawned CPU
processes.

Three worlds, of 1, 4 and 8 ranks, each spawned once per module: one
process per mesh position, a gloo group initialized from a file under
``tmp_path``, the rank side `model_rank_main` in
`tests/torch_mesh_ranks.py` (it imports no ``jax``).  The reference's
parameters (test_distribution.py's reduced llama3.2-1B: 2 layers,
d_model 64, 4 heads / 2 kv, d_head 16, vocab 256; test_moe_ep.py's
reduced qwen3-moe layer at capacity 8.0) are exported with ``np.savez``.

What is held, and to what:

* placement specs leaf by leaf (`param_specs`, `zero1_specs`,
  `fit_named`) and `count_params`: equal to the reference's;
* the meshed train step: bit for bit the unmeshed port's on a world of
  one; on data:2,model:2 and data:2,model:4 the loss within
  ``LOSS_TOL`` = 2**-6 of the unmeshed port's and of the reference's
  step under its (2, 4) host mesh, the params after two steps within
  ``PARAM_TOL`` (measured: 2**-10, one bf16 ulp of an entry below 0.25)
  of the unmeshed port's; on data:2,model:4 the params after each step
  also within ``PARAM_TOL`` of the reference's, with at most
  ``REF_STEP_SHARE`` of each leaf's entries beyond the largest lr plus
  one bf16 ulp;
* the ``ternary_packed`` decode cell (prefill + teacher-forced decode
  steps, the KV cache's sequence over ``model``): bit for bit on a
  world of one; else each logit within ``MESH_ULPS`` = 4 bf16 ulps of
  its row's largest |logit| of the unmeshed port's (measured: at most
  2 ulps), and within ``LOGIT_TOL`` = 2**-4 of the reference's unmeshed
  ``decode_step`` (test_torch_llm.py's tolerance);
* elastic restore bit for bit; a preempted `train(mesh=)` restarted on
  another mesh continuing to the uninterrupted run's losses within
  ``LOSS_TOL``; an INQ run with ternary gradient compression on (2, 2)
  against the same run unmeshed: losses within ``LOSS_TOL``, gradient
  sparsities within ``SPARSITY_TOL``, at most ``MASK_DIFF_SHARE`` of the
  frozen masks' entries other, params within ``PARAM_TOL``;
* expert parallelism against the dense dispatch at the reference test's
  tolerances (rtol 2e-2 / atol 2e-3, gradients' relative L2 error below
  2e-2, ``lb_loss`` rtol 0.1);
* the ssm, hybrid and encdec families (reduced mamba2-780m, zamba2-2.7b
  and whisper-medium, the reference's params) on model:2 (a world of 2)
  and data:2,model:2: `build_cell`'s prefill and decode steps (whisper's
  cross cache from the meshed encoder) within ``FAMILY_LOGIT_TOL`` of
  the reference's unmeshed ``forward_logits`` and ``decode_step``; bit
  for bit the unmeshed port on a world of one, else each logit within
  ``FAMILY_MESH_ULPS`` of it, and on every mesh bit for bit the
  unmeshed model whose row-cut projections sum the ranks' bf16 partial
  products (`chip_smoke.row_partials`: the one rounding the mesh adds);
  one meshed ``ternary`` train step within ``PARAM_TOL`` of the
  unmeshed port's step (measured: 2**-10), its loss within ``LOSS_TOL``
  of the reference's step and its params within ``PARAM_TOL`` of them,
  with at most ``REF_STEP_SHARE`` of all entries beyond the lr plus one
  bf16 ulp (measured: 0.73%, zamba2; one entry of a 64-entry bias is
  1.6%, so the share is not per leaf here); the SSM state cut on heads
  and ``conv_x`` on channels, out_proj's packed rows sharded and
  misaligned (13 of 26 a rank at d_inner 128), a whisper ``enc_seq`` of
  15 (a replicated cross cache), two B/C groups on model:2, and on
  model:8 heads that do not divide the axis (every rank computes all
  4).

The reference is imported only inside this process's fixtures, so the
spawned ranks, which import `torch_mesh_ranks`, never load it.
"""

import functools

import numpy as np
import pytest

import torch_mesh_ranks as R

LOSS_TOL, PARAM_TOL, LOGIT_TOL, MESH_ULPS = 2.0 ** -6, 2.0 ** -10, \
    2.0 ** -4, 4
# the ssm, hybrid and encdec cells (reference params, |logit| up to 4):
# logits against the reference's unmeshed run within FAMILY_LOGIT_TOL
# (measured: whisper 0.045; mamba2 0.068 meshed, 0.083 the unmeshed port
# itself on the two-group model; zamba2 0.104 meshed, 0.086 unmeshed,
# whose own parity test, tests/test_torch_hybrid.py, holds 2**-1), and
# against the unmeshed port within FAMILY_MESH_ULPS bf16 ulps of a row's
# largest |logit| (measured: at most 2.375 for mamba2 and whisper, 4.125
# for zamba2's decode on model:2; bit for bit the run with the ranks'
# bf16 row partials, which is the tight check)
FAMILY_LOGIT_TOL = {"ssm": 2.0 ** -3, "hybrid": 2.0 ** -2,
                    "encdec": LOGIT_TOL}
FAMILY_MESH_ULPS = {"ssm": MESH_ULPS, "hybrid": 2 * MESH_ULPS,
                    "encdec": MESH_ULPS}
MOE_ULPS = 2               # tests/test_torch_moe.py's
# INQ + ternary gradients on (2, 2) against the unmeshed run (measured:
# gradient sparsities within 1.1e-3, 6.6e-5 of the masks' entries
# frozen otherwise, params within 2**-10)
SPARSITY_TOL, MASK_DIFF_SHARE = 2e-3, 1e-3
# the meshed step's params against the reference's (2, 4) step: at most
# this share of a leaf's entries further apart than the largest lr plus
# a bf16 ulp (measured: up to 0.37% after each step).  Adam's first
# updates are lr * sign(g), and entries of g within rounding of 0 take
# the other sign; a smaller difference (up to 0.70% of the entries are
# more than an ulp apart) is the later steps' continuous change at
# entries near 0, whose ulp is small.
REF_STEP_SHARE = 0.01
SEQ, BATCH = 32, 4
ARCHS = ["whisper_medium", "mamba2_780m", "internlm2_1_8b", "llama3_2_1b",
         "codeqwen1_5_7b", "qwen2_5_32b", "deepseek_moe_16b",
         "qwen3_moe_30b_a3b", "zamba2_2_7b", "llava_next_mistral_7b"]

MODELS = {
    "train": ("llama3_2_1b", {"n_layers": 2, "quant": "ternary"}),
    # wo's packed rows: 26 at K = 128, split 13 | 13 on model:2, which
    # cover K [0, 65) and [65, 128) against 64-wide head slices
    "wide": ("llama3_2_1b", {"n_layers": 2, "n_heads": 8, "n_kv": 2,
                             "quant": "ternary_packed"}),
    # 13 packed rows at K = 64: replicated on model:2 and model:4
    "narrow": ("llama3_2_1b", {"n_layers": 2, "quant": "ternary_packed"}),
    # 6 heads on model:4: every rank attends for all of them (the
    # reference's "seq" mode); wo's 20 packed rows split 5 a rank
    "odd": ("llama3_2_1b", {"n_layers": 2, "n_heads": 6, "n_kv": 2,
                            "quant": "ternary_packed"}),
    "moe": ("qwen3_moe_30b_a3b", {"capacity_factor": 8.0}),
    "ssm": ("mamba2_780m", {"n_layers": 2}),
}

#: the ssm, hybrid and encdec families on a model axis (seeded params)
FAMILY_MODELS = {
    # out_proj: 26 packed rows at d_inner 128, 13 a rank on model:2,
    # covering K [0, 65) and [65, 128) against 64-wide head slices
    "ssm_tp": ("mamba2_780m", {"n_layers": 2, "quant": "ternary_packed"}),
    "hybrid_tp": ("zamba2_2_7b", {"quant": "ternary_packed"}),
    "encdec_tp": ("whisper_medium", {"quant": "ternary_packed"}),
    # 15 frames: the cross cache does not split over model:2
    "encdec_odd": ("whisper_medium", {"quant": "ternary_packed",
                                      "enc_seq": 15}),
    "ssm_g2": ("mamba2_780m", {"n_layers": 2, "quant": "ternary_packed",
                               "n_groups": 2}),
    # 4 heads of 32: model:8 does not divide them
    "ssm_h4": ("mamba2_780m", {"n_layers": 2, "quant": "ternary_packed",
                               "ssm_headdim": 32}),
    "ssm_q": ("mamba2_780m", {"n_layers": 2, "quant": "ternary"}),
    "hybrid_q": ("zamba2_2_7b", {"quant": "ternary"}),
    "encdec_q": ("whisper_medium", {"quant": "ternary"}),
}


def _family(shape, names, train=()):
    tag = f"d{shape[0]}m{shape[1]}"
    return ([{"id": f"family-{tag}-{n}", "kind": "family", "shape": shape,
              "model": n} for n in names]
            + [{"id": f"family-train-{tag}-{n}", "kind": "family_train",
                "shape": shape, "model": n} for n in train])

CASES = {
    1: [{"id": "train-d1m1", "kind": "train", "shape": [1, 1]},
        {"id": "decode-d1m1-wide", "kind": "decode", "shape": [1, 1],
         "model": "wide"},
        *_family([1, 1], ("ssm_tp", "hybrid_tp", "encdec_tp"),
                 ("ssm_q",))],
    2: _family([1, 2], ("ssm_tp", "hybrid_tp", "encdec_tp", "encdec_odd",
                           "ssm_g2"), ("ssm_q", "hybrid_q", "encdec_q")),
    4: [*_family([2, 2], ("ssm_tp", "hybrid_tp", "encdec_tp"),
                 ("hybrid_q",)),
        {"id": "train-d2m2", "kind": "train", "shape": [2, 2]},
        {"id": "decode-d2m2-wide", "kind": "decode", "shape": [2, 2],
         "model": "wide"},
        {"id": "decode-d1m4-narrow", "kind": "decode", "shape": [1, 4],
         "model": "narrow"},
        # a cache of 18 positions does not divide model:4: replicated
        {"id": "decode-d1m4-narrow-len18", "kind": "decode",
         "shape": [1, 4], "model": "narrow", "max_len": 18},
        {"id": "decode-d1m4-odd", "kind": "decode", "shape": [1, 4],
         "model": "odd"},
        {"id": "loop", "kind": "loop"},
        {"id": "global", "kind": "global", "shape": [2, 2]},
        {"id": "refusals", "kind": "refusal"}],
    8: [{"id": "train-d2m4", "kind": "train", "shape": [2, 4]},
        {"id": "decode-d2m4-wide", "kind": "decode", "shape": [2, 4],
         "model": "wide"},
        {"id": "elastic", "kind": "elastic"},
        {"id": "ep", "kind": "ep", "shape": [2, 4]},
        {"id": "refusals", "kind": "refusal"},
        *_family([1, 8], ("ssm_h4",))],
}

DECODES = [(w, c["id"]) for w in CASES for c in CASES[w]
           if c["kind"] == "decode"]
TRAINS = [(w, c["id"]) for w in CASES for c in CASES[w]
          if c["kind"] == "train"]
FAMILIES = [(w, c["id"]) for w in CASES for c in CASES[w]
            if c["kind"] == "family"]
FAMILY_TRAINS = [(w, c["id"]) for w in CASES for c in CASES[w]
                 if c["kind"] == "family_train"]


class _StandIn:
    """A mesh as both packages' placement rules read it: axis names and
    sizes only."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _case(world, cid):
    return next(c for c in CASES[world] if c["id"] == cid)


# -- the reference's side (this process only) ---------------------------------


def _jcfg(name):
    import repro.configs as jconfigs
    from repro.models.config import reduce_for_smoke

    arch, kw = {**MODELS, **FAMILY_MODELS}[name]
    return reduce_for_smoke(jconfigs.get(arch)).replace(**kw)


def _dtypes(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: str(v.dtype) for k, v in flat.items()}


def _export(tree, prefix):
    """A reference tree as flat float32-safe arrays, and its dtypes."""
    flat = R.flatten_tree(tree, prefix)
    dtypes = _dtypes(flat, prefix)
    flat = {k: v.astype(np.float32) if str(v.dtype) == "bfloat16" else v
            for k, v in flat.items()}
    return flat, dtypes


@pytest.fixture(scope="module")
def inputs():
    """The reference's parameters and the inputs, as exported arrays."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as JMOE
    from repro.models import transformer as JTF

    arrays, models = {}, {}
    trees = {}
    for name in ("train", "wide", "narrow", "odd"):
        cfg = _jcfg(name)
        trees[name] = jax.jit(functools.partial(JTF.init_params, cfg))(
            jax.random.PRNGKey(0))
        flat, dtypes = _export(jax.tree.map(np.asarray, trees[name]), name)
        arrays.update(flat)
        models[name] = {"arch": MODELS[name][0], "kw": MODELS[name][1],
                        "dtypes": dtypes}
    mcfg = _jcfg("moe")
    jmoe = jax.jit(functools.partial(JMOE.init, cfg=mcfg))(
        jax.random.PRNGKey(0))
    flat, dtypes = _export(jax.tree.map(np.asarray, jmoe), "moe")
    arrays.update(flat)
    models["moe"] = {"arch": MODELS["moe"][0], "kw": MODELS["moe"][1],
                     "dtypes": dtypes}
    models["ssm"] = {"arch": MODELS["ssm"][0], "kw": MODELS["ssm"][1],
                     "dtypes": {}}
    frng = np.random.default_rng(28)
    for name, (arch, kw) in FAMILY_MODELS.items():
        cfg = _jcfg(name)
        trees[name] = jax.jit(functools.partial(JTF.init_params, cfg))(
            jax.random.PRNGKey(0))
        flat, dtypes = _export(jax.tree.map(np.asarray, trees[name]), name)
        arrays.update(flat)
        models[name] = {"arch": arch, "kw": kw, "dtypes": dtypes}
        if cfg.family == "encdec":
            arrays[f"frames/{name}"] = frng.standard_normal(
                (R.FAMILY_BATCH, cfg.enc_seq, cfg.d_model)).astype(
                    np.float32)
    rng = np.random.default_rng(27)
    vocab = _jcfg("train").vocab
    arrays["batch/tokens"] = rng.integers(0, vocab, (2, BATCH, SEQ))
    arrays["batch/labels"] = rng.integers(0, vocab, (2, BATCH, SEQ))
    arrays["prompt"] = rng.integers(0, vocab, (4, R.PROMPT))
    arrays["dtoks"] = rng.integers(0, vocab, (R.DECODE_STEPS, 4, 1))
    x = jnp.asarray(rng.standard_normal((4, 16, mcfg.d_model)),
                    jnp.bfloat16)
    arrays["ep_x"] = np.asarray(x, np.float32)
    return {"arrays": arrays, "models": models, "trees": trees,
            "moe": jmoe, "x": x}


def _reference_results(inputs) -> dict:
    """The reference's unmeshed decode cell (teacher-forced) and dense
    MoE layer."""
    import jax
    import jax.numpy as jnp

    from repro.models import decoding as JDEC
    from repro.models import moe as JMOE

    arrays, trees = inputs["arrays"], inputs["trees"]
    decode = {}
    for name in ("wide", "narrow", "odd"):
        cfg, p = _jcfg(name), trees[name]
        prompt = jnp.asarray(arrays["prompt"], jnp.int32)
        lg, caches = jax.jit(lambda p, t, cfg=cfg: JDEC.prefill_with_cache(
            p, {"tokens": t}, cfg, R.MAX_LEN))(p, prompt)
        step = jax.jit(functools.partial(JDEC.decode_step, cfg=cfg))
        rows = []
        for i in range(R.DECODE_STEPS):
            tok = jnp.asarray(arrays["dtoks"][i], jnp.int32)
            out, caches = step(p, tok, caches, jnp.int32(R.PROMPT + i))
            rows.append(np.asarray(out, np.float32))
        decode[name] = {"prefill": np.asarray(lg, np.float32),
                        "decode": np.stack(rows)}
    y, aux = jax.jit(functools.partial(
        JMOE.apply, cfg=_jcfg("moe").replace(moe_impl="dense")))(
            inputs["moe"], inputs["x"])
    ep = {"y": np.asarray(y, np.float32), "lb_loss": float(aux["lb_loss"])}
    return {"decode": decode, "ep": ep,
            "family": _reference_families(inputs)}


def _jbatch(arrays, name, cfg, s) -> dict:
    import jax.numpy as jnp

    return {k: jnp.asarray(v, jnp.float32 if k == "frames" else jnp.int32)
            for k, v in R.family_batch(arrays, name, cfg.family, s).items()}


def _reference_families(inputs) -> dict:
    """The reference's unmeshed runs of the family models, from the params
    the ranks convert: `forward_logits` on the prefill batch and
    DECODE_STEPS teacher-forced `decode_step`s from zero caches
    (whisper's cross cache from its `encode`); one train step's loss and
    params (flat float32, stacked)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as JSTEPS
    from repro.models import decoding as JDEC
    from repro.models import transformer as JTF
    from repro.optim import adam as JADAM

    arrays, trees = inputs["arrays"], inputs["trees"]
    out = {}
    for name in sorted({_case(w, c)["model"] for w, c in FAMILIES}):
        cfg, p = _jcfg(name), trees[name]
        batch = _jbatch(arrays, name, cfg, R.PROMPT)
        del batch["labels"]
        lg = jax.jit(lambda p, b, cfg=cfg: JTF.forward_logits(p, b, cfg))(
            p, batch)
        b = batch["tokens"].shape[0]
        caches = JDEC.init_caches(cfg, b, R.MAX_LEN)
        if cfg.family == "encdec":
            kv = jax.jit(lambda p, f, cfg=cfg: jax.vmap(
                lambda lp: JTF._xattn_kv(lp, JTF.encode(p, f, cfg), cfg))(
                    p["layers"]["xattn"]))
            k, v = kv(p, batch["frames"])
            caches["cross"] = {"k": k, "v": v}
        step = jax.jit(functools.partial(JDEC.decode_step, cfg=cfg))
        rows = []
        for i in range(R.DECODE_STEPS):
            tok = jnp.asarray(arrays["dtoks"][i], jnp.int32)
            lgi, caches = step(p, tok, caches, jnp.full((b,), i, jnp.int32))
            rows.append(np.asarray(lgi, np.float32))
        out[name] = {"prefill": np.asarray(lg, np.float32),
                     "decode": np.stack(rows)}
    for name in sorted({_case(w, c)["model"] for w, c in FAMILY_TRAINS}):
        cfg, p = _jcfg(name), trees[name]
        fn = jax.jit(JSTEPS.make_train_step(
            cfg, JADAM.AdamConfig(total_steps=4, warmup_steps=1)))
        p, _, m = fn(p, jax.jit(JADAM.init_state)(p),
                     _jbatch(arrays, name, cfg, R.FAMILY_TRAIN_SEQ))
        out[name] = {"loss": float(m["loss"]), "params": {
            k[2:]: v for k, v in _export(jax.tree.map(np.asarray, p),
                                         "p")[0].items()}}
    return out


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """Every world's per-rank results, and the reference's results,
    computed while the ranks run."""
    roots = {}
    for world, cases in CASES.items():
        roots[world] = str(tmp_path_factory.mktemp(f"model{world}"))
        R.export_model_mesh(roots[world], inputs["arrays"],
                            {"models": inputs["models"], "cases": cases})
    ctxs = R.start_worlds(roots, R.model_rank_main)
    try:
        ref = _reference_results(inputs)
    finally:
        worlds = R.join_worlds(ctxs, roots)
    return worlds, ref


@pytest.fixture(scope="module")
def worlds(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def ref(spawned):
    return spawned[1]


@pytest.fixture(scope="module")
def ref_train(inputs, host_devices):
    """The reference's train step under use_mesh on the (2, 4) host mesh,
    twice: (losses, grad norms, flat float32 params after each step)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import shardings as JSH
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_mesh
    from repro.models import common as JC
    from repro.optim import adam as JADAM

    cfg = _jcfg("train")
    mesh = make_mesh((2, 4), ("data", "model"))
    pspecs = JSH.param_specs(JSTEPS.abstract_params(cfg), mesh)
    losses, norms, after = [], [], []
    with JC.use_mesh(mesh):
        params = jax.device_put(inputs["trees"]["train"],
                                JSH.named(mesh, pspecs))
        fn = jax.jit(JSTEPS.make_train_step(
            cfg, JADAM.AdamConfig(total_steps=4, warmup_steps=1)))
        opt = jax.jit(JADAM.init_state)(params)
        for step in range(2):
            batch = {k: jnp.asarray(inputs["arrays"][f"batch/{k}"][step],
                                    jnp.int32) for k in ("tokens", "labels")}
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            after.append({k[2:]: v for k, v in _export(
                jax.tree.map(np.asarray, params), "p")[0].items()})
    return losses, norms, after


# -- placement specs and parameter counts (this process) ----------------------


def _jspecs(tree):
    import jax
    from jax.sharding import PartitionSpec

    from repro.launch import shardings as JSH

    return {JSH._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _pspecs(tree) -> dict:
    from repro_torch.launch import shardings as SH

    out = {}

    def walk(t, path):
        if SH.is_spec(t):
            out["/".join(path)] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


def _per_layer(path: str, n_layers: dict) -> list:
    """The port's per-layer paths of a reference (stacked) path."""
    head, _, rest = path.partition("/")
    if head in n_layers and rest:
        return [f"{head}/{i}/{rest}" for i in range(n_layers[head])]
    return [path]


def _spec_trees(arch, mesh, jmesh, reduced=True):
    import repro.configs as jconfigs
    from repro.launch import shardings as JSH
    from repro.launch import steps as JSTEPS
    from repro.models.config import reduce_for_smoke as jreduce
    from repro_torch import configs
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models.config import reduce_for_smoke

    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    if reduced:
        jcfg, cfg = jreduce(jcfg), reduce_for_smoke(cfg)
    ja = JSTEPS.abstract_params(jcfg)
    jp = JSH.param_specs(ja, jmesh)
    jz = JSH.zero1_specs(ja, jp, jmesh)
    out = {}
    for stacked in (True, False):
        pa = steps.abstract_params(cfg, stacked=stacked)
        pp = SH.param_specs(pa, mesh)
        out[stacked] = (pa, _pspecs(pp), _pspecs(SH.zero1_specs(pa, pp,
                                                                 mesh)))
    return ja, _jspecs(jp), _jspecs(jz), out


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b_a3b",
                                  "mamba2_780m", "llava_next_mistral_7b"])
def test_specs_equal_reference_reduced(arch, host_devices):
    """param_specs and zero1_specs on a (2, 4) mesh, leaf by leaf: the
    stacked tree's against the reference's; the port's per-layer tree
    takes each layer the reference's spec without its layer axis."""
    from repro.launch.mesh import make_mesh

    from repro_torch.launch import steps

    jmesh = make_mesh((2, 4), ("data", "model"))
    _, jp, jz, out = _spec_trees(arch, _StandIn(data=2, model=4), jmesh)
    _, pp, pz = out[True]
    assert pp == jp
    assert pz == jz
    _, lp, _ = out[False]
    from repro_torch import configs
    from repro_torch.models.config import reduce_for_smoke
    cfg = reduce_for_smoke(configs.get(arch))
    tree = steps.abstract_params(cfg)
    n = {k: len(tree[k]) for k in ("layers", "dense_layers", "enc_layers")
         if k in tree}
    want = {}
    for path, spec in jp.items():
        for q in _per_layer(path, n):
            want[q] = spec[1:] if q != path else spec
    assert lp == want
    assert any("model" in s for s in lp.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference_full_size(arch):
    """Every config's full-size tree on a (16, 16) stand-in mesh (both
    packages' `_fits` read only axis names and sizes); nothing is
    allocated."""
    mesh = _StandIn(data=16, model=16)
    _, jp, jz, out = _spec_trees(arch, mesh, mesh, reduced=False)
    _, pp, pz = out[True]
    assert pp == jp
    assert pz == jz


def test_fit_named_and_batch_specs_equal_reference(host_devices):
    """fit_named on decode structs (batch 8 and batch 1) and the batch
    specs equal the reference's NamedShardings' specs."""
    from repro.launch import shardings as JSH
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_mesh
    from repro.models.config import ShapeSpec as JShape
    from repro_torch import configs
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeSpec, reduce_for_smoke

    jmesh = make_mesh((2, 4), ("data", "model"))
    mesh = _StandIn(data=2, model=4)
    for b, t in ((8, 64), (1, 64), (8, 6)):
        jcfg = _jcfg("train")
        cfg = reduce_for_smoke(configs.get("llama3_2_1b")).replace(n_layers=2)
        jst = JSTEPS.decode_struct(jcfg, JShape("d", t, b, "decode"))
        st = steps.decode_struct(cfg, ShapeSpec("d", t, b, "decode"))
        jfit = JSH.fit_named(jmesh, JSTEPS.decode_pspecs(jcfg), jst)
        fit = SH.fit_named(mesh, steps.decode_pspecs(cfg), st)
        want = {k: tuple(v.spec) for k, v in _flat_named(jfit).items()}
        assert _pspecs(fit) == want, (b, t)
        jb = JSTEPS.batch_pspecs(jcfg, JShape("t", t, b, "train"))
        assert {k: tuple(v) for k, v in jb.items()} == {
            k: tuple(v) for k, v in steps.batch_pspecs(
                cfg, ShapeSpec("t", t, b, "train")).items()}
    one = SH.fit_named(mesh, SH.P(("data",), None),
                       steps._meta((1, 1), None))
    assert tuple(one) == (None, None)


def _flat_named(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_named(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equal_reference(arch):
    import repro.configs as jconfigs
    from repro.roofline import params as JP
    from repro_torch import configs
    from repro_torch.roofline import params as PP

    for quant in ("none", "ternary_packed"):
        assert PP.count_params(configs.get(arch).replace(quant=quant)) == \
            JP.count_params(jconfigs.get(arch).replace(quant=quant)), quant


def test_roofline_terms_are_the_h100s():
    from repro_torch.roofline import terms

    r = terms.roofline(989e12, 3.35e12, 450e9)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    r = terms.roofline(1.0, 2 * 3.35e12, 0.0)
    assert r.bottleneck == "memory" and r.step_s == 2.0
    assert terms.model_flops_train(10, 3) == 180.0
    assert terms.model_flops_infer(10, 3, active_params=4) == 24.0


# -- the meshed train step ------------------------------------------------------


@pytest.mark.parametrize("world,cid", TRAINS, ids=[c for _, c in TRAINS])
def test_meshed_train_step(worlds, world, cid):
    for rank, (_arrays, info) in enumerate(worlds[world]):
        got = info[cid]
        if world == 1:
            assert got["params_equal"], rank
            assert got["loss"] == got["ref_loss"]
            assert got["grad_norm"] == got["ref_grad_norm"]
            continue
        np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], got["ref_grad_norm"],
                                   rtol=LOSS_TOL)
        assert got["param_max_diff"] <= PARAM_TOL, (rank, got)
        assert got["param_slices"] == _case(world, cid)["shape"][1]
        # ZeRO-1: some moment is cut into every rank's own slice
        assert got["moment_slices"] == world
        assert got["loss"] == worlds[world][0][1][cid]["loss"]


def test_meshed_train_step_equals_reference_step(worlds, ref_train):
    losses, norms, after = ref_train
    arrays, got = worlds[8][0][0], worlds[8][0][1]["train-d2m4"]
    np.testing.assert_allclose(got["loss"][0], losses[0], atol=LOSS_TOL)
    np.testing.assert_allclose(got["loss"][1], losses[1], atol=2.0 ** -4)
    np.testing.assert_allclose(got["grad_norm"][0], norms[0], rtol=2.0 ** -4)
    for step, want in enumerate(after):
        _params_near_reference(arrays, f"train-d2m4/params{step}", want,
                               max(got["lr"]))


def _params_near_reference(arrays, prefix, want, lr, per_leaf=True):
    """The gathered params under ``prefix`` against the reference's
    (flat): the same leaves, each entry within PARAM_TOL, and at most
    REF_STEP_SHARE of each leaf's entries (of all entries with
    ``per_leaf`` False) further apart than ``lr`` plus a bf16 ulp
    (updates that went other ways)."""
    assert set(want) == {k[len(prefix) + 1:] for k in arrays
                         if k.startswith(f"{prefix}/")}
    beyond = 0
    for path, w in want.items():
        diff = np.abs(arrays[f"{prefix}/{path}"] - w)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                  2.0 ** -126))) - 7)
        assert diff.max() <= PARAM_TOL, (prefix, path, diff.max())
        far = int((diff > ulp + lr).sum())
        assert not per_leaf or far <= REF_STEP_SHARE * w.size, (prefix, path)
        beyond += far
    total = sum(w.size for w in want.values())
    assert beyond <= REF_STEP_SHARE * total, (prefix, beyond, total)


# -- the ternary_packed decode cell ----------------------------------------------


def _ulps(rows: np.ndarray) -> np.ndarray:
    """A bf16 ulp of each row's largest |logit| (last axis)."""
    m = np.abs(rows).max(axis=-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


@pytest.mark.parametrize("world,cid", DECODES, ids=[c for _, c in DECODES])
def test_meshed_decode_cell(worlds, ref, world, cid):
    case = _case(world, cid)
    want = ref["decode"][case["model"]]
    vocab = _jcfg(case["model"]).vocab
    for rank, (arrays, info) in enumerate(worlds[world]):
        for part in ("prefill", "decode"):
            got, port = arrays[f"{cid}/{part}"], arrays[f"{cid}/{part}_port"]
            if world == 1:
                assert np.array_equal(got, port), (rank, part)
            else:
                assert (np.abs(got - port) <= MESH_ULPS * _ulps(port)).all(), \
                    (rank, part, float(np.abs(got - port).max()))
            np.testing.assert_allclose(got[..., :vocab],
                                       want[part][..., :vocab], rtol=0,
                                       atol=LOGIT_TOL)
        np.testing.assert_array_equal(arrays[f"{cid}/prefill_cache"],
                                      arrays[f"{cid}/prefill"])
        got = info[cid]
        tp, t = case["shape"][1], case.get("max_len", R.MAX_LEN)
        # the KV cache keeps its sequence over model where it divides
        if t % tp:
            assert got["cache_local_len"] == t
            assert got["cache_spec"][2] is None
        else:
            assert got["cache_local_len"] == t // tp
            assert got["cache_spec"][2] == "model"
        assert got["cache_max_diff"] <= (0.0 if world == 1 else 2.0 ** -5)


def test_decode_cell_covers_sharded_misaligned_and_replicated_rows(worlds):
    wide = worlds[4][0][1]["decode-d2m2-wide"]
    assert (wide["wo_rows_global"], wide["wo_rows"]) == (26, 13)
    assert 13 * 5 % 64                     # the slices miss the head slices
    narrow = worlds[4][0][1]["decode-d1m4-narrow"]
    assert narrow["wo_rows"] == narrow["wo_rows_global"] == 13
    assert worlds[8][0][1]["decode-d2m4-wide"]["wo_rows"] == 26
    odd = worlds[4][0][1]["decode-d1m4-odd"]
    assert (odd["wo_rows_global"], odd["wo_rows"]) == (20, 5)


# -- elastic restore, train(mesh=) ---------------------------------------------


def test_elastic_restore_bit_for_bit(worlds):
    for rank, (_arrays, info) in enumerate(worlds[8]):
        got = info["elastic"]
        assert got["step"] == 7
        assert got["local_equal"] and got["global_equal"], rank
        assert got["trit_encoding"] == "trit5"
        assert got["sliced"] > 0


def test_meshed_train_loop_restarts_on_another_mesh(worlds):
    got = worlds[4][0][1]["loop"]
    full = got["full"]
    assert full["steps"] == list(range(5))
    # INQ and ternary gradient compression on the slices: a resumed run
    # continues the uninterrupted one's losses bit for bit
    inq = got["inq"]
    assert inq["preempted"] and inq["resumed"]["restored_from"] == 1
    assert inq["resumed"]["losses"] == inq["full"]["losses"][2:]
    assert all(np.isfinite(inq["full"]["losses"]))
    for tag in ("elastic", "whole"):
        assert got[f"{tag}_preempted"]
        run = got[tag]
        assert run["restored_from"] == 2
        assert run["steps"] == [3, 4]
        np.testing.assert_allclose(run["losses"], full["losses"][3:],
                                   rtol=0, atol=LOSS_TOL)
    for _arrays, info in worlds[4]:
        assert info["loop"] == got


def test_meshed_inq_and_ternary_grads_equal_unmeshed(worlds):
    """INQ and ternary gradient compression on (2, 2) slices take the
    whole leaves' statistics: the run equals the unmeshed run."""
    got = worlds[4][0][1]["loop"]["inq"]
    full, flat = got["full"], got["unmeshed"]
    np.testing.assert_allclose(full["losses"], flat["losses"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(full["sparsity"], flat["sparsity"], rtol=0,
                               atol=SPARSITY_TOL)
    assert got["frozen"] == 0.5
    assert got["mask_diff_share"] <= MASK_DIFF_SHARE, got
    assert got["param_max_diff"] <= PARAM_TOL, got


# -- expert parallelism ------------------------------------------------------------


def test_expert_parallel_equals_dense_dispatch(worlds, ref):
    arrays, info = worlds[8][0]
    for impl in ("ep", "dense"):
        assert info[f"ep/{impl}"]["experts_local"] == 2
        y = arrays[f"ep/{impl}/y"]
        np.testing.assert_allclose(y, arrays["ep/port/y"], rtol=2e-2,
                                   atol=2e-3)
        # against the reference's dense layer: test_torch_moe.py's
        # tolerance, MOE_ULPS bf16 ulps of the largest |y|
        top = float(np.abs(ref["ep"]["y"]).max())
        assert np.abs(y - ref["ep"]["y"]).max() <= \
            MOE_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(info[f"ep/{impl}"]["lb_loss"],
                                   ref["ep"]["lb_loss"], rtol=0.1)
        for k in ("down_proj", "gate_proj", "router", "up_proj"):
            a = arrays[f"ep/port/grad/{k}"]
            b = arrays[f"ep/{impl}/grad/{k}"]
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-9)
            assert rel < 2e-2, (impl, k, rel)
    for _arrays, rinfo in worlds[8][1:]:
        assert rinfo["ep/ep"]["lb_loss"] == info["ep/ep"]["lb_loss"]


# -- make_global, refusals ------------------------------------------------------------


def test_make_global_and_batch1_fit(worlds):
    for rank, (_arrays, info) in enumerate(worlds[4]):
        got = info["global"]
        d = rank // 2                     # (data, model) = (rank // 2, rank % 2)
        rows = np.arange(48).reshape(8, 6)[4 * d:4 * d + 4]
        assert got["tokens"] == rows.tolist()
        assert got["labels"] == (rows + 100).tolist()
        assert got["device"] == "cpu"
        assert got["batch1_spec"] == [None, None]
        assert got["ssm_data_mesh_equal"]


@pytest.mark.parametrize("world", [4, 8])
def test_model_mesh_refusals(worlds, world):
    for _arrays, info in worlds[world]:
        got = info["refusals"]
        for k in ("world_too_small", "world_too_large"):
            assert got[k][0] == "ValueError" and "ranks" in got[k][1], k
        assert got["unknown_axis"][0] == "ValueError"
        # the ssm family has model-axis tensor parallelism: no refusal
        for k in ("ssm_tp", "ssm_build_cell"):
            assert got[k] == ["none", ""], k


# -- the ssm, hybrid and encdec families on a model axis -------------------------


@pytest.mark.parametrize("world,cid", FAMILIES, ids=[c for _, c in FAMILIES])
def test_family_on_model_axis(worlds, ref, world, cid):
    case = _case(world, cid)
    tp = case["shape"][1]
    cfg = _family_cfg(case["model"])
    want = ref["family"][case["model"]]
    for rank, (arrays, info) in enumerate(worlds[world]):
        for part in ("prefill", "decode"):
            got, port = arrays[f"{cid}/{part}"], arrays[f"{cid}/{part}_port"]
            # the reference's unmeshed run on the same params and inputs
            np.testing.assert_allclose(
                got[..., :cfg.vocab], want[part][..., :cfg.vocab], rtol=0,
                atol=FAMILY_LOGIT_TOL[cfg.family], err_msg=f"{rank} {part}")
            # bit for bit the unmeshed model whose row-cut projections
            # sum the ranks' bf16 partial products, as the ranks do
            assert np.array_equal(got, arrays[f"{cid}/{part}_partials"]), \
                (rank, part)
            if world == 1:
                assert np.array_equal(got, port), (rank, part)
            else:
                assert (np.abs(got - port) <= FAMILY_MESH_ULPS[cfg.family]
                        * _ulps(port)).all(), \
                    (rank, part, float((np.abs(got - port)
                                        / _ulps(port)).max()))
        got = info[cid]
        if "ssm/ssm" in got["cache_specs"]:
            spec, local = got["cache_specs"], got["cache_local"]
            heads = local["ssm/ssm"][2]
            if cfg.ssm_heads % tp:
                assert spec["ssm/ssm"][2] is None
                assert heads == cfg.ssm_heads
            else:
                assert spec["ssm/ssm"][2] == "model"
                assert heads == cfg.ssm_heads // tp
            assert local["ssm/conv_x"][3] == cfg.d_inner // tp
            assert got["state_max_diff"] <= (0.0 if world == 1 else 0.25)
        if world == 1:
            assert got.get("state_max_diff", 0.0) == 0.0
        if "cross/k" in got["cache_specs"]:
            enc = cfg.enc_seq
            split = enc % tp == 0
            assert (got["cache_specs"]["cross/k"][2] == "model") == split
            assert got["cache_local"]["cross/k"][2] == \
                (enc // tp if split else enc)


def _family_cfg(name):
    from repro_torch import configs
    from repro_torch.models.config import reduce_for_smoke

    arch, kw = FAMILY_MODELS[name]
    return reduce_for_smoke(configs.get(arch)).replace(**kw)


def test_family_out_proj_rows_sharded_and_misaligned(worlds):
    got = worlds[2][0][1]["family-d1m2-ssm_tp"]
    assert (got["out_proj_rows_global"], got["out_proj_rows"]) == (26, 13)
    assert 13 * 5 % 64                     # the slices miss the head slices
    # 26 rows do not divide model:8: out_proj replicated, y all-gathered
    assert worlds[8][0][1]["family-d1m8-ssm_h4"]["out_proj_rows"] == 26


@pytest.mark.parametrize("world,cid", FAMILY_TRAINS,
                         ids=[c for _, c in FAMILY_TRAINS])
def test_family_train_step_on_model_axis(worlds, ref, world, cid):
    case = _case(world, cid)
    want = ref["family"][case["model"]]
    for rank, (arrays, info) in enumerate(worlds[world]):
        got = info[cid]
        # against the reference's unmeshed step on the same params and batch
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=LOSS_TOL)
        _params_near_reference(arrays, f"{cid}/params", want["params"],
                               got["lr"], per_leaf=False)
        if world == 1:
            assert got["params_equal"] and got["loss"] == got["ref_loss"]
            continue
        np.testing.assert_allclose(got["loss"], got["ref_loss"], rtol=0,
                                   atol=LOSS_TOL)
        assert got["param_max_diff"] <= PARAM_TOL, (rank, got)
        assert got["param_slices"] == case["shape"][1]


@pytest.mark.parametrize("tp,split", [(2, True), (4, True), (8, False),
                                      (16, False)])
def test_whisper_cross_cache_splits_where_1500_divides(tp, split):
    """Full-size whisper-medium's decode cell: its 1,500-row cross cache
    is cut over ``model`` where 1,500 divides the axis and replicated
    where it does not (`fit_named`), and the decode step reads it so."""
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps

    mesh = M.StandInMesh((16 // tp if tp < 16 else 1, tp),
                         ("data", "model"))
    fn, args, specs = steps.build_cell(configs.get("whisper-medium"),
                                       "decode_32k", mesh)
    cross = specs["in"][2]["cross"]["k"]
    assert (cross[2] == "model") == split
    assert specs["in"][2]["kv"]["k"][2] == "model"
