"""GPipe over ``pod`` (`repro_torch.launch.pipeline`) against the
reference's `repro.launch.pipeline`, on gloo in spawned CPU processes.

The reference's side runs in a subprocess on 4 host devices, as
tests/test_pipeline.py runs it (its own reduced llama3.2-1B, 4 layers,
loss_chunk 32, params from PRNGKey(0), an (8, 32) batch from
default_rng(0)): its `pipeline_forward_loss` on a (pod 2, model 2)
mesh and its plain `forward_loss`, and the params and batch it used,
exported with ``np.savez``.  The port's side is one world of 4 ranks,
spawned once (`tests/torch_mesh_ranks.py`, `_m_gpipe`), on the same
params and batch.

Held: the port's pipelined loss within the reference test's 5e-3 of the
reference's pipelined loss, and within ``FLAT_TOL`` = 2**-6 (the
meshed train step's LOSS_TOL in tests/test_torch_model_mesh.py) of the
unmeshed port's `forward_loss` (measured: 1.2e-3; inside each stage
the model axis all-reduces the row products' partial sums, which round
the bf16 activations otherwise); every rank's loss and token
count the same; the exchanges of the real run equal, op for op, those
of the same stage walked on ``meta`` tensors (`StandInMesh`), FLOPs and
argument bytes too; `stage_pspecs` leaf by leaf against the
reference's; the refusals (a non-dense family, a batch that does not
split into the microbatches, a world that is not the mesh's).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_mesh_ranks as R

FLAT_TOL = 2.0 ** -6
N_MICRO, STAGES = 4, 2

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch import _compat
    if not _compat.HAS_PARTIAL_MANUAL_SHARD_MAP:
        print("PIPELINE_SKIP")
        raise SystemExit(0)
    from repro.launch.mesh import make_mesh
    from repro.launch import pipeline
    from repro.models import common as C, transformer as TF
    import repro.configs as configs
    from repro.models.config import reduce_for_smoke

    cfg = reduce_for_smoke(configs.get("llama3_2_1b")).replace(
        n_layers=4, loss_chunk=32)
    mesh = make_mesh((2, 2), ("pod", "model"))
    params = TF.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.asarray(rng.integers(0, cfg.vocab, (8, 32)), jnp.int32),
        "labels": jnp.asarray(rng.integers(0, cfg.vocab, (8, 32)), jnp.int32),
    }
    with C.use_mesh(mesh):
        pp_loss, _ = jax.jit(lambda p, b: pipeline.pipeline_forward_loss(
            p, b, cfg, mesh, n_micro=4))(params, batch)
        ref_loss, _ = jax.jit(
            lambda p, b: TF.forward_loss(p, b, cfg))(params, batch)
    out, dtypes = {}, {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        elif t is not None:
            a = np.asarray(t)
            dtypes["/".join(path)] = str(a.dtype)
            out["gpipe/" + "/".join(path)] = a.astype(np.float32) \\
                if str(a.dtype) == "bfloat16" else a
    walk(params, [])
    for k, v in batch.items():
        out["gpipe_" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    import json
    with open(sys.argv[1] + ".json", "w") as f:
        json.dump({"pp_loss": float(pp_loss), "ref_loss": float(ref_loss),
                   "dtypes": dtypes}, f)
    print("PIPELINE_OK")
""")

CASES = {4: [{"id": "gpipe", "kind": "gpipe", "shape": [STAGES, 2]}]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's losses, every rank's results)."""
    import json

    root = str(tmp_path_factory.mktemp("gpipe"))
    dump = os.path.join(root, "ref.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", SCRIPT, dump], env=env,
                       capture_output=True, text=True, timeout=600, cwd=repo)
    if "PIPELINE_SKIP" in r.stdout:
        pytest.skip("no partial-manual shard_map on this jax")
    assert "PIPELINE_OK" in r.stdout, r.stdout + "\n" + r.stderr[-4000:]
    with open(dump + ".json") as f:
        ref = json.load(f)
    with np.load(dump) as z:
        arrays = {k: z[k] for k in z.files}
    R.export_model_mesh(root, arrays, {
        "models": {"gpipe": {"arch": "llama3_2_1b",
                             "kw": {"n_layers": 4, "loss_chunk": 32},
                             "dtypes": ref["dtypes"]}},
        "cases": CASES[4]})
    worlds = R.spawn_worlds({4: root}, R.model_rank_main)
    return ref, [info["gpipe"] for _arrays, info in worlds[4]]


def test_gpipe_loss_matches_reference_pipeline(runs):
    ref, ranks = runs
    for got in ranks:
        assert abs(got["loss"] - ref["pp_loss"]) < 5e-3, (got["loss"], ref)
        assert got["loss"] == ranks[0]["loss"]
        assert got["tokens"] == 8 * 32
    # the reference's own pipeline agrees with its plain forward
    assert abs(ref["pp_loss"] - ref["ref_loss"]) < 5e-3


def test_gpipe_loss_matches_unmeshed_port(runs):
    _, ranks = runs
    for got in ranks:
        assert abs(got["loss"] - got["unmeshed_loss"]) <= FLAT_TOL, got


def test_gpipe_stages_and_exchanges(runs):
    """Each stage holds its 2 of the 4 layers; every rank shifts once a
    tick, T = M + S - 1, one microbatch of bf16 activations (2 x 32 x
    64); the records, FLOPs and argument bytes of the real run equal the
    meta walk's of the same position."""
    _, ranks = runs
    act = (8 // N_MICRO) * 32 * 64 * 2
    for got in ranks:
        assert got["layers_local"] == 2
        perm = [r for r in got["records"] if r[0] == "collective-permute"]
        assert perm == [["collective-permute", act, STAGES]] * (
            N_MICRO + STAGES - 1)
        assert got["records"] == got["meta_records"]
        assert got["flops"] == got["meta_flops"] > 0
        assert got["argument_bytes"] == got["meta_argument_bytes"]


def test_gpipe_world_must_match_mesh(runs):
    _, ranks = runs
    for got in ranks:
        assert got["world_mismatch"][0] == "ValueError"
        assert "ranks" in got["world_mismatch"][1]


def test_gpipe_refusals():
    import torch

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch import pipeline as PP
    from repro_torch.models.config import reduce_for_smoke

    mesh = M.StandInMesh((2, 2), ("pod", "model"))
    batch = {k: torch.zeros((8, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    dense = reduce_for_smoke(configs.get("llama3_2_1b")).replace(n_layers=4)
    for cfg, b, n_micro, what in (
            (reduce_for_smoke(configs.get("mamba2_780m")), batch, 4,
             "dense family"),
            (dense, batch, 3, "microbatches"),
            (dense.replace(n_layers=3), batch, 4, "stages")):
        with pytest.raises(ValueError, match=what):
            PP.pipeline_forward_loss({"layers": []}, b, cfg, mesh,
                                     n_micro=n_micro)


def _jspecs(tree):
    import jax
    from jax.sharding import PartitionSpec

    from repro.launch import shardings as JSH

    return {JSH._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


def _pspecs(tree, path=()) -> dict:
    from repro_torch.launch import shardings as SH

    if SH.is_spec(tree):
        return {"/".join(path): tuple(tree)}
    out = {}
    for k, v in (tree or {}).items():
        out.update(_pspecs(v, path + (k,)))
    return out


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_5_32b"])
def test_stage_pspecs_equal_reference(arch):
    """stage_pspecs of the full-size stacked tree on the (2, 16, 16)
    production mesh (a stand-in: both packages' rules read only axis
    names and sizes), leaf by leaf."""
    import repro.configs as jconfigs
    from repro.launch import pipeline as JPP
    from repro.launch import steps as JSTEPS

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch import pipeline as PP
    from repro_torch.launch import steps

    mesh = M.StandInMesh(*M.PRODUCTION[True])
    want = _jspecs(JPP.stage_pspecs(
        JSTEPS.abstract_params(jconfigs.get(arch)), mesh))
    got = _pspecs(PP.stage_pspecs(
        steps.abstract_params(configs.get(arch), stacked=True), mesh))
    assert got == want
    assert sum(s[0] == "pod" for s in got.values()) > 0
