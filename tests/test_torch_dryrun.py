"""The port's dry run (`repro_torch.launch.dryrun`) and step accounting
(`repro_torch.roofline.hlo`, `repro_torch.launch.mesh.StandInMesh`).

* `hlo.collective_bytes` on records equivalent to the synthetic HLO of
  tests/test_substrates.py gives that test's numbers;
* a reduced cell walked on ``meta`` tensors on a `StandInMesh` against
  the same cell run for real on gloo (one world of 4 spawned ranks,
  `tests/torch_mesh_ranks.py`, `_m_walk`): FLOPs, bytes, exchange
  records, argument, output and alias bytes equal, rank by rank (each
  rank's walk stands at its own coordinates; the temporaries'
  high-water mark is not held: the CPU's ops and the meta device's free
  a few of their storages at other ops);
* `with_depth`, `depth_of` and `_parse_overrides` against the
  reference's for all ten configs, computed in a subprocess: importing
  `repro.launch.dryrun` sets ``XLA_FLAGS`` to 512 host devices, which
  must not reach this worker's JAX;
* the CLI on the decode_32k cell of llama3.2-1B on both production
  meshes: one JSON per cell in the reference's keys, the depth
  extrapolation equal to the full walk.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_mesh_ranks as R

ARCHS = ["whisper_medium", "mamba2_780m", "internlm2_1_8b", "llama3_2_1b",
         "codeqwen1_5_7b", "qwen2_5_32b", "deepseek_moe_16b",
         "qwen3_moe_30b_a3b", "zamba2_2_7b", "llava_next_mistral_7b"]

MODELS = {
    "packed": ("llama3_2_1b", {"n_layers": 2, "n_heads": 8, "n_kv": 2,
                               "quant": "ternary_packed"}),
    "ssm": ("mamba2_780m", {"n_layers": 2, "quant": "ternary"}),
    "encdec": ("whisper_medium", {"quant": "ternary_packed"}),
}
CASES = {4: [
    {"id": "decode-packed", "kind": "walk", "shape": [2, 2],
     "model": "packed", "cell": ["decode", 4, 16]},
    {"id": "train-ssm", "kind": "walk", "shape": [2, 2], "model": "ssm",
     "cell": ["train", 4, 32]},
    {"id": "decode-encdec", "kind": "walk", "shape": [1, 4],
     "model": "encdec", "cell": ["decode", 2, 16]},
]}


def test_collective_bytes_on_synthetic_records():
    """The exchanges of test_substrates.py's synthetic HLO as records: an
    all-gather with an (8, 128) bf16 result over 8, an f32[256]
    all-reduce over groups of 2, an f32[64] reduce-scatter over 4, a
    u8[100] collective-permute (no replica groups: the default), an
    all-to-all of two f32[32] over 2."""
    from repro_torch.roofline import hlo

    res = hlo.collective_bytes([
        ("all-gather", 8 * 128 * 2, 8), ("all-reduce", 256 * 4, 2),
        ("reduce-scatter", 64 * 4, 4), ("collective-permute", 100, None),
        ("all-to-all", 2 * 32 * 4, 2)])
    by = res["by_op"]
    assert by["all-gather"]["count"] == 1
    assert by["all-gather"]["wire_bytes"] == pytest.approx(
        8 * 128 * 2 * 7 / 8)
    assert by["all-reduce"]["wire_bytes"] == pytest.approx(
        256 * 4 * 2 * 1 / 2)
    assert by["reduce-scatter"]["wire_bytes"] == pytest.approx(64 * 4 * 3)
    assert by["collective-permute"]["wire_bytes"] == 100
    assert by["all-to-all"]["payload_bytes"] == 256
    assert res["total_wire_bytes"] == pytest.approx(
        sum(d["wire_bytes"] for d in by.values()))
    assert res["top"][0]["op"] == "all-gather"


def test_dtype_and_wire_tables_are_the_references():
    from repro.roofline import hlo as JH

    from repro_torch.roofline import hlo

    assert hlo._DTYPE_BYTES == JH._DTYPE_BYTES
    for g in (1, 2, 16):
        assert {k: f(g) for k, f in hlo._WIRE_FACTOR.items()} == \
            {k: f(g) for k, f in JH._WIRE_FACTOR.items()}


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("walk"))
    rng = np.random.default_rng(28)
    R.export_model_mesh(root, {"unused": rng.integers(0, 2, 2)}, {
        "models": {k: {"arch": a, "kw": kw, "dtypes": {}}
                   for k, (a, kw) in MODELS.items()},
        "cases": CASES[4]})
    return R.spawn_worlds({4: root}, R.model_rank_main)[4]


@pytest.mark.parametrize("cid", [c["id"] for c in CASES[4]])
def test_meta_walk_equals_real_run(walks, cid):
    for rank, (_arrays, info) in enumerate(walks):
        real, meta = info[cid]["real"], info[cid]["meta"]
        assert meta["flops"] == real["flops"] > 0, rank
        assert meta["bytes"] == real["bytes"], rank
        assert meta["records"] == real["records"], rank
        assert meta["argument_bytes"] == real["argument_bytes"], rank
        assert meta["memory"]["argument_gb"] == real["memory"]["argument_gb"]
        assert meta["memory"]["output_gb"] == real["memory"]["output_gb"]
        assert meta["memory"]["alias_gb"] == real["memory"]["alias_gb"]
        assert meta["memory"]["peak_gb"] > 0
        # a decode step writes its KV caches in place
        if cid.startswith("decode"):
            assert real["memory"]["alias_gb"] > 0
        ops = {r[0] for r in real["records"]}
        assert "all-reduce" in ops


def test_kernel7_flops_in_the_walk(walks):
    """The packed decode cell's FLOPs hold kernel 7's 2 M K N per packed
    projection: a walk counts the registered op, not the plain
    version's padded product."""
    got = walks[0][1]["decode-packed"]["meta"]["flops"]
    assert got % 2 == 0 and got > 2 * 2 * 64 * 32


_REF = textwrap.dedent("""
    import json, sys
    import repro.configs as configs
    from repro.launch import dryrun
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = configs.get(arch)
        d1, d2 = dryrun.COST_DEPTHS[cfg.family]
        out[arch] = {"depth": dryrun.depth_of(cfg), "cost": [d1, d2],
                     "cfgs": [{k: getattr(dryrun.with_depth(cfg, d), k)
                               for k in ("n_layers", "enc_layers",
                                         "scan_layers")} for d in (d1, d2)]}
    out["overrides"] = dryrun._parse_overrides(
        ["quant=ternary_packed", "n_layers=3", "capacity_factor=1.5",
         "scan_layers=false", "remat=none"])
    print(json.dumps(out))
""")


def test_depths_and_overrides_equal_reference():
    from repro_torch import configs
    from repro_torch.launch import dryrun

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _REF, ",".join(ARCHS)],
                       env=dict(os.environ, PYTHONPATH="src"),
                       capture_output=True, text=True, timeout=300, cwd=repo)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for arch in ARCHS:
        cfg = configs.get(arch)
        d1, d2 = dryrun.COST_DEPTHS[cfg.family]
        assert {"depth": dryrun.depth_of(cfg), "cost": [d1, d2],
                "cfgs": [{k: getattr(dryrun.with_depth(cfg, d), k)
                          for k in ("n_layers", "enc_layers", "scan_layers")}
                         for d in (d1, d2)]} == want[arch], arch
    assert dryrun._parse_overrides(
        ["quant=ternary_packed", "n_layers=3", "capacity_factor=1.5",
         "scan_layers=false", "remat=none"]) == want["overrides"]


def test_cli_writes_reference_keys(tmp_path):
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--mesh", "single", "multi", "--out", str(tmp_path)])
    assert done.value.code == 0
    single = json.loads((tmp_path / "llama3_2_1b__decode_32k__single.json")
                        .read_text())
    multi = json.loads((tmp_path / "llama3_2_1b__decode_32k__multi.json")
                       .read_text())
    for cell in (single, multi):
        assert set(cell["memory"]) == {"argument_gb", "output_gb", "temp_gb",
                                       "alias_gb", "peak_gb"}
        assert {"arch", "shape", "mesh", "chips", "overrides",
                "compile_s", "wall_s"} <= set(cell)
    assert (single["chips"], multi["chips"]) == (256, 512)
    ex = single["extrapolated"]
    assert {"depth_full", "flops", "bytes", "collective_wire_bytes",
            "flops_per_layer", "bytes_per_layer", "collective_wire_per_layer",
            "top_collectives_d2", "by_op_d2"} <= set(ex)
    assert all(v == 0.0 for v in ex["extrapolation_error"].values())
    assert single["tokens_global"] == 128
    assert {"matmul", "active_matmul"} <= set(single["params"])
    assert len(single["cost_points"]) == 2
    # the KV cache is this rank's slice: 16 layers x 8 rows x 2048
    # positions x 8 kv heads x 64 x 2 bytes, k and v
    kv = 2 * 16 * 8 * 2048 * 8 * 64 * 2
    assert single["memory"]["alias_gb"] == pytest.approx(kv / 1e9)
