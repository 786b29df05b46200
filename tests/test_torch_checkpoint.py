"""The port's checkpoint format against the JAX reference's, on the CPU.

The same trees (numpy arrays made from a seed; the port's as CPU
tensors, the reference's as numpy or JAX arrays) are saved by both
packages: manifests and leaf files must be equal byte for byte, and a
checkpoint written by either package must restore in the other with
every leaf equal (bfloat16 bit for bit).  The ``trit5`` bytes equal the
reference's ``_pack``; pruning, ``latest_step``, the async save and the
unported ``mesh=`` are checked on the port alone.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import checkpoint as jcheckpoint
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as checkpoint_mod
from repro_torch.configs.cutie_cnn import CutieCNNConfig
from repro_torch.core import codec
from repro_torch.models import cutie_cnn


def _arrays(seed=0):
    """A tree with every encoding, nested dicts and lists and a None:
    f32 and int32 ``raw``, int8 trits of lengths 7, 33 and 20 (``trit5``,
    pads 3, 2 and none), an int8 leaf that is not all trits (``raw``),
    bf16 (``bytes``), a bool and a 0-d scalar."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 4)).astype(np.float32),
        "trits": [rng.integers(-1, 2, (7,)).astype(np.int8),
                  rng.integers(-1, 2, (3, 11)).astype(np.int8),
                  rng.integers(-1, 2, (5, 4)).astype(np.int8)],
        "codes": rng.integers(-5, 6, (9,)).astype(np.int8),
        "bf16": rng.standard_normal((2, 6)).astype(np.float32),
        "idx": {"b": rng.integers(0, 99, (4,)).astype(np.int32),
                "a": np.array(rng.random(3) < 0.5), "none": None},
        "step": np.float32(2.5),
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree))


def _port_tree(seed=0):
    t = _torch_tree(_arrays(seed))
    t["bf16"] = t["bf16"].to(torch.bfloat16)
    return t


def _ref_tree(seed=0):
    t = _arrays(seed)
    t["bf16"] = np.asarray(jnp.asarray(t["bf16"], jnp.bfloat16))
    return t


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a


def _leaves(tree):
    return [x for _, x in checkpoint_mod._flatten(tree)]


def _assert_same_leaves(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _as_np(a), _as_np(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_paths_and_leaf_order_are_the_references():
    tree = _port_tree()
    want = [p for p, _ in jcheckpoint._flatten(_ref_tree())]
    assert [p for p, _ in checkpoint_mod._flatten(tree)] == want
    assert want[:3] == ["bf16", "codes", "idx/a"]       # sorted, None no leaf
    assert "trits/1" in want


def test_files_byte_identical_to_the_references(tmp_path):
    mine = ckpt.save(str(tmp_path / "port"), 4, _port_tree(), extra={"x": 1})
    ref = jckpt.save(str(tmp_path / "ref"), 4, _ref_tree(), extra={"x": 1})
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    _, mismatch, errors = filecmp.cmpfiles(mine, ref, names, shallow=False)
    assert mismatch == [] and errors == []
    with open(os.path.join(mine, "manifest.json")) as f:
        leaves = {e["path"]: e for e in json.load(f)["leaves"]}
    enc = {p: e["encoding"] for p, e in leaves.items()}
    assert enc["w"] == enc["codes"] == enc["idx/b"] == "raw"
    assert enc["bf16"] == "bytes" and leaves["bf16"]["dtype"] == "bfloat16"
    assert [enc[f"trits/{i}"] for i in range(3)] == ["trit5"] * 3
    assert [leaves[f"trits/{i}"].get("pad") for i in range(3)] == [3, 2, None]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restores_across_packages(tmp_path, writer):
    root = str(tmp_path)
    if writer == "port":
        ckpt.save(root, 1, _port_tree())
        got, man = jckpt.restore(root, _ref_tree())
        _assert_same_leaves(got, _ref_tree())
    else:
        jckpt.save(root, 1, _ref_tree())
        got, man = ckpt.restore(root, _port_tree())
        _assert_same_leaves(got, _port_tree())
        assert got["bf16"].dtype == torch.bfloat16
        assert isinstance(got["trits"], list) and got["idx"]["none"] is None
    assert man["step"] == 1


@pytest.mark.parametrize("n", [1, 4, 5, 6, 7, 33, 125, 1001])
def test_trit5_bytes_equal_the_references_pack(tmp_path, n):
    """The codec's pack (the kernel's plain version on the CPU) gives the
    reference's ``_pack`` bytes, the tail padded with trit 0; restore
    strips the pad."""
    t = np.random.default_rng(n).integers(-1, 2, (n,)).astype(np.int8)
    want, pad = jcheckpoint._pack(t)
    got = codec.pack_trits(torch.from_numpy(t)).numpy()
    assert pad == (-n) % 5 and np.array_equal(got, want)
    ckpt.save(str(tmp_path), 0, {"t": torch.from_numpy(t)})
    with open(os.path.join(str(tmp_path), "step_000000000",
                           "manifest.json")) as f:
        e = json.load(f)["leaves"][0]
    assert e["encoding"] == "trit5" and e.get("pad", 0) == pad
    assert np.array_equal(np.load(os.path.join(
        str(tmp_path), "step_000000000", e["file"])), want)
    out, _ = ckpt.restore(str(tmp_path),
                          {"t": torch.zeros(n, dtype=torch.int8)})
    assert out["t"].dtype == torch.int8
    assert np.array_equal(out["t"].numpy(), t)
    host, _ = ckpt.restore(str(tmp_path), {"t": t})
    assert host["t"].dtype == np.int8 and np.array_equal(host["t"], t)


def test_restore_casts_to_the_template_and_keeps_numpy_leaves(tmp_path):
    ckpt.save(str(tmp_path), 2, {"a": torch.arange(6, dtype=torch.int64),
                                 "b": np.arange(4, dtype=np.float32)})
    out, _ = ckpt.restore(str(tmp_path), {"a": torch.zeros(6,
                                                           dtype=torch.int32),
                                          "b": np.zeros(4, np.float64)})
    assert out["a"].dtype == torch.int32 and out["a"].tolist() == list(
        range(6))
    assert isinstance(out["b"], np.ndarray) and out["b"].dtype == np.float64
    with pytest.raises(KeyError, match="missing leaf c"):
        ckpt.restore(str(tmp_path), {"c": np.zeros(1)})


def test_latest_step_pruning_and_stale_tmp(tmp_path):
    root = str(tmp_path)
    assert ckpt.latest_step(root) is None and ckpt.steps(root) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(root, {"a": np.zeros(1)})
    os.makedirs(os.path.join(root, "step_000000099.tmp"))
    for s in (1, 2, 3, 4):
        ckpt.save(root, s, {"a": np.full(2, s, np.float32)}, keep=2)
    assert ckpt.steps(root) == [3, 4] and ckpt.latest_step(root) == 4
    assert not any(d.endswith(".tmp") for d in os.listdir(root))
    out, man = ckpt.restore(root, {"a": np.zeros(2, np.float32)})
    assert man["step"] == 4 and out["a"].tolist() == [4.0, 4.0]
    out, _ = ckpt.restore(root, {"a": np.zeros(2, np.float32)}, step=3)
    assert out["a"].tolist() == [3.0, 3.0]
    assert jckpt.latest_step(root) == 4 and jckpt.steps(root) == [3, 4]


def test_save_async_copies_before_it_returns(tmp_path):
    """Tensors and arrays changed right after ``save_async`` returns do
    not change the checkpoint; ``should_save`` and ``restore_latest``."""
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2, every=5)
    assert [mgr.should_save(s) for s in (0, 5, 7, 10)] == [False, True,
                                                           False, True]
    t = torch.arange(10, dtype=torch.float32)
    trits = torch.tensor([1, 0, -1, 1, 1, 0, 0], dtype=torch.int8)
    host = np.ones(3, np.float32)
    tree = {"t": t, "trits": trits, "host": host}
    mgr.save_async(5, tree, extra={"note": "a"})
    t.add_(100.0)
    trits.zero_()
    host[:] = -7.0
    mgr.wait()
    out, man = mgr.restore_latest({"t": torch.zeros(10), "trits":
                                   torch.zeros(7, dtype=torch.int8),
                                   "host": np.zeros(3, np.float32)})
    assert man["extra"] == {"note": "a"} and man["step"] == 5
    assert out["t"].tolist() == list(range(10))
    assert out["trits"].tolist() == [1, 0, -1, 1, 1, 0, 0]
    assert out["host"].tolist() == [1.0, 1.0, 1.0]


def test_mesh_restore_names_its_roadmap_item(tmp_path):
    """A restore onto a mesh keeps this rank's slice of each leaf under
    its spec (the meshed save and the elastic restore across meshes run
    in tests/test_torch_model_mesh.py); ``CheckpointManager`` passes mesh
    and specs through, and a spec tree of another length refuses."""
    from repro_torch.launch.shardings import P

    class Rank1Of2:                      # rank 1's view of a data:2 mesh
        axis_names, shape = ("data",), {"data": 2}

        def coord(self, axis):
            return 1

    a = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    ckpt.save(str(tmp_path), 0, {"a": a, "n": np.zeros(1)})
    tmpl = {"a": torch.zeros((2, 2)), "n": np.zeros(1)}
    specs = {"a": P("data", None), "n": P(None)}
    got, _ = ckpt.restore(str(tmp_path), tmpl, mesh=Rank1Of2(), pspecs=specs)
    assert torch.equal(got["a"], a[2:])
    mgr = ckpt.CheckpointManager(str(tmp_path))
    got, _ = mgr.restore_latest(tmpl, mesh=Rank1Of2(), pspecs=specs)
    assert torch.equal(got["a"], a[2:]) and np.array_equal(got["n"],
                                                           np.zeros(1))
    with pytest.raises(ValueError, match="specs"):
        ckpt.restore(str(tmp_path), tmpl, pspecs={"a": P(None)})


def test_cnn_params_round_trip_both_ways(tmp_path):
    """The QAT CNN's trees (`convert.cnn_params_to_numpy` paths: layers/i/w,
    INQ masks, None stats skipped) and the compiled program's int8 trit
    weights: port-written files equal the reference's and restore into
    the reference's and the port's trees."""
    from repro.models import cutie_cnn as jcnn
    from repro.configs.cutie_cnn import CutieCNNConfig as JCfg

    cfg = CutieCNNConfig(width=8, thermometer_m=2)
    model = cutie_cnn.CutieCNN(cfg, seed=3, device="cpu")
    params, state = convert.cnn_params_to_numpy(model)
    prog = cutie_cnn.to_program(model)
    trits = [li.weights for li in prog.layers]
    port = {"params": model.params(), "inq": model.inq_state(),
            "trits": trits}
    ref = {"params": params, "inq": state["layers"],
           "trits": [t.numpy() for t in trits]}
    a = ckpt.save(str(tmp_path / "port"), 0, port)
    b = jckpt.save(str(tmp_path / "ref"), 0, ref)
    names = sorted(os.listdir(b))
    assert filecmp.cmpfiles(a, b, names, shallow=False)[1:] == ([], [])
    jp = jcnn.init_params(JCfg(width=8, thermometer_m=2),
                          jax.random.PRNGKey(0))
    jtpl = {"params": jp, "inq": state["layers"], "trits": ref["trits"]}
    got, _ = jckpt.restore(str(tmp_path / "port"), jtpl)
    _assert_same_leaves(got, ref)
    back, _ = ckpt.restore(str(tmp_path / "ref"), port)
    _assert_same_leaves(back, port)
    with open(os.path.join(a, "manifest.json")) as f:
        enc = {e["path"]: e["encoding"] for e in json.load(f)["leaves"]}
    assert enc["trits/0"] == "trit5" and enc["params/layers/0/w"] == "raw"
