"""The plain references against hand-worked tiny cases, and against the
port's CPU path on tiny cells."""

import json

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.tests import test_portbench_tiny as tiny

ROOT = harness.HERE.parent
CNN = harness.load_module(harness.HERE / "configs"
                          / "cutie-cifar10.reference.py")
DEC = harness.load_module(harness.HERE / "configs"
                          / "llava-next-mistral-7b.reference.py")


def test_thermometer_by_hand():
    px = torch.tensor([0.0, 1.0, 0.5, 0.3]).reshape(1, 1, 4, 1)
    t = CNN.thermometer(px, 2)                     # levels 0, 4, 2, 1
    assert t[0, :, 0].T.tolist() == [[-1, -1], [1, 1], [0, 0], [-1, 0]]


def test_twn_and_fold_by_hand():
    w = torch.tensor([1.0, -2.0, 0.25, 3.0]).reshape(4, 1)
    trits, alpha = CNN.twn(w, 0.7)       # delta = 0.7 * 1.5625 = 1.09375
    assert trits[:, 0].tolist() == [0, -1, 0, 1] and alpha.item() == 2.5
    lo, hi, flip, const, is_const = CNN.fold(
        alpha, torch.tensor([2.0]), torch.tensor([0.5]), torch.tensor([1.0]),
        torch.tensor([4.0]), 0.0, torch.float32)  # g = 2.5, c = -0.5
    assert (lo.item(), bool(flip), bool(is_const)) == (0.0, False, False)
    assert hi.item() == pytest.approx(0.4)
    z = torch.tensor([[-1.0], [0.0], [1.0]])
    assert CNN.threshold(z, lo, hi, flip, const, is_const)[:, 0].tolist() \
        == [-1, 0, 1]
    lo, hi, flip, *_ = CNN.fold(alpha, torch.tensor([-2.0]),
                                torch.tensor([0.5]), torch.tensor([1.0]),
                                torch.tensor([4.0]), 0.0, torch.float32)
    assert bool(flip) and lo.item() <= hi.item()


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_cnn_reference_equals_the_port_on_the_cpu(seed):
    sizes = {**json.loads((harness.HERE / "configs" / "cutie-cifar10.json")
                          .read_text()), **tiny.SIZES["cifar10-bulk"]}
    system = harness.load_module(harness.HERE / "configs" / "cutie-cifar10.py")
    program = system.build(sizes, {}, seed, "cpu")
    img = torch.rand((32, 8, 8, 3), generator=torch.Generator()
                     .manual_seed(seed % 1000))
    want = CNN.outputs(sizes, seed, img)
    assert torch.equal(program(img), want)
    assert len(set(want.flatten().tolist())) > 1


def test_serving_weight_by_hand():
    w = torch.tensor([[1.0, 0.5], [-2.0, 0.5], [0.25, -0.5], [3.0, 0.0]])
    got = DEC._serving_weight(w)
    # column 0 as in the CNN case; column 1: delta 0.2625, all but the 0
    # are +-1 with alpha 0.5
    assert got[:, 0].tolist() == [0, -2.5, 0, 2.5]
    assert got[:, 1].tolist() == [0.5, 0.5, -0.5, 0.0]


def test_decoder_reference_equals_a_hand_built_one_token_forward():
    """At one token, position 0: RoPE is the identity and attention
    returns v, so the block is x + Wo(repeat(Wv n(x))) and the MLP."""
    dims = {"d_model": 8, "n_layers": 1, "n_heads": 2, "n_kv": 1,
            "d_head": 4, "d_ff": 16, "vocab": 32, "rope_theta": 1e4,
            "rms_norm_eps": 1e-6}
    seed = 11
    got = DEC.logits(dims, seed, [np.array([5])], [[0]], "cpu")[0][0]

    def sw(w):
        return DEC._serving_weight(w).double().numpy()

    lw = {k: sw(v) for k, v in weights.decoder_layer(dims, seed, 0,
                                                     "cpu").items()}

    def rms(v):
        return v / np.sqrt((v * v).mean() + 1e-6)

    x = weights.decoder_embed(dims, seed, "cpu")[5].double().numpy()
    v = rms(x) @ lw["v"]
    x = x + np.concatenate([v, v]) @ lw["o"]
    m = rms(x)
    g = m @ lw["gate"]
    x = x + (g / (1 + np.exp(-g)) * (m @ lw["up"])) @ lw["down"]
    want = rms(x) @ weights.decoder_head(dims, seed, "cpu").double().numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_decoder_reference_matches_what_the_port_serves():
    r = tiny.run("llava-docs", 5)
    assert r["correct"]
    assert r["compared"]["max_gap"]["value"] < 0.05


@pytest.mark.parametrize("seed", [0, 5001, 2 ** 35 + 7])
def test_cnn_keeps_its_published_widths_for_every_seed(seed):
    """The compiler folds no channel and removes none, so every seed
    runs the same work at the paper's widths."""
    sizes = json.loads((harness.HERE / "configs" / "cutie-cifar10.json")
                       .read_text())
    system = harness.load_module(harness.HERE / "configs" / "cutie-cifar10.py")
    result = system.build(sizes, {}, seed, "cpu").pipe.compile_result
    assert result.folded_channels == 0 and not any(result.removed_channels)
    widths = [tuple(l.weights.shape[-2:]) for l in result.program.layers]
    assert widths == [(126, 128)] + [(128, 128)] * 7 + [(128, 10)]
