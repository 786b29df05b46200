"""Kernel 1's launches assigned to the CNN's layers by their order
(`portbench.launches`), and the three group rooflines that read them, on
a made-up trace of the paper's network."""

import pytest

from portbench import harness, launches
from portbench import roofline as R
from portbench.devtrace import DeviceTrace
from portbench.tests.test_portbench_roofline import PAPER_CNN

GROUPS = ["conv_roofline_32px.bulk", "conv_roofline_16px.bulk",
          "conv_roofline_tail.bulk"]
#: each group's layers of the paper's network
LAYERS = {"conv_roofline_32px.bulk": [0, 1, 2],
          "conv_roofline_16px.bulk": [3, 4],
          "conv_roofline_tail.bulk": [5, 6, 7, 8]}
CONV = "void conv_mma_kernel<false, 4, false>(Params)"
HEAD = "void conv_mma_kernel<false, 2, false>(Params)"
BATCH = 1024


def _read(metric, run):
    path = harness.HERE / "metrics" / f"{metric}.py"
    return harness.load_module(path).read(run)


class _Loop:
    batch = BATCH

    def __init__(self, calls):
        self.calls = calls


def _run(calls=3, drop=(), names=None):
    """A window of ``calls`` calls on one stream: per call the upload,
    the thermometer, layer i's launch taking (i + 1) ms, and the copy
    back; ``drop`` lists the (call, layer) launches the trace lacks,
    ``names`` maps (call, layer) to another kernel name."""
    tr = DeviceTrace()
    tr.t0, t = 1.0, 1.001
    done = []
    for c in range(calls):
        t_submit = t
        tr.events += [("Memcpy HtoD (Pinned -> Device)", t, t + 2e-4),
                      ("thermo_kernel", t + 2e-4, t + 3e-4)]
        t += 3e-4
        for i in range(9):
            name = (names or {}).get((c, i), HEAD if i == 8 else CONV)
            if (c, i) not in drop:
                tr.events.append((name, t, t + (i + 1) * 1e-3))
            t += (i + 1) * 1e-3 + 5e-6
        tr.events.append(("Memcpy DtoH (Device -> Pinned)", t, t + 1e-5))
        t += 2e-5
        done.append({"t_submit": t_submit, "t_done": t})
    tr.t1 = t + 1e-3
    return {"trace": tr, "loop": _Loop(done), "sizes": PAPER_CNN}


def _least(layers):
    return sum(R.least_s(BATCH * R.conv_ops(layer),
                         R.conv_bytes(layer, BATCH), R.PEAK_INT8_OPS)
               for layer in layers)


@pytest.mark.parametrize("metric", GROUPS)
def test_group_roofline_by_hand(metric):
    run = _run()
    layers = R.cnn_layers(PAPER_CNN)
    mine = [layers[i] for i in LAYERS[metric]]
    spent = 3 * sum((i + 1) * 1e-3 for i in LAYERS[metric])
    assert _read(metric, run) == pytest.approx(
        100.0 * 3 * _least(mine) / spent)


def test_groups_cover_every_layer_once():
    layers = R.cnn_layers(PAPER_CNN)
    assert sorted(sum(LAYERS.values(), [])) == list(range(len(layers)))
    assert [layers[i]["hw"] for i in LAYERS["conv_roofline_32px.bulk"]] \
        == [32] * 3


def test_launches_go_to_layers_by_their_order():
    spent, calls = launches.layer_device_s(_run(calls=4))
    assert calls == 4
    assert spent == pytest.approx([4 * (i + 1) * 1e-3 for i in range(9)])


@pytest.mark.parametrize("drop", [[(0, 0)], [(1, 4)], [(2, 8)],
                                  [(0, 3), (2, 0)]])
def test_a_call_with_a_launch_missing_is_left_out(drop):
    spent, calls = launches.layer_device_s(_run(calls=4, drop=drop))
    left = 4 - len({c for c, _ in drop})
    assert calls == left
    assert spent == pytest.approx([left * (i + 1) * 1e-3 for i in range(9)])
    for m in GROUPS:
        assert _read(m, _run(calls=4, drop=drop)) == pytest.approx(
            _read(m, _run(calls=left)))


def test_groups_weighted_by_device_time_give_conv_roofline():
    run = _run(calls=5)
    whole = _read("conv_roofline.bulk", run)
    spent, _ = launches.layer_device_s(run)
    weighted = sum(_read(m, run) * sum(spent[i] for i in LAYERS[m])
                   for m in GROUPS) / sum(spent)
    assert sum(spent) == pytest.approx(
        run["trace"].kernel_s(("conv_mma_kernel", "trunk_kernel")))
    assert weighted == pytest.approx(whole)


@pytest.mark.parametrize("metric", GROUPS)
@pytest.mark.parametrize("how", ["no-whole-call", "mixed-names", "trunk",
                                 "untraced", "empty"])
def test_a_window_that_cannot_be_assigned_reads_none(metric, how):
    if how == "no-whole-call":
        run = _run(calls=2, drop=[(0, 5), (1, 0)])
    elif how == "mixed-names":
        # the second call's layer 3 on another instantiation: its
        # launches are not each call's layers in order
        run = _run(names={(1, 3): HEAD})
    elif how == "trunk":
        run = _run()
        run["trace"].events.append(("trunk_kernel<4>", 1.0005, 1.0006))
    elif how == "untraced":
        run = {**_run(), "trace": None}
    else:
        run = _run(calls=0)
    assert _read(metric, run) is None
