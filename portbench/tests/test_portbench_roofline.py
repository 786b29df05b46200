"""The yardstick's counts against hand-worked small shapes, and the
device trace's reductions on a made-up timeline."""

import pytest

from portbench import roofline as R
from portbench.devtrace import DeviceTrace

PAPER_CNN = {"img_hw": 32, "in_channels": 126, "width": 128,
             "n_classes": 10,
             "pools": [None, None, ["max", 2], None, ["max", 2], None,
                       ["max", 2], ["avg", 4]]}


def test_conv_counts_by_hand():
    layer = dict(hw=4, cin=2, cout=3, k=3, padding=True, pool=None)
    assert R.conv_ops(layer) == 2 * 9 * 2 * 3 * 16
    assert R.conv_bytes(layer, 2) == 2 * (16 * 2 + 16 * 3) + 54 + 36
    pooled = dict(layer, pool=["max", 2])
    assert R.conv_bytes(pooled, 2) == 2 * (16 * 2 + 4 * 3) + 54 + 36
    head = dict(hw=1, cin=128, cout=10, k=1, padding=False, pool=None)
    assert R.conv_ops(head) == 2 * 128 * 10


def test_paper_cnn_layers_and_operations():
    layers = R.cnn_layers(PAPER_CNN)
    assert [l["hw"] for l in layers] == [32, 32, 32, 16, 16, 8, 8, 4, 1]
    assert layers[-1]["k"] == 1 and layers[-1]["cout"] == 10
    # 2 * (9*126*128*1024 + 2*9*128*128*1024 + 2*9*128*128*256
    #      + 2*9*128*128*64 + 9*128*128*16 + 128*10): the paper's 1.1 GOp
    assert R.cnn_ops_per_image(PAPER_CNN) == 1_094_715_904


def test_least_time_takes_the_longer_bound():
    assert R.least_s(R.PEAK_INT8_OPS, 0, R.PEAK_INT8_OPS) == 1.0
    assert R.least_s(0, R.HBM_BYTES_PER_S, R.PEAK_INT8_OPS) == 1.0


def test_packed_matmul_counts_by_hand():
    assert R.packed_matmul_flops(4, 10, 3) == 240
    # x 4*10 and out 4*3 in bf16, 2 packed rows of 3, a float32 scale of 3
    assert R.packed_matmul_bytes(4, 10, 3) == 2 * 4 * 13 + 2 * 3 + 4 * 3


def test_decoder_counts_by_hand():
    dims = {"d_model": 8, "n_layers": 1, "n_heads": 2, "n_kv": 1,
            "d_head": 4, "d_ff": 16, "vocab": 32}
    assert [p[1:] for p in R.projections(dims)] == [
        (8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)]
    assert R.projection_params(dims) == 64 + 32 + 32 + 64 + 128 * 3 == 576
    # 3 rows after 2 cached: 3*2 + (1+2+3) = 12 query-key pairs
    assert R.attention_flops(dims, 3, 2) == 4 * 12 * 2 * 4
    assert R.decoder_flops(dims, 3, 2) == (2 * 576 * 3 + 384 + 2 * 8 * 32)


def _trace():
    tr = DeviceTrace()
    tr.t0, tr.t1 = 0.0, 10.0
    tr.events = [("conv_mma_kernel<1>", 1.0, 2.0), ("memcpy", 1.5, 3.0),
                 ("conv_mma_kernel<2>", 5.0, 6.0), ("late", 9.5, 11.0)]
    return tr


def test_busy_time_is_the_union_clipped_to_the_window():
    tr = _trace()
    assert tr.busy_intervals() == [(1.0, 3.0), (5.0, 6.0), (9.5, 10.0)]
    assert tr.busy_s() == pytest.approx(3.5)
    assert tr.kernel_s(("conv_mma_kernel",)) == pytest.approx(2.0)


def test_top_ops_and_idle_gaps_by_the_open_span():
    tr = _trace()
    assert tr.top_ops()[0][0] == "memcpy"
    gaps = tr.idle_gaps([("step", 6.5, 9.0), ("wait", 3.0, 5.0)])
    assert gaps[0] == ["step", pytest.approx(3.5)]
    assert gaps[1] == ["wait", pytest.approx(2.0)]
    assert gaps[2] == ["none", pytest.approx(1.0)]


def test_align_maps_the_wall_clock_onto_the_host_spans():
    tr = DeviceTrace()
    tr._shift_ns = -1_000_000_000_000
    tr.t0, tr.t1 = 10.0, 20.0
    got = tr._align([("k", 1_011_000_000_000, 500_000_000)])
    assert got == [("k", pytest.approx(11.0), pytest.approx(11.5))]


@pytest.mark.parametrize("start_s", [8.0, 21.0])
def test_align_refuses_operations_outside_the_window(start_s):
    tr = DeviceTrace()
    tr._shift_ns = 0
    tr.t0, tr.t1 = 10.0, 20.0
    with pytest.raises(RuntimeError, match="outside the traced window"):
        tr._align([("k", int(start_s * 1e9), 1000)])
