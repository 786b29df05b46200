"""Frozen peaks of one NVIDIA H100 SXM and the operation and byte counts
of the kernels the benchmark reads.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W limit.  The counts follow from the logical shapes alone: each byte
an operation needs is read once and each byte it makes is written once,
whatever the kernel reads again.  A multiply-add is two operations.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12      # int8 OP/s (tensor cores)
PEAK_BF16_FLOPS = 989e12     # bf16 FLOP/s (tensor cores)
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes/s

TRITS_PER_BYTE = 5


def least_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the card can take: operations at ``peak`` or bytes
    at the HBM rate, whichever is longer."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


# -- the ternary CNN ----------------------------------------------------------


def conv_out_hw(hw: int, k: int, padding: bool) -> int:
    return hw if padding else hw - k + 1


def cnn_layers(sizes: dict) -> list[dict]:
    """The logical layers of a CUTIE CNN configuration: every conv layer
    and the dense head (a KxK valid conv over the last map), each with its
    input map ``hw``, ``cin``, ``cout``, ``k``, ``padding`` and ``pool``."""
    hw, cin = sizes["img_hw"], sizes["in_channels"]
    out = []
    for pool in sizes["pools"]:
        out.append(dict(hw=hw, cin=cin, cout=sizes["width"], k=3,
                        padding=True, pool=pool))
        cin = sizes["width"]
        if pool is not None:
            hw //= pool[1]
    out.append(dict(hw=hw, cin=cin, cout=sizes["n_classes"], k=hw,
                    padding=False, pool=None))
    return out


def conv_ops(layer: dict) -> int:
    """Operations of one image through one layer: 2 per multiply-add."""
    ohw = conv_out_hw(layer["hw"], layer["k"], layer["padding"])
    return 2 * layer["k"] ** 2 * layer["cin"] * layer["cout"] * ohw * ohw


def conv_bytes(layer: dict, n: int) -> int:
    """Bytes of one call of ``n`` images through one layer: int8 trits in,
    int8 trits out (after the merged pool), int8 weights and three float32
    thresholds-and-flags words a channel, each once."""
    ohw = conv_out_hw(layer["hw"], layer["k"], layer["padding"])
    if layer["pool"] is not None:
        ohw //= layer["pool"][1]
    act = n * (layer["hw"] ** 2 * layer["cin"] + ohw * ohw * layer["cout"])
    weights = layer["k"] ** 2 * layer["cin"] * layer["cout"]
    return act + weights + 12 * layer["cout"]


def cnn_ops_per_image(sizes: dict) -> int:
    return sum(conv_ops(layer) for layer in cnn_layers(sizes))


def cnn_least_s(sizes: dict, n: int) -> float:
    """The least time of one call of ``n`` images through every layer,
    the head included, each layer bounded on its own."""
    return sum(least_s(n * conv_ops(layer), conv_bytes(layer, n),
                       PEAK_INT8_OPS) for layer in cnn_layers(sizes))


# -- the ternary-packed decoder -----------------------------------------------


def projections(sizes: dict) -> list[tuple[str, int, int]]:
    """(name, K, N) of the seven projections of one decoder layer."""
    d, h, hk, dh, f = (sizes["d_model"], sizes["n_heads"], sizes["n_kv"],
                       sizes["d_head"], sizes["d_ff"])
    return [("q", d, h * dh), ("k", d, hk * dh), ("v", d, hk * dh),
            ("o", h * dh, d), ("gate", d, f), ("up", d, f), ("down", f, d)]


def packed_matmul_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def packed_matmul_bytes(m: int, k: int, n: int, act_bytes: int = 2) -> int:
    """x (M, K) and out (M, N) in bf16, the packed weights (ceil(K/5), N)
    and the float32 scale (N,), each once."""
    g = -(-k // TRITS_PER_BYTE)
    return act_bytes * m * (k + n) + g * n + 4 * n


def packed_forward_least_s(sizes: dict, m: int) -> float:
    """The least time of every projection of one forward over ``m`` real
    rows (kernel 7's work), each projection bounded on its own."""
    per_layer = sum(least_s(packed_matmul_flops(m, k, n),
                            packed_matmul_bytes(m, k, n), PEAK_BF16_FLOPS)
                    for _, k, n in projections(sizes))
    return sizes["n_layers"] * per_layer


def projection_params(sizes: dict) -> int:
    return sizes["n_layers"] * sum(k * n for _, k, n in projections(sizes))


def attention_flops(sizes: dict, q_rows: int, ctx_from: int) -> int:
    """Causal attention of ``q_rows`` new rows at positions ``ctx_from ..``
    over every earlier position and itself: QK^T and PV, 2 FLOPs a
    multiply-add each, over every layer."""
    ctx = q_rows * ctx_from + q_rows * (q_rows + 1) // 2
    return sizes["n_layers"] * 4 * ctx * sizes["n_heads"] * sizes["d_head"]


def decoder_flops(sizes: dict, q_rows: int, ctx_from: int) -> int:
    """Logical FLOPs of ``q_rows`` real rows of one sequence, at positions
    ``ctx_from ..``, through the decoder: every projection, attention at
    the real lengths, and the vocabulary head for the one row whose
    logits are sampled."""
    return (2 * projection_params(sizes) * q_rows
            + attention_flops(sizes, q_rows, ctx_from)
            + 2 * sizes["d_model"] * sizes["vocab"])
