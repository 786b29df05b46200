"""CUTIE core: layer-instruction compiler + bit-true plain execution.

Networks are compiled into layer instructions (pure-trit conv weights, the
folded two-threshold activation, optional merged pooling, stride and
padding) and run layer by layer, as the hardware's layer FIFO drives the
OCU array.  Everything computed is integer-exact: trits in int8, the conv
accumulator in int32 (|z| <= K*K*N_I = 1152 at the design point), pooling
on the pre-threshold integers.

Whole programs run through `repro_torch.pipeline.CutiePipeline`; this
module keeps the compiler (`compile_layer`, `CutieProgram`) and the plain
single-layer semantics the backends share.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import folding
from repro_torch.core import ternary as T
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CutieInstance:
    """Compile-time parameters of a CUTIE instantiation."""
    n_i: int = 128          # max input channels
    n_o: int = 128          # max output channels
    k: int = 3              # max (odd, square) kernel size
    i_w: int = 32           # max feature-map width
    i_h: int = 32           # max feature-map height
    n_layers: int = 8       # layer-FIFO depth (queueable layers)
    pipeline: int = 8       # OCU pipeline stages P
    freq_hz: float = 66e6   # paper's conservative clock
    technology: str = "GF22_SCM"   # GF22_SCM | GF22_SRAM | TSMC7_SCM

    @property
    def macs_per_cycle(self) -> int:
        # One output pixel for all N_O channels per cycle, K*K*N_I MACs each.
        return self.k * self.k * self.n_i * self.n_o

    @property
    def peak_tops(self) -> float:
        """Peak throughput in TOp/s (1 MAC = 2 Op, paper's Gamma formula)."""
        return 2 * self.macs_per_cycle * self.freq_hz / 1e12


GF22_SCM = CutieInstance(technology="GF22_SCM")
GF22_SRAM = CutieInstance(i_w=160, i_h=120, technology="GF22_SRAM")
TSMC7_SCM = CutieInstance(technology="TSMC7_SCM")


@dataclasses.dataclass
class LayerInstr:
    """One compiled CUTIE layer (weights + thresholds + meta-information)."""
    weights: torch.Tensor               # (K, K, Cin, Cout) int8 trits
    thresholds: folding.ChannelThresholds
    stride: tuple[int, int] = (1, 1)
    padding: bool = True                # full zero padding
    pool: tuple[str, int] | None = None  # ("max"|"avg", window) or None

    @property
    def kernel_size(self) -> int:
        return self.weights.shape[0]


@dataclasses.dataclass
class CutieProgram:
    layers: list
    instance: CutieInstance

    def validate(self, in_shape=None) -> None:
        """Check the program fits the instance's fixed geometry.

        Every failure names the layer index and field.  With ``in_shape``
        (N, H, W, C), activation shapes are propagated and checked
        against the feature-map buffers too.
        """
        inst = self.instance

        def bad(i, field, msg):
            raise ValueError(f"layer {i}: {field}: {msg}")

        if len(self.layers) > inst.n_layers:
            raise ValueError(
                f"{len(self.layers)} layers exceed layer FIFO depth "
                f"{inst.n_layers}")
        for i, l in enumerate(self.layers):
            if getattr(l.weights, "ndim", 0) != 4:
                bad(i, "weights", "expected a (K, K, Cin, Cout) tensor, "
                    f"got shape {tuple(getattr(l.weights, 'shape', ()))}")
            k, k2, cin, cout = l.weights.shape
            if k != k2:
                bad(i, "weights", f"kernel must be square, got {k}x{k2}")
            if k > inst.k or k % 2 == 0:
                bad(i, "weights", f"kernel {k} unsupported (odd, <= "
                    f"{inst.k})")
            if cin > inst.n_i or cout > inst.n_o:
                bad(i, "weights", f"channels ({cin},{cout}) exceed "
                    f"({inst.n_i},{inst.n_o})")
            if len(l.stride) != 2 or not (1 <= l.stride[0] <= 3
                                          and 1 <= l.stride[1] <= 3):
                bad(i, "stride", f"{l.stride} unsupported (1..3 each axis)")
            if l.pool is not None:
                if (len(l.pool) != 2 or l.pool[0] not in ("max", "avg")
                        or int(l.pool[1]) < 2):
                    bad(i, "pool", f"{l.pool!r} unsupported "
                        "(('max'|'avg', window >= 2))")
            th = l.thresholds
            for field in ("t_lo", "t_hi", "flip", "const", "is_const"):
                shape = tuple(getattr(th, field).shape)
                if shape != (cout,):
                    bad(i, f"thresholds.{field}",
                        f"shape {shape} != (Cout,) = ({cout},)")
        if in_shape is not None:
            _, h, w, c = in_shape
            for i, l in enumerate(self.layers):
                k, _, cin, cout = l.weights.shape
                if cin != c:
                    bad(i, "weights", f"Cin {cin} != incoming activation "
                        f"channels {c}")
                if h > inst.i_h or w > inst.i_w:
                    bad(i, "in_shape", f"feature map {h}x{w} exceeds "
                        f"buffer {inst.i_h}x{inst.i_w}")
                if not l.padding and (h < k or w < k):
                    bad(i, "padding", f"unpadded kernel {k} does not fit "
                        f"{h}x{w} feature map")
                h, w = conv_out_hw(l, h, w)
                if l.pool is not None:
                    win = l.pool[1]
                    if h < win or w < win:
                        bad(i, "pool", f"window {win} exceeds pooled "
                            f"feature map {h}x{w}")
                    h, w = h // win, w // win
                c = cout


def compile_layer(w_float, bn: dict, *, stride=(1, 1), padding=True,
                  pool=None, delta_ratio: float = 0.7,
                  device=None) -> LayerInstr:
    """Fold a float (already ternary-valued or latent) conv+BN layer.

    ``w_float`` is (K, K, Cin, Cout).  If it is not yet pure trits, TWN
    ternarization with a per-channel scale is applied; the scale folds
    into the thresholds (the hardware only sees pure trits).  A tensor
    keeps its device; anything else goes to ``resolve_device(device)``.
    """
    if isinstance(w_float, torch.Tensor) and device is None:
        dev = w_float.device
    else:
        dev = resolve_device(device)
    w = torch.as_tensor(w_float, dtype=torch.float32, device=dev)
    unit = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    if bool(torch.isin(w, unit).all()):
        trits = w.to(torch.int8)
        alpha = torch.ones((w.shape[-1],), dtype=torch.float32, device=dev)
    else:
        axes = (0, 1, 2)
        delta = T.twn_delta(w, axis=axes, ratio=delta_ratio)
        trits_f = T.ternarize(w, delta)
        alpha = T.twn_scale(w, trits_f, axis=axes).reshape(-1)
        trits = trits_f.to(torch.int8)

    def f32(name, default):
        return torch.as_tensor(bn.get(name, default), dtype=torch.float32,
                               device=dev)

    th = folding.fold_thresholds(
        alpha=alpha, bias=f32("bias", 0.0), gamma=f32("gamma", 1.0),
        beta=f32("beta", 0.0), mean=f32("mean", 0.0), var=f32("var", 1.0),
        eps=float(bn.get("eps", 1e-5)))
    if pool is not None and pool[0] == "avg":
        th = folding.scale_for_avgpool(th, pool[1] * pool[1])
    return LayerInstr(weights=trits, thresholds=th, stride=tuple(stride),
                      padding=padding, pool=pool)


def conv2d_int(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
               padding=True) -> torch.Tensor:
    """Integer conv (NHWC x HWIO -> NHWC int32), the plain version.

    Runs `F.conv2d` in float32, which is exact: every partial sum is an
    integer of magnitude <= K*K*Cin (1152 at the design point) < 2^24.
    On the card cuDNN would run a float32 conv in TF32 by default, whose
    10-bit mantissa cannot hold those sums, so TF32 is switched off for
    the call; the final round absorbs the sub-0.5 error of transform-based
    (Winograd/FFT) algorithms.
    """
    k = w.shape[0]
    p = k // 2 if padding else 0
    xn = x.permute(0, 3, 1, 2).to(torch.float32)
    wn = w.permute(3, 2, 0, 1).to(torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        z = F.conv2d(xn, wn, stride=tuple(stride), padding=p)
    return torch.round(z).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _pool_pre_threshold(z: torch.Tensor, th: folding.ChannelThresholds,
                        pool: tuple[str, int]) -> torch.Tensor:
    """Merged pooling on pre-threshold integers (paper Fig. 5 semantics)."""
    kind, win = pool
    n, h, w, c = z.shape
    zh = z[:, : h - h % win, : w - w % win, :]
    zh = zh.reshape(n, h // win, win, w // win, win, c)
    if kind == "avg":
        return zh.sum(dim=(2, 4), dtype=torch.int32)   # thresholds pre-scaled
    # max pooling must follow the compare direction: pool sign(g)*z.
    sgn = 1 - 2 * th.flip.to(z.dtype)
    return (zh * sgn).amax(dim=(2, 4)) * sgn


def layer_ops(instr: LayerInstr, in_shape) -> int:
    """Paper's op count Gamma = 2 * Iw * Ih * K * K * N_I * N_O.

    Iw/Ih are the *output* spatial dims (pre-pooling), §V-B.
    """
    k, _, cin, cout = instr.weights.shape
    _, h, w, _ = in_shape
    oh, ow = conv_out_hw(instr, h, w)
    return 2 * ow * oh * k * k * cin * cout


def conv_out_dims(k: int, stride, padding: bool, h: int, w: int
                  ) -> tuple[int, int]:
    """Output spatial dims of a conv (pre-pooling): ceil(H/s) rows for odd
    K with full zero padding, (H-K)//s + 1 without."""
    sh, sw = stride
    if padding:
        return -(-h // sh), -(-w // sw)
    return (h - k) // sh + 1, (w - k) // sw + 1


def conv_out_hw(instr: LayerInstr, h: int, w: int) -> tuple[int, int]:
    return conv_out_dims(instr.kernel_size, instr.stride, instr.padding,
                         h, w)


def layer_out_dims(k: int, stride, padding: bool, pool, h: int, w: int
                   ) -> tuple[int, int]:
    """Conv + merged-pool output dims."""
    h, w = conv_out_dims(k, stride, padding, h, w)
    if pool is not None:
        h, w = h // pool[1], w // pool[1]
    return h, w


def dense_as_conv(w_dense: torch.Tensor,
                  instance: CutieInstance = GF22_SCM) -> torch.Tensor:
    """Map a ternary dense layer onto a KxK OCU weight buffer (§III-E).

    The OCU buffer holds K*K*N_I weights per output channel, so dense
    inputs up to that size map into the (K, K, Cin) axes.
    """
    d_in, d_out = w_dense.shape
    max_in = instance.k * instance.k * instance.n_i
    if d_in > max_in or d_out > instance.n_o:
        raise ValueError(
            f"dense {tuple(w_dense.shape)} exceeds OCU buffer "
            f"({instance.k}x{instance.k}x{instance.n_i} -> {instance.n_o})")
    w = F.pad(w_dense, (0, 0, 0, max_in - d_in))
    return w.reshape(instance.k, instance.k, instance.n_i, d_out)
