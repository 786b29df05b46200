"""Trunk megakernel: L uniform padded layers in one launch, and its plain
twin.

CUTIE streams activations layer to layer without storing partial results
(paper §III-C).  The per-layer path writes every layer's trit map to
device memory and reads it back in the next launch; a trunk runs a
contiguous run of uniform layers in ONE persistent cooperative kernel
(`csrc/fused_trunk.cu`): the blocks walk each layer's tiles with the
conv kernel's tile body (`csrc/conv_tile.cuh`), a grid-wide barrier
separates the layers, and the activations ping-pong between two device
buffers that the trunk planner (`repro_torch.compiler.trunks`) sizes to
stay in the card's L2.

Trunks are chained with trit-packed activations: ``packed_in`` decodes a
5-trits-per-byte stream before the first layer, ``pack_out`` encodes the
last layer's output, inside the same launch.  ``emit_stats`` adds an
(L, 3) int32 block of per-layer counters (in-zero, out-zero,
window-toggle) over each layer's logical channels.

On a CUDA tensor :func:`fused_trunk` launches the kernel or raises; on a
CPU tensor it runs :func:`fused_trunk_plain`, the per-layer plain conv
and epilogue loop plus the plain codec.  ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.codec import packed_size
from repro_torch.core.engine import layer_out_dims
from repro_torch.kernels import _build
from repro_torch.kernels import ternary_conv2d as K
from repro_torch.kernels import trit_codec as C

LAUNCHES = {"fused_trunk": 0}

_MAX_LAYERS = 16          # kMaxLayers of csrc/fused_trunk.cu


def reset_launches() -> None:
    LAUNCHES["fused_trunk"] = 0


def trunk_shapes(in_hw, k: int, metas) -> list[tuple[int, int]]:
    """Static per-layer activation dims [input, after layer 0, ...].

    ``metas`` holds one (stride, pool) pair per layer; every trunk layer
    is fully padded, so dims shrink monotonically.
    """
    h, w = in_hw
    shapes = [(h, w)]
    for stride, pool in metas:
        h, w = layer_out_dims(k, stride, True, pool, h, w)
        shapes.append((h, w))
    return shapes


def _input_shape(x, w_stack, metas, packed_in) -> tuple[int, int, int, int]:
    """Check the operands; the logical (N, H, W, Cin) of the trunk input."""
    if w_stack.dim() != 5 or w_stack.shape[1] != w_stack.shape[2]:
        raise ValueError(f"w_stack must be (L, K, K, Cu, C), got "
                         f"{tuple(w_stack.shape)}")
    nl, cu, c = w_stack.shape[0], w_stack.shape[3], w_stack.shape[4]
    if cu < c:
        raise ValueError(f"common input width {cu} < trunk width {c}")
    if len(metas) != nl:
        raise ValueError(f"{len(metas)} metas for {nl} layers")
    if packed_in is None:
        if x.dim() != 4:
            raise ValueError(f"x must be (N, H, W, Cin), got "
                             f"{tuple(x.shape)}")
        shape = tuple(x.shape)
    else:
        shape = tuple(packed_in)
        n, h, w, cin = shape
        if tuple(x.shape) != (packed_size(n * h * w * cin),):
            raise ValueError(f"packed input {tuple(x.shape)} does not hold "
                             f"{shape} trits")
    if shape[3] > cu:
        raise ValueError(f"input has {shape[3]} channels, the weight stack "
                         f"{cu}")
    return shape


def fused_trunk_plain(x, w_stack, t_lo, t_hi, flip, const, is_const, *,
                      metas, packed_in=None, pack_out: bool = False,
                      emit_stats: bool = False, stats_cin=None):
    """Plain PyTorch version of :func:`fused_trunk`."""
    shape = _input_shape(x, w_stack, metas, packed_in)
    if packed_in is not None:
        numel = shape[0] * shape[1] * shape[2] * shape[3]
        x = C.unpack_trits_plain(x.reshape(1, -1)).reshape(-1)[:numel]
        x = x.reshape(shape)
    x = x.to(torch.int8)
    nl, k, c = w_stack.shape[0], w_stack.shape[1], w_stack.shape[4]
    t_lo, t_hi, flip, const, is_const = [
        torch.as_tensor(v, device=x.device).reshape(nl, c)
        for v in (t_lo, t_hi, flip, const, is_const)]
    stats_cin = x.shape[-1] if stats_cin is None else stats_cin
    cur, rows = x, []
    for l, (stride, pool) in enumerate(metas):
        y = K.ternary_conv2d_plain(
            cur, w_stack[l][:, :, :cur.shape[-1]], stride=stride,
            padding=True, t_lo=t_lo[l], t_hi=t_hi[l], flip=flip[l],
            const=const[l], is_const=is_const[l], pool=pool)
        if emit_stats:
            cl = stats_cin if l == 0 else c
            rows.append(K.plain_stats(cur[..., :cl], y, k, True))
        cur = y
    if pack_out:
        cur = C.pack_trits_plain(cur.reshape(1, -1)).reshape(-1)
    return (cur, torch.stack(rows)) if emit_stats else cur


@functools.lru_cache(maxsize=256)
def _geometry(h: int, w: int, cin: int, c: int, cu: int, k: int, metas,
              stats_cin: int):
    """(TileGeo rows as a C array, output dims) of a trunk: a pure
    function of the shapes, kept so repeated runs skip the Python."""
    shapes = trunk_shapes((h, w), k, metas)
    geos = [K.tile_geometry(hl, wl, cin if l == 0 else c, c, k, stride,
                            True, pool, w_rows=cu,
                            stat_c=stats_cin if l == 0 else c)
            for l, ((hl, wl), (stride, pool)) in enumerate(zip(shapes,
                                                               metas))]
    return K.geo_array(geos), shapes[-1]


def _library() -> ctypes.CDLL:
    lib = _build.library("fused_trunk")
    fn = lib.cutie_fused_trunk
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, i64, i64, p, i64, p, p, p, p, p, p, p, p, i64, i32,
                       p, p, i32, i32, ctypes.POINTER(ctypes.c_int), p]
        fn.restype = ctypes.c_int
    return lib


def fused_trunk(x, w_stack, t_lo, t_hi, flip, const, is_const, *, metas,
                packed_in=None, pack_out: bool = False,
                emit_stats: bool = False, stats_cin=None):
    """Run a trunk of L uniform padded layers in one kernel launch.

    x (N, H, W, Cx) int8 trits with Cx <= Cu (the head's logical Cin, or
    zero-padded up to Cu: the results are identical); w_stack
    (L, K, K, Cu, C) int8, each layer's Cin zero-padded to the common
    width Cu >= C; t_lo/t_hi (L, C) float32, flip/const/is_const (L, C)
    int8-coercible; ``metas`` one (stride, pool) per layer.  With
    ``packed_in=(N, H, W, Cin)`` x is instead the (G,) uint8 stream a
    ``pack_out=True`` trunk wrote; with ``pack_out`` the result is the
    packed (G,) stream of the final trit map.  ``emit_stats`` returns
    ``(out, stats)`` with stats (L, 3) int32; ``stats_cin`` is the head's
    logical Cin (default: the input's channel count).

    Replaces `repro.kernels.fused_trunk.fused_trunk_pallas`.
    """
    if x.device.type == "cpu":
        return fused_trunk_plain(
            x, w_stack, t_lo, t_hi, flip, const, is_const, metas=metas,
            packed_in=packed_in, pack_out=pack_out, emit_stats=emit_stats,
            stats_cin=stats_cin)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, h, w, cin = _input_shape(x, w_stack, metas, packed_in)
    if packed_in is None and x.dtype != torch.int8:
        raise ValueError(f"x must be int8 trits, got {x.dtype}")
    if packed_in is not None and x.dtype != torch.uint8:
        raise ValueError(f"packed input must be uint8, got {x.dtype}")
    if w_stack.dtype != torch.int8 or w_stack.device != x.device:
        raise ValueError(f"w_stack must be int8 on {x.device}, got "
                         f"{w_stack.dtype} on {w_stack.device}")
    nl, k, cu, c = (w_stack.shape[0], w_stack.shape[1], w_stack.shape[3],
                    w_stack.shape[4])
    if nl > _MAX_LAYERS:
        raise ValueError(f"{nl} layers exceed the kernel's {_MAX_LAYERS}")
    stats_cin = cin if stats_cin is None else stats_cin
    if not 0 <= stats_cin <= cin:
        raise ValueError(f"stats_cin {stats_cin} outside 0..{cin}")
    key = tuple((tuple(stride), tuple(pool) if pool else None)
                for stride, pool in metas)
    geo, (oh, ow) = _geometry(h, w, cin, c, cu, k, key, stats_cin)
    dev = x.device
    vecs = K.epilogue_vectors(dev, (nl, c), t_lo, t_hi, flip, const,
                              is_const)
    buf_numel = n * h * w * max(cin, c)
    bufs = [torch.empty(buf_numel, dtype=torch.int8, device=dev)
            for _ in range(2)]
    out_numel = n * oh * ow * c
    out = (torch.empty(packed_size(out_numel), dtype=torch.uint8, device=dev)
           if pack_out else
           torch.empty((n, oh, ow, c), dtype=torch.int8, device=dev))
    # one allocation, zeroed once: the (L,) work counters, then the
    # (L, 3) counter block
    counters = torch.zeros(nl * (4 if emit_stats else 1), dtype=torch.int32,
                           device=dev)
    stats = counters[nl:].view(nl, 3) if emit_stats else None
    x, w_stack = K.aligned(x), w_stack.contiguous()
    in_bytes = x.numel() if packed_in is not None else 0
    lib = _library()
    err = lib.cutie_fused_trunk(
        x.data_ptr(), in_bytes, n * h * w * cin, w_stack.data_ptr(),
        k * k * cu * c, *[v.data_ptr() for v in vecs],
        bufs[0].data_ptr(), bufs[1].data_ptr(), out.data_ptr(), out_numel,
        int(pack_out), stats.data_ptr() if stats is not None else None,
        counters.data_ptr(), n, nl, geo,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_trunk")
    LAUNCHES["fused_trunk"] += 1
    return (out, stats) if emit_stats else out
