"""Trunk megakernel: L uniform padded layers in one launch, and its plain
twin.

CUTIE streams activations layer to layer without storing partial results
(paper §III-C).  The per-layer path writes every layer's trit map to
device memory and reads it back in the next launch; a trunk runs a
contiguous run of uniform layers in ONE persistent cooperative kernel
(`csrc/fused_trunk.cu`): the blocks run each layer's tiles with the conv
kernel's implicit-GEMM tile body (`csrc/conv_mma.cuh`) on the layer's
plan from :func:`trunk_plan`, a grid-wide barrier separates the layers,
and the activations ping-pong between two device buffers that the trunk
planner (`repro_torch.compiler.trunks`) sizes to stay in the card's L2:
a layer writes each output pixel once, and the next layer reads each
input pixel once per (tile, Cout slice) whose patch holds it.

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


def _pairs(row: dict) -> int:
    """(tile, Cout slice) pairs of a layer's plan: its units of work."""
    return row["slices"] * row["n"] * row["tiles_r"] * row["tiles_c"]


def _layer_rows(n, shapes, metas, cin, c, cu, k, stats_cin, groups,
                sm_count, wides):
    """Every layer's plan at ``groups`` pipelines per block, and the
    co-resident blocks of the trunk; None where a layer does not fit the
    shared memory at that block size.  ``wides`` holds each layer's
    ``wide`` (`ternary_conv2d.check_int16`)."""
    def row(l, ns, tph, tpw, gpb=1):
        (h, w), (stride, pool) = shapes[l], metas[l]
        cin_l = cin if l == 0 else c
        _, _, win, _, _ = K._conv_dims(h, w, k, stride, True, pool)
        lay = K._layout(cin=cin_l, k=k, sh=stride[0], sw=stride[1],
                        th=tph * win, tw=tpw * win, ns=ns, groups=groups)
        return K.plan_row(lay, n=n, h=h, w=w, cin=cin_l, cout=c, k=k,
                          stride=stride, padding=True, pool=pool, tph=tph,
                          tpw=tpw, gpb=gpb, wide=wides[l], w_rows=cu,
                          stat_c=stats_cin if l == 0 else c)

    def smaller(l, cur):             # the 32-channel slice, then the tile
        ns, tph, tpw = cur
        if ns > 32:
            return 32, tph, tpw
        win = row(l, *cur)["win"]
        tile = K.shrink_tile(tph, tpw, win)
        return None if tile is None else (32, *tile)

    plans = []
    for l, ((h, w), (stride, pool)) in enumerate(zip(shapes, metas)):
        _, _, win, ph, pw = K._conv_dims(h, w, k, stride, True, pool)
        cur = (32 if c <= 32 else K._SLICE, *K.first_tile(win, ph, pw))
        while row(l, *cur)["smem"] > K._SMEM_LIMIT:
            cur = smaller(l, cur)
            if cur is None:
                return None
        plans.append(cur)
    slots = sm_count * K.blocks_per_sm(
        max(row(l, *cur)["smem"] for l, cur in enumerate(plans)), groups)
    pipes = slots * groups
    for l, cur in enumerate(plans):  # one round of tiles at most
        while _pairs(row(l, *cur)) < pipes:
            nxt = smaller(l, cur)
            if nxt is None or _pairs(row(l, *nxt)) > pipes:
                break
            cur = plans[l] = nxt
    grid = min(slots, max(_pairs(row(l, *cur)) for l, cur in
                          enumerate(plans)))
    rows = []
    for l, cur in enumerate(plans):
        r = row(l, *cur)
        gpb = min(grid // r["slices"], r["n"] * r["tiles_r"] * r["tiles_c"])
        if gpb < 1:
            raise ValueError(f"layer {l}: {r['slices']} Cout slices exceed "
                             f"the {grid} co-resident blocks")
        rows.append(row(l, *cur, gpb=gpb))
    return rows, slots, grid


def trunk_plan(n: int, h: int, w: int, cin: int, c: int, cu: int, k: int,
               metas, stats_cin: int | None = None,
               sm_count: int = K.SM_COUNT) -> dict:
    """The plan of one trunk launch, from the shapes alone: ``groups`` tile
    pipelines of 4 warps per block (``threads`` = 128 * groups), ``smem``
    bytes of dynamic shared memory, ``grid`` blocks, and ``layers``, one
    ConvPlan (`ternary_conv2d.PLAN_FIELDS`) per layer for the tile body of
    `csrc/conv_mma.cuh`.

    A cooperative launch has one block size and one shared-memory size,
    and its blocks must all be co-resident.  So:

    * each layer starts from the per-layer planner's tile (at most 8 x 8
      conv outputs, sides multiples of the pool window) and a 64-channel
      Cout slice (32 where C <= 32); where that does not fit the shared
      memory at the block size, the slice drops to 32, then the tile's
      longer side halves (`ternary_conv2d.shrink_tile`);
    * the trunk's shared memory is the largest layer's, and its
      co-resident blocks are ``sm_count`` times the blocks of that size
      that fit an SM (`ternary_conv2d.blocks_per_sm`), which times
      ``groups`` gives its pipelines;
    * a layer with fewer (tile, slice) pairs than pipelines takes the
      next smaller plan, the 32-channel slice first and then the halved
      tile, as long as its pairs still do not exceed the pipelines: so
      every pipeline of a small layer gets work, without a second round
      of tiles for any of them;
    * ``groups`` is the value in 4..1 with the most co-resident pipelines
      (the larger on a tie: fewer copies of the weights);
    * the grid is the co-resident blocks, or the largest layer's pairs if
      fewer; each layer gives every Cout slice gpb = min(grid // slices,
      tiles) blocks, and the other blocks sit the layer out.

    Every layer reads its weights at the stack's row stride ``w_rows`` =
    Cu and its input at its own channel count ``cin`` (the head's Cx, then
    C); ``stat_c`` is the head's logical Cin, then C.  A layer is ``wide``
    where its avg window may sum past int16 (`ternary_conv2d.check_int16`
    at the common width Cu), and ``wide`` of the trunk is whether any
    layer is: the kernel then runs every layer on int32 epilogue lanes.
    Raises where a conv output's sum may not fit the tile body's int16
    staging (k*k*Cu >= 32767, the per-layer planner's rule at the common
    width), or no block size fits a layer's shared memory.
    """
    shapes = trunk_shapes((h, w), k, metas)
    wides = []
    for (hl, wl), (stride, pool) in zip(shapes, metas):
        win = K._conv_dims(hl, wl, k, stride, True, pool)[2]
        wides.append(K.check_int16(win, k, cu, pool[0] if pool else None))
    stats_cin = cin if stats_cin is None else stats_cin
    best = None
    for groups in range(K._MAX_GROUPS, 0, -1):
        got = _layer_rows(n, shapes, metas, cin, c, cu, k, stats_cin, groups,
                          sm_count, wides)
        if got is not None and (best is None
                                or got[1] * groups > best[1] * best[3]):
            best = (*got, groups)
    if best is None:
        raise ValueError(f"a layer of the trunk needs more than "
                         f"{K._SMEM_LIMIT} B of shared memory per block")
    rows, _, grid, groups = best
    return dict(groups=groups, threads=groups * K._GROUP_THREADS,
                smem=max(r["smem"] for r in rows), grid=grid,
                wide=int(any(wides)), layers=rows)


@functools.lru_cache(maxsize=256)
def _shape_plan(n, h, w, cin, c, cu, k, metas, stats_cin, sm_count):
    """(grid, threads, smem, the plans as the kernel reads them, the
    output's (OH, OW)): a pure function of the shapes, planned once per
    shape so that repeated runs skip the Python."""
    p = trunk_plan(n, h, w, cin, c, cu, k, metas, stats_cin, sm_count)
    return (p["grid"], p["threads"], p["smem"], K.plan_array(p["layers"]),
            trunk_shapes((h, w), k, metas)[-1])


def _library() -> ctypes.CDLL:
    lib = _build.library("fused_trunk")
    fn = lib.cutie_fused_trunk
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, i64, i64, p, i64, p, p, p, p, p, p, p, p, i64, i32,
                       p, p, i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int),
                       p]
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
    logical Cin (default: the input's channel count).  On a CUDA tensor
    it raises where `trunk_plan` does (a conv output's sum past the tile
    body's int16 staging).

    Replaces `repro.kernels.fused_trunk.fused_trunk_pallas`.
    """
    if x.device.type == "cpu":
        return fused_trunk_plain(
            x, w_stack, t_lo, t_hi, flip, const, is_const, metas=metas,
            packed_in=packed_in, pack_out=pack_out, emit_stats=emit_stats,
            stats_cin=stats_cin)
    return _launch(x, w_stack, t_lo, t_hi, flip, const, is_const,
                   metas=metas, packed_in=packed_in, pack_out=pack_out,
                   emit_stats=emit_stats, stats_cin=stats_cin)[0]


def fused_trunk_timeline(x, w_stack, t_lo, t_hi, flip, const, is_const, *,
                         metas, **kw):
    """:func:`fused_trunk` on a CUDA tensor, also returning where each
    block's time went: an int64 (L, grid, 3) tensor of %globaltimer
    nanoseconds per layer and block, taken when the block starts the layer,
    when its tiles are done and when its counters are done (just before
    the grid barrier that ends the layer).  For measurement: the stamps
    add three block barriers per layer."""
    return _launch(x, w_stack, t_lo, t_hi, flip, const, is_const,
                   metas=metas, timeline=True, **kw)


def _launch(x, w_stack, t_lo, t_hi, flip, const, is_const, *, metas,
            packed_in=None, pack_out=False, emit_stats=False, stats_cin=None,
            timeline=False):
    """Launch the kernel: (the result, the timeline tensor or None)."""
    args, (out, stats, marks), _held = _launch_args(
        x, w_stack, t_lo, t_hi, flip, const, is_const, metas=metas,
        packed_in=packed_in, pack_out=pack_out, emit_stats=emit_stats,
        stats_cin=stats_cin, timeline=timeline)
    lib = _library()
    _build.check(lib, lib.cutie_fused_trunk(*args), "fused_trunk")
    LAUNCHES["fused_trunk"] += 1
    return ((out, stats) if emit_stats else out), marks


def _launch_args(x, w_stack, t_lo, t_hi, flip, const, is_const, *, metas,
                 packed_in=None, pack_out=False, emit_stats=False,
                 stats_cin=None, timeline=False):
    """Check the operands and allocate the outputs: the kernel's arguments
    in the order of ``cutie_fused_trunk``, the (out, stats, marks) they
    write (None where not asked for), and the tensors they read, which the
    caller holds until the launch is enqueued."""
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
    dev = x.device
    grid, threads, smem, plan, (oh, ow) = _shape_plan(
        n, h, w, cin, c, cu, k, key, stats_cin, _sm_count(dev))
    vecs = K.epilogue_vectors(dev, (nl, c), t_lo, t_hi, flip, const,
                              is_const)
    buf_numel = n * h * w * max(cin, c)
    bufs = [torch.empty(buf_numel, dtype=torch.int8, device=dev)
            for _ in range(2)]
    out_numel = n * oh * ow * c
    out = (torch.empty(packed_size(out_numel), dtype=torch.uint8, device=dev)
           if pack_out else
           torch.empty((n, oh, ow, c), dtype=torch.int8, device=dev))
    stats = (torch.zeros((nl, 3), dtype=torch.int32, device=dev)
             if emit_stats else None)
    marks = (torch.zeros((nl, grid, 3), dtype=torch.int64, device=dev)
             if timeline else None)
    x, w_stack = C.aligned(x), C.aligned(w_stack)
    args = (x.data_ptr(), x.numel() if packed_in is not None else 0,
            n * h * w * cin, w_stack.data_ptr(), k * k * cu * c,
            *[v.data_ptr() for v in vecs], bufs[0].data_ptr(),
            bufs[1].data_ptr(), out.data_ptr(), out_numel, int(pack_out),
            stats.data_ptr() if emit_stats else None,
            marks.data_ptr() if timeline else None, nl, grid, threads, smem,
            plan, torch._C._cuda_getCurrentRawStream(dev.index))
    return args, (out, stats, marks), (x, w_stack, *vecs, *bufs)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
