"""Ternary K x K conv with the fused OCU epilogue: kernels and plain twins.

Two weight layouts, as in the reference:

* :func:`ternary_conv2d` - dense int8 trits (K, K, Cin, Cout);
* :func:`ternary_conv2d_packed` - (Cout, G) uint8 rows at 5 trits per
  byte (`repro_torch.core.codec.pack_filter_rows`), decoded inside the
  kernel so the dense weights never exist in device memory.

On a CUDA tensor each wrapper launches its kernel from
`csrc/ternary_conv2d.cu` (built by `repro_torch.kernels._build`) or
raises; on a CPU tensor it runs the plain version beside it.
``LAUNCHES`` counts kernel launches per wrapper and nothing else.

With thresholds (t_lo/t_hi/flip, optionally const/is_const and a merged
``pool``) the output is int8 trits; without, raw int32.  ``emit_stats``
returns ``(y, stats)`` with stats the (3,) int32 (in-zero, out-zero,
window-toggle) totals: in-zero over the whole unpadded batch, out-zero
over the output, toggle over image 0's stride-1 window raster.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.codec import TRITS_PER_BYTE
from repro_torch.core.engine import conv2d_int, conv_out_dims
from repro_torch.kernels import _build
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels.trit_codec import aligned, unpack_digits

LAUNCHES = {"ternary_conv2d": 0, "ternary_conv2d_packed": 0}

_SMEM_LIMIT = 232448      # bytes of shared memory a block may use
_POOL_KIND = {None: 0, "max": 1, "avg": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_epilogue(t_lo, pool, emit_stats) -> bool:
    fuse = t_lo is not None
    if pool is not None and not fuse:
        raise ValueError("merged pooling requires the fused threshold "
                         "epilogue (t_lo/t_hi/flip)")
    if emit_stats and not fuse:
        raise ValueError("emit_stats requires the fused threshold "
                         "epilogue (t_lo/t_hi/flip): raw int32 outputs "
                         "have no trit statistics")
    return fuse


def _unpack_rows(w_packed: torch.Tensor, k: int, cin: int) -> torch.Tensor:
    """(Cout, G) packed rows -> (K, K, Cin, Cout) int8 trits."""
    cout = w_packed.shape[0]
    trits = unpack_digits(w_packed).reshape(cout, -1)[:, :k * k * cin]
    return trits.reshape(cout, k, k, cin).permute(1, 2, 3, 0).to(torch.int8)


def plain_stats(x, y, k: int, padding: bool) -> torch.Tensor:
    """The (3,) int32 (in-zero, out-zero, window-toggle) counters of one
    layer, plain: what the kernels add up with atomics."""
    _, h, w, cin = x.shape
    if padding:
        p = k // 2
        xp = F.pad(x[0], (0, 0, p, p, p, p))
        wh, ww = h, w
    else:
        xp, wh, ww = x[0], h - k + 1, w - k + 1
    return torch.stack([epi.zero_count(x), epi.zero_count(y),
                        epi.window_toggle_count(xp, k, wh, ww, cin)])


def ternary_conv2d_plain(x, w, *, stride=(1, 1), padding=True, t_lo=None,
                         t_hi=None, flip=None, const=None, is_const=None,
                         pool=None, emit_stats: bool = False):
    """Plain PyTorch version of :func:`ternary_conv2d`."""
    fuse = _check_epilogue(t_lo, pool, emit_stats)
    z = conv2d_int(x, w, stride, padding)
    if not fuse:
        return z
    y = epi.layer_epilogue(z, t_lo, t_hi, flip, const, is_const, pool)
    if emit_stats:
        return y, plain_stats(x, y, w.shape[0], padding)
    return y


def ternary_conv2d_packed_plain(x, w_packed, *, k: int, cin: int,
                                stride=(1, 1), padding=True, t_lo=None,
                                t_hi=None, flip=None, const=None,
                                is_const=None, pool=None,
                                emit_stats: bool = False):
    """Plain PyTorch version of :func:`ternary_conv2d_packed`."""
    return ternary_conv2d_plain(
        x, _unpack_rows(w_packed, k, cin), stride=stride, padding=padding,
        t_lo=t_lo, t_hi=t_hi, flip=flip, const=const, is_const=is_const,
        pool=pool, emit_stats=emit_stats)


def _conv_dims(h, w, k, stride, padding, pool):
    """(oh, ow, win, ph, pw), raising on a kernel or pool window that does
    not fit the map."""
    oh, ow = conv_out_dims(k, stride, padding, h, w)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"unpadded kernel {k} does not fit {h}x{w}")
    win = pool[1] if pool is not None else 1
    ph, pw = oh // win, ow // win
    if ph == 0 or pw == 0:
        raise ValueError(f"pool window {win} exceeds the {oh}x{ow} conv "
                         "output")
    return oh, ow, win, ph, pw


#: The int fields of `csrc/conv_mma.cuh` ConvPlan, in declaration order.
PLAN_FIELDS = ("n", "h", "w", "cin", "cout", "k", "sh", "sw", "pad", "win",
               "kind", "ph", "pw", "fuse", "wh", "ww", "row_bytes", "w_rows",
               "stat_c", "th", "tw", "tiles_r", "tiles_c", "ns", "slices",
               "gpb", "cp", "pr", "pc", "ps", "direct", "raw_row",
               "b_stride", "groups", "off_epi", "off_grp", "grp_bytes",
               "off_buf0", "off_buf1", "off_unp", "smem", "wide")

SM_COUNT = 132            # streaming multiprocessors of an H100 SXM
_SM_SMEM = 233472         # shared memory of one SM
_BLOCK_RESERVED = 1024    # shared memory the runtime keeps per block
_MAX_GROUPS = 4           # tile pipelines of 4 warps in one block
_GROUP_THREADS = 128      # threads of one tile pipeline
_MIN_TILE_PIXELS = 16     # the planner shrinks tiles no further
_ROWS = 64                # GEMM rows of a tile: its pixels, padded
_SLICE = 64               # output channels per block where Cout > 32
_FILL = 0.95              # least share of the SMs a plan must occupy


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _layout(*, cin, k, sh, sw, th, tw, ns, groups) -> dict:
    """Tile geometry and shared-memory layout of the tile body for conv
    tile sides (th, tw), a Cout slice of ns channels and ``groups`` tile
    pipelines: the slice's weights, its epilogue vectors, then each
    pipeline's buffers."""
    cp = -(-cin // 32) * 32
    ps = cp + 16                       # odd multiple of 16: no bank clash
    pr, pc = (th - 1) * sh + k, (tw - 1) * sw + k
    b_stride = k * k * cp + 16
    # the compute buffer holds the patch, then the int16 sums
    slot = _r16(max(pr * pc * ps, _ROWS * (ns + 8) * 2))
    direct = cin % 16 == 0
    if direct:                         # ring: two compute buffers
        raw_row, buf1, unp, grp = 0, slot, 0, 2 * slot
    else:                              # one raw buffer, refilled after the
        raw_row = _r16(pc * cin + 15)  # repack; one compute buffer
        raw = _r16(pr * raw_row)
        buf1, unp, grp = 0, raw, raw + slot
    off_epi = ns * b_stride
    off_grp = off_epi + _r16(11 * ns)
    return dict(th=th, tw=tw, ns=ns, cp=cp, pr=pr, pc=pc, ps=ps,
                direct=int(direct), raw_row=raw_row, b_stride=b_stride,
                groups=groups, off_epi=off_epi, off_grp=off_grp,
                grp_bytes=grp, off_buf0=0, off_buf1=buf1, off_unp=unp,
                smem=off_grp + groups * grp)


def blocks_per_sm(smem: int, groups: int) -> int:
    """Blocks of the tile body that fit on one SM: by shared memory, and
    by registers, of which the kernel takes up to 128 a thread, so that
    _MAX_GROUPS pipelines of 128 threads fill an SM's 65,536."""
    return max(1, min(_MAX_GROUPS // groups,
                      _SM_SMEM // (smem + _BLOCK_RESERVED)))


_INT16_LIMIT = 32767      # the tile body stages sums as int16
_F32_EXACT = 1 << 24      # integers exact in the plain version's float32


def check_int16(win: int, k: int, cin: int, kind) -> int:
    """The tile body's rule for its int16 lanes; returns the plan's
    ``wide`` (0 or 1).

    * Each conv output's sum, |z| <= k*k*Cin, is staged as int16: raise
      where k*k*Cin >= 32767.
    * A max pool picks one of those values, so it fits as well.
    * An avg pool sums win*win of them: where win*win*k*k*Cin >= 32767 the
      window sum, the compare and the const fixup run on int32 lanes
      (``wide`` = 1, `EpilogueWide` of `csrc/conv_mma.cuh`); raise where
      that sum may reach 2**24, past which the plain version's float32
      compare rounds.
    """
    if k * k * cin >= _INT16_LIMIT:
        raise ValueError(f"k*k*Cin = {k * k * cin} >= {_INT16_LIMIT}: a "
                         "conv output's sum may not fit the kernel's int16 "
                         "staging")
    window = win * win * k * k * cin
    if kind != "avg" or window < _INT16_LIMIT:
        return 0
    if window >= _F32_EXACT:
        raise ValueError(f"win*win*k*k*Cin = {window} >= 2**24: an avg "
                         "window's sum may not be exact in the plain "
                         "version's float32 compare")
    return 1


def first_tile(win: int, ph: int, pw: int) -> tuple[int, int]:
    """The largest tile in pooled pixels: at most 8 x 8 conv outputs, sides
    multiples of the pool window (6 x 6 for a window of 3)."""
    side = max(1, 8 // win)
    return min(side, ph), min(side, pw)


def shrink_tile(a: int, b: int, win: int):
    """A tile of (a, b) pooled pixels with its longer side halved, or None
    at _MIN_TILE_PIXELS conv outputs."""
    if a * b * win * win <= _MIN_TILE_PIXELS:
        return None
    if a >= b and a > 1:
        return -(-a // 2), b
    return (a, -(-b // 2)) if b > 1 else None


def plan_row(lay: dict, *, n, h, w, cin, cout, k, stride, padding, pool,
             tph, tpw, gpb, wide, fuse=True, row_bytes=0, w_rows=None,
             stat_c=None) -> dict:
    """A layer's ConvPlan (PLAN_FIELDS) from its layout (`_layout`), its
    tile of (tph, tpw) pooled pixels, its blocks per Cout slice and its
    epilogue's lanes (`check_int16`)."""
    _, _, win, ph, pw = _conv_dims(h, w, k, stride, padding, pool)
    return dict(lay, n=n, h=h, w=w, cin=cin, cout=cout, k=k, sh=stride[0],
                sw=stride[1], pad=k // 2 if padding else 0, win=win,
                kind=_POOL_KIND[pool[0] if pool else None], ph=ph, pw=pw,
                fuse=int(fuse), wide=wide, wh=h if padding else h - k + 1,
                ww=w if padding else w - k + 1, row_bytes=row_bytes,
                w_rows=cin if w_rows is None else w_rows,
                stat_c=cin if stat_c is None else stat_c,
                tiles_r=-(-ph // tph), tiles_c=-(-pw // tpw),
                slices=-(-cout // lay["ns"]), gpb=gpb)


def conv_plan(n: int, h: int, w: int, cin: int, cout: int, k: int, stride,
              padding: bool, pool, *, fuse: bool = True, row_bytes: int = 0,
              stat_c: int | None = None) -> dict:
    """One layer's ConvPlan for the implicit-GEMM tile body of
    `csrc/conv_mma.cuh`, from the shape alone.

    * The tile is th x tw conv outputs, at most 8 x 8, whose sides are
      multiples of the pool window, so that a window never spans two
      tiles (6 x 6 for a window of 3).
    * The Cout slice is _SLICE (64) channels, or 32 where Cout <= 32.
    * Where (tiles x slices) would give fewer blocks than the card's
      SM_COUNT, the slice drops to 32, then the tile's longer side halves
      (in pooled pixels) down to _MIN_TILE_PIXELS conv outputs.
    * A block runs ``groups`` tile pipelines of 4 warps on one copy of the
      slice's weights: the most (up to 4) that fit its shared memory and
      still give blocks for _FILL of the SMs, else 1.
    * The grid is persistent: each slice gets gpb = ceil(tiles / groups)
      blocks, raised to SM_COUNT / slices where there are as many tiles,
      and capped at slots // slices, slots being the blocks that fit on
      the card at once.

    * ``wide`` is 1 where an avg window may sum past int16 (`check_int16`).

    Raises on what the kernel does not take: an unpadded kernel larger
    than the map, a pool window larger than the conv output, a conv
    output's sum that may not fit the kernel's int16 staging (k*k*Cin >=
    32767), or a tile that needs more shared memory than a block has.
    """
    sh, sw = stride
    _, _, win, ph, pw = _conv_dims(h, w, k, stride, padding, pool)
    wide = check_int16(win, k, cin, pool[0] if pool else None)
    tph, tpw = first_tile(win, ph, pw)
    ns = 32 if cout <= 32 else _SLICE

    def tiles(a, b):
        return n * -(-ph // a) * -(-pw // b)

    while tiles(tph, tpw) * -(-cout // ns) < SM_COUNT:
        if ns > 32:
            ns = 32
        elif (smaller := shrink_tile(tph, tpw, win)) is not None:
            tph, tpw = smaller
        else:
            break
    while True:
        slices, nt = -(-cout // ns), tiles(tph, tpw)
        fits = []
        for groups in range(_MAX_GROUPS, 0, -1):
            lay = _layout(cin=cin, k=k, sh=sh, sw=sw, th=tph * win,
                          tw=tpw * win, ns=ns, groups=groups)
            if lay["smem"] > _SMEM_LIMIT:
                continue
            slots = blocks_per_sm(lay["smem"], groups) * SM_COUNT
            gpb = min(-(-nt // groups), max(1, slots // slices))
            fits.append((lay, max(1, slots // slices)))
            if slices * gpb >= min(_FILL * SM_COUNT, slices * nt):
                break
        if fits:
            lay, cap = fits[-1]
            # at least SM_COUNT blocks where the tiles allow: a block whose
            # pipelines find no tile stages its weights and ends
            gpb = min(max(-(-nt // lay["groups"]), -(-SM_COUNT // slices)),
                      nt, cap)
            break
        if ns > 32:
            ns = 32
        elif (smaller := shrink_tile(tph, tpw, win)) is not None:
            tph, tpw = smaller
        else:
            raise ValueError(f"layer needs {lay['smem']} B of shared "
                             f"memory per block, more than {_SMEM_LIMIT}")
    return plan_row(lay, n=n, h=h, w=w, cin=cin, cout=cout, k=k,
                    stride=stride, padding=padding, pool=pool, tph=tph,
                    tpw=tpw, gpb=gpb, wide=wide, fuse=fuse,
                    row_bytes=row_bytes, stat_c=stat_c)


def plan_array(rows) -> ctypes.Array:
    """ConvPlan rows (PLAN_FIELDS) as the flat C int array the kernels
    read."""
    flat = [int(g[f]) for g in rows for f in PLAN_FIELDS]
    return (ctypes.c_int * len(flat))(*flat)


def epilogue_vectors(dev, shape, t_lo, t_hi, flip, const, is_const):
    """Thresholds as contiguous tensors of ``shape`` on ``dev``, float32
    (t_lo, t_hi) or one byte per channel (flip, const, is_const: int8, or
    bool, whose bytes are the same 0 and 1): the pointers the kernels read.
    Tensors that already are pass through without a copy."""
    def vec(v, dtypes):
        if not (isinstance(v, torch.Tensor) and v.dtype in dtypes
                and v.device == dev and v.is_contiguous()
                and v.shape == shape):
            v = torch.as_tensor(v, device=dev).to(dtypes[0]).contiguous()
            v = v.reshape(shape)
        return v
    f32, byte = (torch.float32,), (torch.int8, torch.bool)
    out = [vec(t_lo, f32), vec(t_hi, f32), vec(flip, byte)]
    if const is not None:
        out += [vec(const, byte), vec(is_const, byte)]
    return out


@functools.lru_cache(maxsize=256)
def _plan_array(n, h, w, cin, cout, k, stride, padding, pool, fuse,
                row_bytes) -> tuple[int, int, ctypes.Array]:
    """(PH, PW, the ConvPlan as the kernel reads it), planned once per
    shape: the plan is pure Python and would cost tens of microseconds of
    host time on every call."""
    g = conv_plan(n, h, w, cin, cout, k, stride, padding, pool, fuse=fuse,
                  row_bytes=row_bytes)
    return g["ph"], g["pw"], plan_array([g])


def _library() -> ctypes.CDLL:
    lib = _build.library("ternary_conv2d")
    fn = lib.cutie_ternary_conv2d
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, x, w, *, packed: bool, k: int, cin: int, cout: int,
            row_bytes: int, stride, padding, t_lo, t_hi, flip, const,
            is_const, pool, emit_stats):
    """Check the operands, allocate the outputs and launch one kernel."""
    fuse = _check_epilogue(t_lo, pool, emit_stats)
    dev = x.device
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin) int8, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, weights {cin}")
    if w.device != dev:
        raise ValueError(f"weights on {w.device}, x on {dev}")
    n, h, wd, _ = x.shape
    if not 1 <= n <= 65535:
        raise ValueError(f"batch {n} outside 1..65535")
    ph, pw, plan = _plan_array(n, h, wd, cin, cout, k, tuple(stride),
                               bool(padding), tuple(pool) if pool else None,
                               fuse, row_bytes)
    x, w = aligned(x), aligned(w)
    vecs = (epilogue_vectors(dev, (cout,), t_lo, t_hi, flip, const,
                             is_const) if fuse else [])
    out = torch.empty((n, ph, pw, cout),
                      dtype=torch.int8 if fuse else torch.int32, device=dev)
    stats = (torch.zeros(3, dtype=torch.int32, device=dev) if emit_stats
             else None)
    ptrs = [v.data_ptr() for v in vecs]
    ptrs += [None] * (5 - len(ptrs))
    lib = _library()
    err = lib.cutie_ternary_conv2d(
        int(packed), x.data_ptr(), w.data_ptr(), *ptrs, out.data_ptr(),
        stats.data_ptr() if stats is not None else None, plan,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return (out, stats) if emit_stats else out


def ternary_conv2d(x, w, *, stride=(1, 1), padding=True, t_lo=None,
                   t_hi=None, flip=None, const=None, is_const=None,
                   pool=None, emit_stats: bool = False):
    """NHWC trit conv.  x (N,H,W,Cin) int8, w (K,K,Cin,Cout) int8.

    Replaces `repro.kernels.ternary_conv2d.ternary_conv2d_pallas`.
    """
    if x.device.type == "cpu":
        return ternary_conv2d_plain(
            x, w, stride=stride, padding=padding, t_lo=t_lo, t_hi=t_hi,
            flip=flip, const=const, is_const=is_const, pool=pool,
            emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError(f"w must be (K, K, Cin, Cout) int8, got {w.dtype} "
                         f"{tuple(w.shape)}")
    k, _, cin, cout = w.shape
    return _launch("ternary_conv2d", x, w, packed=False, k=k, cin=cin,
                   cout=cout, row_bytes=0, stride=stride, padding=padding,
                   t_lo=t_lo, t_hi=t_hi, flip=flip, const=const,
                   is_const=is_const, pool=pool, emit_stats=emit_stats)


def ternary_conv2d_packed(x, w_packed, *, k: int, cin: int, stride=(1, 1),
                          padding=True, t_lo=None, t_hi=None, flip=None,
                          const=None, is_const=None, pool=None,
                          emit_stats: bool = False):
    """Conv from packed (Cout, G) uint8 weight rows, decoded in the kernel.

    Replaces `repro.kernels.ternary_conv2d.ternary_conv2d_packed_pallas`.
    """
    cout, g = w_packed.shape
    if g * TRITS_PER_BYTE < k * k * cin:
        raise ValueError(f"{g} bytes per row cannot hold {k}x{k}x{cin} "
                         "trits")
    if x.device.type == "cpu":
        return ternary_conv2d_packed_plain(
            x, w_packed, k=k, cin=cin, stride=stride, padding=padding,
            t_lo=t_lo, t_hi=t_hi, flip=flip, const=const, is_const=is_const,
            pool=pool, emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w_packed.dtype != torch.uint8:
        raise ValueError(f"w_packed must be uint8, got {w_packed.dtype}")
    return _launch("ternary_conv2d_packed", x, w_packed, packed=True, k=k,
                   cin=cin, cout=cout, row_bytes=g, stride=stride,
                   padding=padding, t_lo=t_lo, t_hi=t_hi, flip=flip,
                   const=const, is_const=is_const, pool=pool,
                   emit_stats=emit_stats)
