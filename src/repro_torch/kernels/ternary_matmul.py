"""Ternary matrix products: the packed-trit GEMM with a fused epilogue and
its dense int8 twin, kernels and plain versions.

* :func:`ternary_matmul` - x (M, K) int8 trits or bf16/f16/f32 @
  decode(w_packed) (G, N) uint8, byte g of column n holding rows
  5g..5g+4, with the ``scale``, ``threshold`` (t_lo/t_hi/flip) or no
  epilogue; output types exactly as `repro_torch.kernels.ref.
  ternary_matmul`.  K is the logical depth, K <= 5G: trits at or beyond
  K multiply nothing, so `repro_torch.models.common.linear` hands over
  its x unpadded when d_in is not a multiple of 5.  ``round_scale=True``
  rounds ``scale`` to x's float type inside the epilogue (the
  reference's bf16 alpha) instead of in two casts per call;
* :func:`ternary_matmul_dense` - x (M, K) int8 @ w (K, N) int8 -> int32.

On a CUDA tensor each wrapper launches its kernel from
`csrc/ternary_matmul.cu` (``packed = 1`` and ``packed = 0``) or raises;
on a CPU tensor it runs the plain version beside it.  bf16/f16 and int8
x run on the tensor cores, f32 x on the CUDA cores (TF32 would round
x): the route follows x's dtype, never M.  ``LAUNCHES`` counts kernel
launches per wrapper and nothing else.

A ``meta`` tensor (a dry run's walk) gets an output of the right shape
and dtype and nothing is computed.  Each wrapper is also a registered
op (``repro_torch::ternary_matmul``, ``repro_torch::ternary_matmul_dense``)
with a FLOP formula, 2 M K N at the logical K, that
`torch.utils.flop_counter.FlopCounterMode` reads: the wrapper goes
through the op for a ``meta`` tensor and whenever a dispatch mode is
tracing, so a trace sees one op with its operands and result however
the device computes it (`repro_torch.roofline.hlo`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

TRITS_PER_BYTE = 5

LAUNCHES = {"ternary_matmul": 0, "ternary_matmul_dense": 0}

_X_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2,
            torch.float16: 3}
_EPILOGUES = {"none": 0, "scale": 1, "threshold": 2}
_OUT_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2,
              torch.bfloat16: 3, torch.float16: 4}

# The tensor-core kernel's tiling (csrc/ternary_matmul.cu): a block owns
# BLOCK_M rows x BLOCK_N columns and `ups` stages of STAGE_K trits along K.
BLOCK_M, BLOCK_N, STAGE_K = 64, 32, 160
MMA_K = {torch.bfloat16: 16, torch.float16: 16, torch.int8: 32}
SMS = 132                          # H100 SXM streaming multiprocessors
TARGET_BLOCKS = 2 * SMS            # blocks a decode step's projection aims at
MAX_UPS = 3                        # most stages one block walks
# The split-K workspace kept between calls; a call that needs more (M in
# the hundreds) allocates its own, which the caching allocator takes back.
KEEP_WORKSPACE_BYTES = 16 << 20


class Plan(NamedTuple):
    """How one call splits K: ``splits`` blocks along K per output tile,
    each walking ``ups`` stages (the last may walk fewer)."""
    ups: int
    splits: int
    n_tiles: int


@functools.lru_cache(maxsize=None)
def _plan(k: int, n: int, x_dtype: torch.dtype) -> Plan:
    """The K split of a call, a function of (K, N, x's dtype) alone, so a
    row's sum order, and so its bits, never depend on M.  It aims at
    TARGET_BLOCKS blocks per m tile with at most MAX_UPS stages each, and
    at no fewer blocks than K's stages allow."""
    units = max(1, -(-k // STAGE_K))
    n_tiles = -(-n // BLOCK_N)
    if x_dtype not in MMA_K:                 # f32 x: one block spans K
        return Plan(units, 1, n_tiles)
    ups = max(1, min(MAX_UPS, units * n_tiles // TARGET_BLOCKS))
    return Plan(ups, -(-units // ups), n_tiles)


def workspace_bytes(m: int, k: int, n: int, x_dtype: torch.dtype) -> int:
    """Bytes of 32-bit partials one call writes and its fix-up reads back:
    ``splits`` x M x N, so they grow with M."""
    splits = _plan(k, n, x_dtype).splits
    return 4 * splits * m * n if splits > 1 else 0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _epilogue(x: torch.Tensor, scale, t_lo) -> tuple[str, torch.dtype]:
    """(epilogue, output dtype) for x's dtype, as `ref.ternary_matmul`."""
    is_float = x.is_floating_point()
    if t_lo is not None:
        return "threshold", torch.int8
    if scale is not None:
        return "scale", x.dtype if is_float else torch.float32
    return "none", torch.float32 if is_float else torch.int32


def _check(x: torch.Tensor, w: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name} takes x (M, K) and w (rows, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")


def _check_round_scale(x: torch.Tensor, round_scale: bool) -> None:
    if round_scale and not x.is_floating_point():
        raise ValueError("round_scale rounds to x's float type; x is "
                         f"{x.dtype}")


# -- plain versions ----------------------------------------------------------


def ternary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, *,
                         scale=None, t_lo=None, t_hi=None, flip=None,
                         round_scale: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`ternary_matmul` (logical K)."""
    pad = w_packed.shape[0] * TRITS_PER_BYTE - x.shape[1]
    if pad < 0:
        raise ValueError(f"x has K = {x.shape[1]}, more than the "
                         f"{w_packed.shape[0] * TRITS_PER_BYTE} rows of "
                         "w_packed")
    _check_round_scale(x, round_scale)
    if round_scale and scale is not None:
        scale = torch.as_tensor(scale, device=x.device).to(x.dtype).float()
    return _ref.ternary_matmul(F.pad(x, (0, pad)), w_packed, scale=scale,
                               t_lo=t_lo, t_hi=t_hi, flip=flip)


def ternary_matmul_dense_plain(x: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ternary_matmul_dense`."""
    return _ref.ternary_matmul_dense(x, w)


# -- kernels -----------------------------------------------------------------

_FN = None                          # the ctypes function, typed once
_SCRATCH: dict = {}                 # (device, stream) -> [workspace, counters]
# the current stream's handle without a Stream object (CUDA builds)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.library("ternary_matmul").cutie_ternary_matmul
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i32] * 11 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _vec(v, n: int, dtype, dev, what: str) -> torch.Tensor:
    """``v`` as a contiguous (n,) ``dtype`` vector on ``dev``: as it is
    when it already is one, converted (and checked) otherwise."""
    if not (isinstance(v, torch.Tensor) and v.dtype == dtype
            and v.device == dev and v.dim() == 1 and v.is_contiguous()):
        v = torch.as_tensor(v, device=dev).to(dtype).reshape(-1).contiguous()
    if v.numel() != n:
        raise ValueError(f"{what} has {v.numel()} entries, want N = {n}")
    return v


def _scratch(dev, stream: int, nbytes: int, tiles: int):
    """The split-K workspace (``nbytes`` of 32-bit partials) and the
    per-tile arrival counters of one stream.  The counters are kept and
    grown (the kernel's last block per tile resets its counter to zero);
    the workspace is kept up to KEEP_WORKSPACE_BYTES and made for the call
    beyond that."""
    key = (dev, stream)
    cur = _SCRATCH.get(key)
    if cur is None:
        cur = _SCRATCH[key] = [torch.empty(0, dtype=torch.int32, device=dev),
                               torch.zeros(0, dtype=torch.int32, device=dev)]
    words = -(-nbytes // 4)
    if cur[1].numel() < tiles:
        cur[1] = torch.zeros(tiles, dtype=torch.int32, device=dev)
    if nbytes > KEEP_WORKSPACE_BYTES:
        return torch.empty(words, dtype=torch.int32, device=dev), cur[1]
    if cur[0].numel() < words:
        cur[0] = torch.empty(words, dtype=torch.int32, device=dev)
    return cur[0], cur[1]


def _launch_args(x, w, out, eps, rows: int, packed: int, epilogue: str,
                 round_scale: bool):
    """The kernel's arguments for one call, in the order of
    ``cutie_ternary_matmul``, and the scratch tensors they point into,
    which the caller holds until the launch is enqueued."""
    m, k = x.shape
    n = w.shape[1]
    plan = _plan(k, n, x.dtype)
    stream = (_raw_stream(x.get_device()) if _raw_stream is not None
              else torch.cuda.current_stream(x.device).cuda_stream)
    held = ()
    ws = cnt = 0
    if plan.splits > 1:
        held = _scratch(x.device, stream, workspace_bytes(m, k, n, x.dtype),
                        plan.n_tiles * -(-m // BLOCK_M))
        ws, cnt = (t.data_ptr() for t in held)
    ptr = [0 if t is None else t.data_ptr() for t in eps]
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), *ptr, ws, cnt, m, k,
            n, rows, _X_TYPES[x.dtype], packed, _EPILOGUES[epilogue],
            _OUT_TYPES[out.dtype], int(round_scale), plan.ups, plan.splits,
            stream)
    return args, held


def _launch(x, w, out, eps, rows: int, packed: int, epilogue: str,
            round_scale: bool, name: str) -> None:
    args, _held = _launch_args(x, w, out, eps, rows, packed, epilogue,
                               round_scale)
    err = _kernel()(*args)
    if err:
        _build.check(_build.library("ternary_matmul"), err, name)
    LAUNCHES[name] += 1


def _traced(x: torch.Tensor) -> bool:
    """Whether a call goes through its registered op: a ``meta`` x, or
    a dispatch mode tracing."""
    return x.device.type == "meta" or _get_current_dispatch_mode() is not None


def _opt(v, dev):
    return v if v is None or isinstance(v, torch.Tensor) \
        else torch.as_tensor(v, device=dev)


def ternary_matmul(x: torch.Tensor, w_packed: torch.Tensor, *, scale=None,
                   t_lo=None, t_hi=None, flip=None,
                   round_scale: bool = False) -> torch.Tensor:
    """x (M, K) @ decode(w_packed)[:K] with an optional fused epilogue.

    Replaces `repro.kernels.ternary_matmul.ternary_matmul_pallas`.
    """
    _check(x, w_packed, "ternary_matmul")
    if _traced(x):
        return _ternary_matmul_op(x, w_packed,
                                  *(_opt(v, x.device)
                                    for v in (scale, t_lo, t_hi, flip)),
                                  round_scale)
    return _ternary_matmul(x, w_packed, scale=scale, t_lo=t_lo, t_hi=t_hi,
                           flip=flip, round_scale=round_scale)


def _ternary_matmul(x, w_packed, *, scale, t_lo, t_hi, flip, round_scale):
    if not _on_card(x, "ternary_matmul"):
        return ternary_matmul_plain(x, w_packed, scale=scale, t_lo=t_lo,
                                    t_hi=t_hi, flip=flip,
                                    round_scale=round_scale)
    if w_packed.dtype != torch.uint8:
        raise ValueError(f"w_packed must be uint8, got {w_packed.dtype}")
    m, k = x.shape
    rows, n = w_packed.shape
    if k > rows * TRITS_PER_BYTE:
        raise ValueError(f"x has K = {k}, more than the "
                         f"{rows * TRITS_PER_BYTE} rows of w_packed")
    if not x.is_floating_point():
        x = x.to(torch.int8)                 # integer x: trits, as the ref
    elif x.dtype not in _X_TYPES:
        raise ValueError(f"ternary_matmul: no kernel for x of {x.dtype}")
    _check_round_scale(x, round_scale)
    epilogue, out_dtype = _epilogue(x, scale, t_lo)
    dev = x.device
    if epilogue == "threshold":
        if t_hi is None or flip is None:
            raise ValueError("the threshold epilogue needs t_lo, t_hi and "
                             "flip")
        eps = (None, _vec(t_lo, n, torch.float32, dev, "t_lo"),
               _vec(t_hi, n, torch.float32, dev, "t_hi"),
               _vec(flip, n, torch.int8, dev, "flip"))
    elif epilogue == "scale":
        eps = (_vec(scale, n, torch.float32, dev, "scale"), None, None, None)
    else:
        eps = (None, None, None, None)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel():
        _launch(x.contiguous(), w_packed.contiguous(), out, eps, rows, 1,
                epilogue, round_scale, "ternary_matmul")
    return out


def ternary_matmul_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 -> int32.

    Replaces `repro.kernels.ternary_matmul.ternary_matmul_dense_pallas`.
    """
    _check(x, w, "ternary_matmul_dense")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"ternary_matmul_dense: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if _traced(x):
        return _ternary_matmul_dense_op(x, w)
    return _ternary_matmul_dense(x, w)


def _ternary_matmul_dense(x, w):
    if not _on_card(x, "ternary_matmul_dense"):
        return ternary_matmul_dense_plain(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    if out.numel():
        _launch(x.to(torch.int8).contiguous(), w.to(torch.int8).contiguous(),
                out, (None, None, None, None), w.shape[0], 0, "none", False,
                "ternary_matmul_dense")
    return out


# -- the registered ops: one op to a dispatch mode, nothing computed on meta --


@torch.library.custom_op("repro_torch::ternary_matmul", mutates_args=())
def _ternary_matmul_op(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor | None, t_lo: torch.Tensor | None,
                       t_hi: torch.Tensor | None, flip: torch.Tensor | None,
                       round_scale: bool) -> torch.Tensor:
    return _ternary_matmul(x, w_packed, scale=scale, t_lo=t_lo, t_hi=t_hi,
                           flip=flip, round_scale=round_scale)


@_ternary_matmul_op.register_fake
def _(x, w_packed, scale, t_lo, t_hi, flip, round_scale):
    _check_round_scale(x, round_scale)
    _, dtype = _epilogue(x, scale, t_lo)
    return x.new_empty((x.shape[0], w_packed.shape[1]), dtype=dtype)


@torch.library.custom_op("repro_torch::ternary_matmul_dense",
                         mutates_args=())
def _ternary_matmul_dense_op(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    return _ternary_matmul_dense(x, w)


@_ternary_matmul_dense_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.int32)


@register_flop_formula([torch.ops.repro_torch.ternary_matmul,
                        torch.ops.repro_torch.ternary_matmul_dense])
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """2 M K N: x's K is the logical depth (packed rows hold 5 each)."""
    m, k = x_shape
    return 2 * m * k * w_shape[1]
