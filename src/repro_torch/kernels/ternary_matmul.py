"""Ternary matrix products: the packed-trit GEMM with a fused epilogue and
its dense int8 twin, kernels and plain versions.

* :func:`ternary_matmul` - x (M, K) int8 trits or bf16/f16/f32 @
  decode(w_packed) (G, N) uint8, byte g of column n holding rows
  5g..5g+4, with the ``scale``, ``threshold`` (t_lo/t_hi/flip) or no
  epilogue; output types exactly as `repro_torch.kernels.ref.
  ternary_matmul`.  K is the logical depth, K <= 5G: trits at or beyond
  K multiply nothing, so `repro_torch.models.common.linear` hands over
  its x unpadded when d_in is not a multiple of 5;
* :func:`ternary_matmul_dense` - x (M, K) int8 @ w (K, N) int8 -> int32.

On a CUDA tensor each wrapper launches its kernel from
`csrc/ternary_matmul.cu` (``packed = 1`` and ``packed = 0``) or raises;
on a CPU tensor it runs the plain version beside it.  ``LAUNCHES`` counts
kernel launches per wrapper and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

TRITS_PER_BYTE = 5

LAUNCHES = {"ternary_matmul": 0, "ternary_matmul_dense": 0}

_X_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2,
            torch.float16: 3}
_EPILOGUES = {"none": 0, "scale": 1, "threshold": 2}
_OUT_TYPES = {torch.int8: 0, torch.int32: 1, torch.float32: 2,
              torch.bfloat16: 3, torch.float16: 4}


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


# -- plain versions ----------------------------------------------------------


def ternary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, *,
                         scale=None, t_lo=None, t_hi=None, flip=None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ternary_matmul` (logical K)."""
    pad = w_packed.shape[0] * TRITS_PER_BYTE - x.shape[1]
    if pad < 0:
        raise ValueError(f"x has K = {x.shape[1]}, more than the "
                         f"{w_packed.shape[0] * TRITS_PER_BYTE} rows of "
                         "w_packed")
    return _ref.ternary_matmul(F.pad(x, (0, pad)), w_packed, scale=scale,
                               t_lo=t_lo, t_hi=t_hi, flip=flip)


def ternary_matmul_dense_plain(x: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ternary_matmul_dense`."""
    return _ref.ternary_matmul_dense(x, w)


# -- kernels -----------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.library("ternary_matmul")
    fn = lib.cutie_ternary_matmul
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i32] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib


def _on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _vec(v, n: int, dtype, dev, what: str) -> torch.Tensor:
    v = torch.as_tensor(v, device=dev).to(dtype).reshape(-1).contiguous()
    if v.numel() != n:
        raise ValueError(f"{what} has {v.numel()} entries, want N = {n}")
    return v


def _launch(x, w, out, eps, rows: int, packed: int, epilogue: str,
            name: str) -> None:
    m, k = x.shape
    n = w.shape[1]
    ptr = [0 if t is None else t.data_ptr() for t in eps]
    lib = _library()
    err = lib.cutie_ternary_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), *ptr, m, k, n, rows,
        _X_TYPES[x.dtype], packed, _EPILOGUES[epilogue],
        _OUT_TYPES[out.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, name)
    LAUNCHES[name] += 1


def ternary_matmul(x: torch.Tensor, w_packed: torch.Tensor, *, scale=None,
                   t_lo=None, t_hi=None, flip=None) -> torch.Tensor:
    """x (M, K) @ decode(w_packed)[:K] with an optional fused epilogue.

    Replaces `repro.kernels.ternary_matmul.ternary_matmul_pallas`.
    """
    _check(x, w_packed, "ternary_matmul")
    if not _on_card(x, "ternary_matmul"):
        return ternary_matmul_plain(x, w_packed, scale=scale, t_lo=t_lo,
                                    t_hi=t_hi, flip=flip)
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
                epilogue, "ternary_matmul")
    return out


def ternary_matmul_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 -> int32.

    Replaces `repro.kernels.ternary_matmul.ternary_matmul_dense_pallas`.
    """
    _check(x, w, "ternary_matmul_dense")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"ternary_matmul_dense: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if not _on_card(x, "ternary_matmul_dense"):
        return ternary_matmul_dense_plain(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    if out.numel():
        _launch(x.to(torch.int8).contiguous(), w.to(torch.int8).contiguous(),
                out, (None, None, None, None), w.shape[0], 0, "none",
                "ternary_matmul_dense")
    return out
