"""Shared model substrate: the ambient mesh, initializers, norms, linears
(with the packed-trit serving mode), RoPE.

Sharding: model code is written mesh-agnostic, as in the reference.  The
launcher installs a mesh (`set_mesh` / `use_mesh`,
`repro_torch.launch.mesh.Mesh`); with none, every path is the unmeshed
code.  Under a mesh each rank holds the plain local slices of its
parameters (`repro_torch.core.placement.shard_tree`) and the model
code writes out the collectives GSPMD would insert.  Where a leaf or an
activation is sharded is read in one way throughout: its local shape
against its global one (`linear`: a leaf narrower than N is
column-sharded, a local product with its output sharded on N; one
shorter than K is row-sharded, a local product, then an all-reduce over
``model``; a whole leaf with a sharded input all-gathers the input
first).  The KV cache alone carries a flag (`decoding.decode_step`),
since its local length cannot tell a replicated cache from a sharded
one.  The reference's `maybe_scan` has no counterpart: a scan over
stacked layers is a Python loop over a list of per-layer dicts.

Initializers draw from an explicit `torch.Generator`; tensors land on the
generator's device (on the ``meta`` device they allocate nothing).
"""

from __future__ import annotations

import contextlib
import types

import torch

from repro_torch.core import codec
from repro_torch.core import ternary as T
from repro_torch.kernels import ternary_matmul as _mm

# ---------------------------------------------------------------------------
# Ambient mesh
# ---------------------------------------------------------------------------

#: the process's ambient mesh: not a thread-local, since the autograd
#: engine runs a card's backward (and the recompute of a checkpointed
#: block in it) on a thread of its own
_STATE = types.SimpleNamespace(mesh=None)

BATCH = ("pod", "data")     # canonical batch-sharding axes
MODEL = "model"


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def get_mesh():
    return _STATE.mesh


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def tp_mesh():
    """The ambient mesh where its ``model`` axis has more than one rank
    (tensor parallelism), else None."""
    mesh = get_mesh()
    return mesh if mesh is not None and mesh.axis_size(MODEL) > 1 else None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ambient mesh's batch axes (each rank holds
    its batch rows); ``t`` itself without a mesh."""
    mesh = get_mesh()
    return t if mesh is None else mesh.all_reduce(t, BATCH)


def full_width(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last dim whole (``n``): all-gathered over ``model``
    where each rank holds an equal slice of it."""
    if x.shape[-1] == n:
        return x
    mesh = tp_mesh()
    if mesh is None or x.shape[-1] * mesh.axis_size(MODEL) != n:
        raise ValueError(f"an input of width {x.shape[-1]} is neither "
                         f"whole ({n}) nor a model slice of it")
    return mesh.all_gather(x, MODEL, dim=-1)


def width_range(x: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of the width-``n`` activation whose local part is
    ``x`` (whole, or this rank's equal model slice): a view where this
    rank holds them, else a slice of the all-gathered whole."""
    mesh = tp_mesh()
    if x.shape[-1] != n and mesh is not None:
        w = x.shape[-1]
        own = mesh.coord(MODEL) * w
        if (lo, hi) == (own, own + w):
            return x
    return full_width(x, n)[..., lo:hi]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), device="meta")
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, shape, dtype=torch.bfloat16, scale=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    return (_normal(gen, shape) * std).to(dtype)


def embed_init(gen, shape, dtype=torch.bfloat16):
    std = shape[-1] ** -0.5           # keeps tied-head logits O(1)
    return (_normal(gen, shape) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6, bf16_mul: bool = False):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if bf16_mul:
        # f32 reduction only; the full-width normalize stays in x.dtype
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * p["scale"]
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def layernorm_init(dim, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Linear with quantization modes (the paper's technique as a feature)
# ---------------------------------------------------------------------------


def linear_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16,
                quant: str = "none"):
    p = {"w": dense_init(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    if quant == "ternary_packed" and gen.device.type == "meta":
        p.pop("w")
        p["w_packed"] = torch.empty((-(-d_in // 5), d_out), dtype=torch.uint8,
                                    device="meta")
        p["scale"] = torch.empty((d_out,), dtype=torch.float32, device="meta")
    elif quant == "ternary_packed":
        # Serving representation: pure trits packed 5/byte along d_in
        # (each column's tail padded with trit 0), plus the folded
        # per-column TWN scale (paper §III-A/§III-C).
        w = p.pop("w").to(torch.float32)
        delta = T.twn_delta(w, axis=(0,))
        trits = T.ternarize(w, delta)
        alpha = T.twn_scale(w, trits, axis=(0,)).reshape(-1)
        p["w_packed"] = codec.pack_rows(trits.T.to(torch.int8)).T.contiguous()
        p["scale"] = alpha.to(torch.float32)
    return p


def linear(p, x, *, quant: str = "none",
           dims: tuple[int, int] | None = None):
    """Apply a (possibly ternary) linear layer.

    quant modes:
      none           - plain matmul,
      ternary        - QAT: STE-ternarized weights (per-column scale),
      ternary_packed - serving: ``x @ (decode(w_packed)[:d_in] * alpha)``
                       through the packed-trit kernel
                       (`repro_torch.kernels.ternary_matmul`), x flattened
                       to (rows, d_in) and handed over unpadded (the
                       packed rows are padded to a multiple of 5).
    The reference multiplies the trits by alpha rounded to x's dtype, so
    the kernel's scale epilogue rounds alpha the same way
    (``round_scale``): each ``trit * alpha`` is then the reference's exact
    weight, and the two differ only in the order of the f32 sum.

    Under a tensor-parallel mesh (`tp_mesh`) the leaf is a rank's slice:
    ``dims``, the global (d_in, d_out), against its local shape tells
    how it is cut, and `_linear_tp` acts on it.
    """
    mesh = tp_mesh()
    if mesh is not None:
        if dims is None:
            raise ValueError("a linear under a tensor-parallel mesh needs "
                             "its global dims")
        return _linear_tp(p, x, quant, dims, mesh)
    return _linear(p, x, quant)


def _linear(p, x, quant, psum=None, n_shards: int = 1):
    if quant == "ternary_packed":
        lead = x.shape[:-1]
        y = _mm.ternary_matmul(x.reshape(-1, x.shape[-1]), p["w_packed"],
                               scale=p["scale"], round_scale=True
                               ).reshape(*lead, -1)
    elif quant == "ternary":
        y = x @ T.ternarize_ste(p["w"], axis=(0,), psum=psum,
                                n_shards=n_shards)
    elif quant == "none":
        y = x @ p["w"]
    else:
        raise ValueError(f"unknown linear quant {quant!r}")
    if "b" in p:
        y = y + p["b"]
    return y


def _linear_tp(p, x, quant, dims, mesh):
    """`linear` on this rank's slice of the leaf (see `linear`).

    A leaf with fewer rows than the global leaf (K, or ceil(K / 5)
    packed) is row-sharded and holds K rows [k0, k1): a dense ``w`` its
    equal share, a ``w_packed`` leaf its share of the packed byte rows,
    5 K rows each (the last slice ends at K), which need not match the
    input's own slice (the input is then all-gathered and cut).  Under
    ``quant="ternary"`` the per-column TWN statistics of a row-sharded
    ``w`` are sums over K, all-reduced over ``model`` before the
    threshold, so every rank takes the unsharded trits."""
    k, _ = dims
    packed = quant == "ternary_packed"
    rows = p["w_packed" if packed else "w"].shape[0]
    if rows == (-(-k // 5) if packed else k):   # column-cut or whole
        return _linear(p, full_width(x, k), quant)
    k0 = mesh.coord(MODEL) * rows * (5 if packed else 1)
    k1 = min(k, k0 + rows * (5 if packed else 1))
    xs = width_range(x, k, k0, k1)
    unbiased = {key: v for key, v in p.items() if key != "b"}
    y = _linear(unbiased, xs, quant,
                psum=lambda t: mesh.all_reduce(t, MODEL),
                n_shards=mesh.axis_size(MODEL))
    y = mesh.all_reduce(y, MODEL)
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
