#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card and check it.

    python3 chip_smoke.py

Phases, each of which fails the script (no result line) when it fails:

1. the card's name and power limit, from nvidia-smi;
2. build every kernel from `src/repro_torch/csrc/` with nvcc (sm_90a);
3. hold each kernel against its plain PyTorch version on the card: the
   conv kernels on the full-width CIFAR layer shapes plus odd-channel,
   stride-2/3, unpadded, raw-int32 and const-channel cases;
   the trunk megakernel on the full CIFAR trunk at batch 64, its two-trunk
   split through a packed boundary, odd C = 13 with a head Cin of 6, and
   stride 2 + avg pool; the codec and thermometer kernels at the main
   path's shapes and at lengths that are not a multiple of 5 x 128;
   counters included; the packed ternary matmul (every epilogue, int8 and
   bf16 x, M in {1, 4, 37, 128}, ragged N, a logical K that is not a
   multiple of 5, and the seven llama3.2-1B projections at M = 4 and 64)
   and the dense int8 matmul: int8 x bit for bit, bf16 x within the
   tolerances stated below;
4. the main path: the paper's CIFAR-10 network (Table III, full width:
   126 -> 128 channels, 32 x 32, 8 layers, max-pools after layers 2, 4, 6
   and avg-pool 4 after layer 7) compiled with `engine.compile_layer`
   from seeded weights, its batch-64 input encoded by the thermometer
   kernel, run through `CutiePipeline.run`, a traced run and `measure` on
   the ``cuda``, ``packed`` and ``fused`` backends and on ``fused`` with
   an L2 budget that splits the program into two trunks joined by packed
   bytes; outputs, tracer rows and energy rows must equal the ``ref``
   backend's on the same card, each conv kernel's launch count must grow
   by 8 per run, the trunk kernel's by 1 (2 when split) with no conv
   launch; then the codec entry points pack and unpack the split's
   boundary trits, which must equal the trunk kernel's own packed bytes.
   Then the second main path, LLM serving: llama3.2-1B at full width and
   depth with ``quant="ternary_packed"``, seeded random weights on the
   card, 8 requests of 40 tokens (a shared 32-token prefix + 8 distinct)
   through `CutieEngine` + `LLMExecutor` with the default `ServerConfig`
   (paged, 4 slots, max_len 256, block 16, greedy), 16 new tokens each:
   every request must return 16 tokens, the prefix cache must hit, the
   packed matmul kernel must launch 7 x 16 times per model forward
   (prefill or decode step), the same requests served contiguous must give
   the same tokens, and one prefill's logits with the plain matmul must
   agree with the kernel's within ``LOGIT_TOL``;
5. time the whole program (`run`, `measure`) per backend on the host
   clock, then each kernel at the main path's shapes beside its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call as a library yardstick (f32 `F.conv2d`; bf16 `torch.matmul`
   on pre-decoded weights; `torch._int_mm`); then the serving times
   (decode step, prefill, tokens/s, latency p50/p99) of the LLM path and
   of the same requests on ``quant="none"``, the bf16 baseline.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero without a card, and
when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BATCH = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
SOURCE = {
    "ternary_conv2d": "src/repro_torch/csrc/ternary_conv2d.cu",
    "ternary_conv2d_packed": "src/repro_torch/csrc/ternary_conv2d.cu",
    "fused_trunk": "src/repro_torch/csrc/fused_trunk.cu",
    "pack_trits": "src/repro_torch/csrc/trit_codec.cu",
    "unpack_trits": "src/repro_torch/csrc/trit_codec.cu",
    "thermometer": "src/repro_torch/csrc/trit_codec.cu",
    "ternary_matmul": "src/repro_torch/csrc/ternary_matmul.cu",
    "ternary_matmul_dense": "src/repro_torch/csrc/ternary_matmul.cu",
}
REPLACES = {
    "ternary_conv2d": "src/repro/kernels/ternary_conv2d.py:223",
    "ternary_conv2d_packed": "src/repro/kernels/ternary_conv2d.py:281",
    "fused_trunk": "src/repro/kernels/fused_trunk.py:172",
    "pack_trits": "src/repro/kernels/trit_codec.py:65",
    "unpack_trits": "src/repro/kernels/trit_codec.py:86",
    "thermometer": "src/repro/kernels/trit_codec.py:116",
    "ternary_matmul": "src/repro/kernels/ternary_matmul.py:90",
    "ternary_matmul_dense": "src/repro/kernels/ternary_matmul.py:159",
}
SPLIT_AT = 4                       # the two-trunk split: layers [0, 4), [4, 8)
# (op, pool) per layer of paper Table III (repro.configs.cutie_cnn.layout)
CIFAR_POOLS = (None, None, ("max", 2), None, ("max", 2), None, ("max", 2),
               ("avg", 4))
CIFAR_CIN, CIFAR_WIDTH, CIFAR_HW, THERMO_M = 126, 128, 32, 42
# the LLM path: llama3.2-1B at full width and depth, ternary_packed, served
# with the default ServerConfig (paged, 4 slots, max_len 256, block 16)
LLM_ARCH, LLM_REQUESTS, LLM_PREFIX, LLM_PROMPT, LLM_NEW = (
    "llama3.2-1b", 8, 32, 40, 16)
DECODE_M, PREFILL_M = 4, 64        # n_slots; bucket of a 40-token prompt
# (name, K, N) of one layer's seven packed projections
LLM_PROJ = (("q", 2048, 2048), ("k", 2048, 512), ("v", 2048, 512),
            ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
            ("down", 8192, 2048))
# Tolerances for float x (int8 x must be bit-identical): the kernel sums
# the same exact f32 products as the plain version in another order, so a
# bf16 output may round one ulp apart (2**-7 of the output's largest
# magnitude) and an f32 output within 1e-5 of it.  Whole-model logits of
# one prefill (16 layers, each rounding its activations to bf16) within
# LOGIT_TOL absolute.
BF16_OUT_TOL, F32_OUT_TOL, LOGIT_TOL = 2.0 ** -7, 1e-5, 0.125


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _case(rng, torch, *, n, h, w, cin, cout, stride=(1, 1), padding=True,
          pool=None, fuse=True, const=True):
    dev = DEVICE
    x = torch.as_tensor(rng.integers(-1, 2, (n, h, w, cin)), dtype=torch.int8,
                        device=dev)
    wt = torch.as_tensor(rng.integers(-1, 2, (3, 3, cin, cout)),
                         dtype=torch.int8, device=dev)
    kw = dict(stride=stride, padding=padding, pool=pool)
    if fuse:
        scale = pool[1] ** 2 if pool and pool[0] == "avg" else 1
        t_hi = rng.uniform(-20, 20, cout) * scale
        t_hi[::2] = np.round(t_hi[::2])     # integer thresholds: ties count
        t_lo = t_hi - rng.uniform(0, 30, cout) * scale
        f32 = dict(dtype=torch.float32, device=dev)
        kw.update(t_lo=torch.as_tensor(t_lo, **f32),
                  t_hi=torch.as_tensor(t_hi, **f32),
                  flip=torch.as_tensor(rng.random(cout) < 0.4, device=dev))
        if const:
            kw.update(const=torch.as_tensor(rng.integers(-1, 2, cout),
                                            dtype=torch.int8, device=dev),
                      is_const=torch.as_tensor(rng.random(cout) < 0.2,
                                               device=dev))
    return x, wt, kw


def _err(torch, got, want) -> int:
    """Max |got - want| over a tensor or a tuple of tensors."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in pairs)


def compare_kernels(torch, K, codec) -> dict:
    rng = np.random.default_rng(SEED)
    cases = []
    hw, cin = CIFAR_HW, CIFAR_CIN
    for pool in CIFAR_POOLS:                   # the main path's layer shapes
        cases.append(dict(n=BATCH, h=hw, w=hw, cin=cin, cout=CIFAR_WIDTH,
                          pool=pool))
        hw, cin = (hw // pool[1] if pool else hw), CIFAR_WIDTH
    cases += [
        dict(n=3, h=11, w=9, cin=13, cout=20, pool=("max", 2)),
        dict(n=2, h=17, w=17, cin=8, cout=5, stride=(2, 2)),
        dict(n=2, h=16, w=15, cin=16, cout=13, stride=(2, 2),
             padding=False, pool=("avg", 2)),
        dict(n=2, h=9, w=9, cin=6, cout=33, stride=(3, 3), pool=("avg", 3)),
        dict(n=2, h=10, w=10, cin=7, cout=9, padding=False, const=False),
        dict(n=2, h=8, w=8, cin=7, cout=9, fuse=False),
    ]
    worst = {name: 0 for name in REPLACES}
    for i, c in enumerate(cases):
        x, w, kw = _case(rng, torch, **c)
        stats = "t_lo" in kw
        want = K.ternary_conv2d_plain(x, w, emit_stats=stats, **kw)
        wp = codec.pack_filter_rows(w)
        k, _, cin_, _ = w.shape
        got = {"ternary_conv2d": K.ternary_conv2d(x, w, emit_stats=stats,
                                                  **kw),
               "ternary_conv2d_packed": K.ternary_conv2d_packed(
                   x, wp, k=k, cin=cin_, emit_stats=stats, **kw)}
        sync(torch)
        for name, y in got.items():
            err = _err(torch, y, want)
            worst[name] = max(worst[name], err)
            if err != 0:
                raise RuntimeError(f"{name} disagrees with its plain "
                                   f"version on case {i} {c}: max |err| "
                                   f"{err}")
    log(f"phase 3: {len(cases)} cases x 2 conv kernels bit-identical to "
        "the plain versions (outputs and counters)")
    return worst


def _trunk_case(rng, torch, *, n, hw, cin, c, pools, strides=None):
    """Random trunk operands: x, w_stack (head rows zero-padded), the five
    stacked epilogue vectors and the metas."""
    nl, cu, dev = len(pools), max(cin, c), DEVICE
    strides = strides or [(1, 1)] * nl
    w = rng.integers(-1, 2, (nl, 3, 3, cu, c)).astype(np.int8)
    w[0, :, :, cin:] = 0
    scale = np.array([p[1] ** 2 if p and p[0] == "avg" else 1
                      for p in pools])[:, None]
    t_hi = rng.uniform(-20, 20, (nl, c)) * scale
    t_hi[:, ::2] = np.round(t_hi[:, ::2])
    t_lo = t_hi - rng.uniform(0, 30, (nl, c)) * scale
    f32 = dict(dtype=torch.float32, device=dev)
    th = [torch.as_tensor(t_lo, **f32), torch.as_tensor(t_hi, **f32),
          torch.as_tensor(rng.random((nl, c)) < 0.4, device=dev),
          torch.as_tensor(rng.integers(-1, 2, (nl, c)), dtype=torch.int8,
                          device=dev),
          torch.as_tensor(rng.random((nl, c)) < 0.2, device=dev)]
    x = torch.as_tensor(rng.integers(-1, 2, (n, *hw, cin)), dtype=torch.int8,
                        device=dev)
    return x, torch.as_tensor(w, device=dev), th, tuple(zip(strides, pools))


def compare_new_kernels(torch, FT, TC, worst: dict) -> None:
    """The trunk, codec and thermometer kernels against their plain
    versions on the card, counters included."""
    rng = np.random.default_rng(SEED + 3)
    full = dict(n=BATCH, hw=(CIFAR_HW, CIFAR_HW), cin=CIFAR_CIN,
                c=CIFAR_WIDTH, pools=CIFAR_POOLS)
    small = [dict(n=3, hw=(11, 9), cin=6, c=13,
                  pools=(None, ("max", 2), None)),
             dict(n=2, hw=(17, 15), cin=16, c=16,
                  pools=(None, ("avg", 2), None),
                  strides=[(2, 2), (1, 1), (1, 1)])]
    n_cases = 0

    def check(got, want, what):
        nonlocal n_cases
        sync(torch)
        err = _err(torch, got, want)
        name = what.split(" ")[0]
        worst[name] = max(worst[name], err)
        n_cases += 1
        if err != 0:
            raise RuntimeError(f"{what} disagrees with its plain version: "
                               f"max |err| {err}")

    for spec in [full] + small:
        x, w, th, metas = _trunk_case(rng, torch, **spec)
        kw = dict(metas=metas, emit_stats=True)
        check(FT.fused_trunk(x, w, *th, **kw),
              FT.fused_trunk_plain(x, w, *th, **kw),
              f"fused_trunk on {tuple(x.shape)} -> C {spec['c']}")
    # the main path's split: [0, SPLIT_AT) packs, [SPLIT_AT, 8) unpacks
    x, w, th, metas = _trunk_case(rng, torch, **full)
    a = dict(metas=metas[:SPLIT_AT], pack_out=True, emit_stats=True)
    a_args = (x, w[:SPLIT_AT], *[t[:SPLIT_AT] for t in th])
    got_a = FT.fused_trunk(*a_args, **a)
    check(got_a, FT.fused_trunk_plain(*a_args, **a),
          "fused_trunk pack_out at the split")
    mid = FT.fused_trunk_plain(*a_args, metas=metas[:SPLIT_AT])
    b = dict(metas=metas[SPLIT_AT:], packed_in=tuple(mid.shape),
             emit_stats=True)
    b_args = (got_a[0], w[SPLIT_AT:, :, :, :CIFAR_WIDTH].contiguous(),
              *[t[SPLIT_AT:] for t in th])
    check(FT.fused_trunk(*b_args, **b), FT.fused_trunk_plain(*b_args, **b),
          "fused_trunk packed_in at the split")
    # codec at the split's boundary and at ragged lengths
    for t in (mid.reshape(1, -1), mid.reshape(-1)[:7 * 643].reshape(7, 643),
              torch.as_tensor(rng.integers(-1, 2, (3, 1003)),
                              dtype=torch.int8, device=DEVICE)):
        packed = TC.pack_trits(t)
        check(packed, TC.pack_trits_plain(t),
              f"pack_trits on {tuple(t.shape)}")
        check(TC.unpack_trits(packed), TC.unpack_trits_plain(packed),
              f"unpack_trits on {tuple(packed.shape)}")
    levels = torch.as_tensor(rng.integers(0, 2 * THERMO_M + 1,
                                          (BATCH, CIFAR_HW, CIFAR_HW, 3)),
                             dtype=torch.int32, device=DEVICE)
    for ternary in (True, False):
        lv = levels if ternary else levels.clamp(max=THERMO_M)
        check(TC.thermometer(lv, THERMO_M, ternary=ternary),
              TC.thermometer_plain(lv, THERMO_M, ternary=ternary),
              f"thermometer {'ternary' if ternary else 'binary'} on "
              f"{tuple(lv.shape)}")
    log(f"phase 3: {n_cases} trunk, codec and thermometer cases "
        "bit-identical to the plain versions (outputs and counters)")


def _mm_case(rng, torch, m, k, n, xdt, ep):
    """x, w_packed and the epilogue operands of one matmul case."""
    dev = DEVICE
    if xdt == "int8":
        x = torch.as_tensor(rng.integers(-1, 2, (m, k)), dtype=torch.int8)
    else:
        x = torch.as_tensor(rng.standard_normal((m, k)),
                            dtype=torch.float32).to(torch.bfloat16)
    wp = torch.as_tensor(rng.integers(0, 243, (-(-k // 5), n)),
                         dtype=torch.uint8)
    f32 = dict(dtype=torch.float32, device=dev)
    kw = {}
    if ep == "scale":
        kw["scale"] = torch.as_tensor(rng.uniform(0.01, 0.05, n), **f32)
    elif ep == "threshold":
        t_hi = np.round(rng.uniform(-8, 8, n))
        kw = dict(t_lo=torch.as_tensor(t_hi - rng.uniform(0, 10, n), **f32),
                  t_hi=torch.as_tensor(t_hi, **f32),
                  flip=torch.as_tensor(rng.random(n) < 0.4, device=dev))
    return x.to(dev), wp.to(dev), kw


def compare_matmul_kernels(torch, MM, worst: dict) -> None:
    """Kernels 7 and 8 against their plain versions on the card: every
    epilogue, int8 and bf16 x, M in {1, 4, 37, 128}, ragged N and a logical
    K that is not a multiple of 5, then the seven llama projections at the
    decode and prefill M.  Int8 x bit-identical; bf16 x within the stated
    tolerance (a threshold may flip a trit whose sum lies within rounding
    of it: at most 1 in 1000)."""
    rng = np.random.default_rng(SEED + 5)
    cases = [(m, 1001, 77, xdt, ep) for m in (1, 4, 37, 128)
             for xdt in ("int8", "bfloat16")
             for ep in ("none", "scale", "threshold")]
    cases += [(m, k, n, xdt, "scale") for m in (DECODE_M, PREFILL_M)
              for _, k, n in LLM_PROJ for xdt in ("int8", "bfloat16")]
    rel = {"bfloat16": 0.0, "float32": 0.0}
    flips = 0.0
    for m, k, n, xdt, ep in cases:
        x, wp, kw = _mm_case(rng, torch, m, k, n, xdt, ep)
        got = MM.ternary_matmul(x, wp, **kw)
        want = MM.ternary_matmul_plain(x, wp, **kw)
        sync(torch)
        what = f"ternary_matmul {xdt} x ({m}, {k}) N {n} epilogue {ep}"
        if got.dtype != want.dtype or got.shape != want.shape:
            raise RuntimeError(f"{what}: {got.dtype} {tuple(got.shape)}, "
                               f"want {want.dtype} {tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max())
        worst["ternary_matmul"] = max(worst["ternary_matmul"], err)
        if xdt == "int8":
            if err != 0:
                raise RuntimeError(f"{what} differs: max |err| {err}")
        elif ep == "threshold":
            share = float((got != want).double().mean())
            flips = max(flips, share)
            if share > 1e-3:
                raise RuntimeError(f"{what}: {share} of trits flipped")
        else:
            scale = float(want.double().abs().max())
            tol = (BF16_OUT_TOL if got.dtype == torch.bfloat16
                   else F32_OUT_TOL)
            key = "bfloat16" if got.dtype == torch.bfloat16 else "float32"
            rel[key] = max(rel[key], err / scale)
            if err > tol * scale:
                raise RuntimeError(f"{what}: max |err| {err} > {tol} x "
                                   f"{scale}")
    dense = [(m, 1001, 77) for m in (1, 4, 37, 128)]
    dense += [(m, k, n) for m in (DECODE_M, PREFILL_M)
              for _, k, n in LLM_PROJ]
    for m, k, n in dense:
        x = torch.as_tensor(rng.integers(-128, 128, (m, k)), dtype=torch.int8,
                            device=DEVICE)
        w = torch.as_tensor(rng.integers(-1, 2, (k, n)), dtype=torch.int8,
                            device=DEVICE)
        got = MM.ternary_matmul_dense(x, w)
        want = MM.ternary_matmul_dense_plain(x, w)
        sync(torch)
        err = _err(torch, got, want)
        worst["ternary_matmul_dense"] = max(worst["ternary_matmul_dense"],
                                            err)
        if got.dtype != torch.int32 or err != 0:
            raise RuntimeError(f"ternary_matmul_dense ({m}, {k}) N {n}: "
                               f"max |err| {err}")
    log(f"phase 3: ternary_matmul on {len(cases)} cases: int8 x "
        "bit-identical; bf16 x worst |err| / max|out| "
        f"{rel['bfloat16']!r} (bf16 out, tolerance {BF16_OUT_TOL!r}), "
        f"{rel['float32']!r} (f32 out, tolerance {F32_OUT_TOL!r}), threshold "
        f"flips at most {flips!r}; worst absolute error "
        f"{worst['ternary_matmul']!r}; ternary_matmul_dense on {len(dense)} "
        "cases bit-identical")


# -- phase 4: the main path --------------------------------------------------


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_launches(*mods) -> None:
    for m in mods:
        m.reset_launches()


def cifar_program(torch, engine):
    rng = np.random.default_rng(SEED + 1)
    layers, cin = [], CIFAR_CIN
    for pool in CIFAR_POOLS:
        c = CIFAR_WIDTH
        w = rng.standard_normal((3, 3, cin, c)).astype(np.float32)
        bn = {"gamma": rng.standard_normal(c).astype(np.float32) + 0.5,
              "beta": np.zeros(c, np.float32),
              "mean": np.zeros(c, np.float32),
              "var": np.ones(c, np.float32)}
        layers.append(engine.compile_layer(torch.as_tensor(w, device=DEVICE),
                                           bn, pool=pool))
        cin = c
    return engine.CutieProgram(layers, engine.CutieInstance())


def cifar_input(torch, thermometer):
    rng = np.random.default_rng(SEED + 2)
    img = torch.as_tensor(rng.random((BATCH, CIFAR_HW, CIFAR_HW, 3)),
                          dtype=torch.float32, device=DEVICE)
    return thermometer.encode_image_ternary(img, THERMO_M)


def _run_steps(torch, P, pipe, x, count, per_run: int, what: str) -> dict:
    """run, traced run and measure on one pipeline; ``count()`` must grow
    by ``per_run`` launches per step."""
    steps = [("run", lambda: pipe.run(x)),
             ("run+StatsTracer", lambda: pipe.run(x, tracer=P.StatsTracer())),
             ("measure", lambda: pipe.measure(x))]
    got = {}
    for i, (step, fn) in enumerate(steps, 1):
        got[step] = fn()
        sync(torch)
        if count() != per_run * i:
            raise RuntimeError(f"{what}: {count()} launches after {step}, "
                               f"want {per_run * i}")
    return got


def _same_as_ref(torch, got, ref: dict, what: str) -> None:
    y, (y2, rows), m = got["run"], got["run+StatsTracer"], got["measure"]
    checks = {
        "run": torch.equal(y, ref["y"]),
        "traced run": torch.equal(y2, ref["y"]),
        "tracer rows": rows == ref["rows"],
        "measure final": torch.equal(m["final"], ref["y"]),
        "measure rows": m["layers"] == ref["m"]["layers"],
        "energy_uj": m["energy_uj"] == ref["m"]["energy_uj"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{what} differs from ref on {bad}")


def main_path(torch, K, FT, TC, ops, engine, thermometer, compiler, P
              ) -> dict:
    prog = cifar_program(torch, engine)
    reset_launches(K, FT, TC)
    x = cifar_input(torch, thermometer)
    sync(torch)
    launches = {"thermometer": TC.LAUNCHES["thermometer"]}
    if launches["thermometer"] != 1 and DEVICE == "cuda":
        raise RuntimeError(f"input encoding launched the thermometer kernel "
                           f"{launches['thermometer']} times, want 1")
    if tuple(x.shape) != (BATCH, CIFAR_HW, CIFAR_HW, CIFAR_CIN):
        raise RuntimeError(f"thermometer input has shape {tuple(x.shape)}")
    ref_pipe = P.CutiePipeline(prog, backend="ref", device=DEVICE)
    y_ref = ref_pipe.run(x)
    _, rows_ref = ref_pipe.run(x, tracer=P.StatsTracer())
    ref = {"y": y_ref, "rows": rows_ref, "m": ref_pipe.measure(x)}
    want_shape = (BATCH, 1, 1, CIFAR_WIDTH)
    if tuple(y_ref.shape) != want_shape or not bool(
            ((y_ref >= -1) & (y_ref <= 1)).all()):
        raise RuntimeError(f"ref output {tuple(y_ref.shape)} is not "
                           f"{want_shape} trits")
    nz = float((y_ref != 0).float().mean())
    log(f"phase 4: thermometer kernel encoded the input {tuple(x.shape)}; "
        f"ref output {want_shape}, nonzero share {nz:.4f}, energy "
        f"{ref['m']['energy_uj']!r} uJ/inference")
    kernel_of = {"cuda": "ternary_conv2d", "packed": "ternary_conv2d_packed"}
    for backend, kname in kernel_of.items():
        pipe = P.CutiePipeline(prog, backend=backend, device=DEVICE)
        reset_launches(K, FT)
        got = _run_steps(torch, P, pipe, x, lambda: K.LAUNCHES[kname],
                         8 if DEVICE == "cuda" else 0, backend)
        other = [v for k, v in {**K.LAUNCHES, **FT.LAUNCHES}.items()
                 if k != kname]
        if any(other):
            raise RuntimeError(f"{backend}: unexpected launches "
                               f"{K.LAUNCHES} {FT.LAUNCHES}")
        launches[kname] = K.LAUNCHES[kname]
        _same_as_ref(torch, got, ref, backend)
        log(f"phase 4: backend {backend!r}: run, traced run and measure "
            f"identical to ref; {kname} launched {launches[kname]} times "
            "(8 per run)")
    # fused: one trunk, then a budget that splits it into two trunks
    split_budget = compiler.trunk_l2_bytes(prog.layers[:SPLIT_AT],
                                           tuple(x.shape))
    fused = {"fused": P.FusedBackend(),
             "fused-split": P.FusedBackend(l2_budget=split_budget)}
    for what, be in fused.items():
        segs = [(s.start, s.stop, s.fused) for s in be.plan(prog, x.shape)]
        want_segs = ([(0, 8, True)] if what == "fused" else
                     [(0, SPLIT_AT, True), (SPLIT_AT, 8, True)])
        if segs != want_segs:
            raise RuntimeError(f"{what}: segments {segs}, want {want_segs}")
        pipe = P.CutiePipeline(prog, backend=be, device=DEVICE)
        reset_launches(K, FT)
        got = _run_steps(torch, P, pipe, x, lambda: FT.LAUNCHES["fused_trunk"],
                         len(segs) if DEVICE == "cuda" else 0, what)
        if any(K.LAUNCHES.values()):
            raise RuntimeError(f"{what}: conv kernels launched "
                               f"{K.LAUNCHES}")
        _same_as_ref(torch, got, ref, what)
        if what == "fused":
            launches["fused_trunk"] = FT.LAUNCHES["fused_trunk"]
        log(f"phase 4: backend {what!r} (segments {segs}): run, traced run "
            "and measure identical to ref; fused_trunk launched "
            f"{FT.LAUNCHES['fused_trunk']} times ({len(segs)} per run), "
            "conv kernels 0")
    # the codec entry points on the split's boundary trits
    boundary = P.CutiePipeline(
        engine.CutieProgram(prog.layers[:SPLIT_AT], prog.instance),
        backend="fused", device=DEVICE).run(x)
    reset_launches(TC)
    packed = ops.pack_trits(boundary.reshape(1, -1))
    trits = ops.unpack_trits(packed)
    sync(torch)
    launches["pack_trits"] = TC.LAUNCHES["pack_trits"]
    launches["unpack_trits"] = TC.LAUNCHES["unpack_trits"]
    if DEVICE == "cuda" and (launches["pack_trits"], launches["unpack_trits"]
                             ) != (1, 1):
        raise RuntimeError(f"codec entry points launched {TC.LAUNCHES}")
    stream = FT.fused_trunk(
        x, *_trunk_operands(torch, prog.layers[:SPLIT_AT]),
        metas=tuple((li.stride, li.pool) for li in prog.layers[:SPLIT_AT]),
        pack_out=True)
    n = boundary.numel()
    if not (torch.equal(packed.reshape(-1), stream)
            and torch.equal(trits.reshape(-1)[:n], boundary.reshape(-1))):
        raise RuntimeError("codec entry points disagree with the trunk "
                           "kernel's packed boundary")
    log(f"phase 4: pack_trits/unpack_trits on the split's boundary "
        f"{tuple(boundary.shape)}: bytes equal the trunk kernel's pack_out "
        "stream, round trip exact")
    return {"program": prog, "x": x, "launches": launches,
            "boundary": boundary, "split_budget": split_budget}


def _trunk_operands(torch, layers):
    """(w_stack, t_lo, t_hi, flip, const, is_const) of a trunk."""
    import torch.nn.functional as F
    cu = max(layers[0].weights.shape[2], layers[0].weights.shape[3])
    w = torch.stack([F.pad(li.weights, (0, 0, 0, cu - li.weights.shape[2]))
                     for li in layers])
    return (w, *[torch.stack([getattr(li.thresholds, f) for li in layers])
                 for f in ("t_lo", "t_hi", "flip", "const", "is_const")])


def llm_prompts(cfg) -> list:
    """8 prompts of 40 tokens: one shared 32-token prefix + 8 distinct."""
    rng = np.random.default_rng(SEED + 6)
    prefix = rng.integers(0, cfg.vocab, LLM_PREFIX)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                 LLM_PROMPT - LLM_PREFIX)])
            for _ in range(LLM_REQUESTS)]


def llm_params(torch, TF, cfg):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    return TF.init_params(cfg, gen)


def serve(torch, S, params, cfg, prompts, **scfg) -> dict:
    """The requests through CutieEngine + LLMExecutor; returns tokens,
    stats, host-clock seconds and the trace's prefill/decode spans."""
    eng = S.CutieEngine("fcfs")
    ex = S.LLMExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW,
                                                   **scfg))
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    sync(torch)
    t0 = time.perf_counter()
    out = eng.run()
    sync(torch)
    secs = time.perf_counter() - t0
    spans: dict = {"prefill": [], "decode": []}
    open_: dict = {}
    for ev in eng.trace_export()["traceEvents"]:
        key = (ev["name"], ev.get("tid"))
        if ev["name"] not in spans:
            continue
        if ev["ph"] == "B":
            open_[key] = ev["ts"]
        elif ev["ph"] == "E":
            spans[ev["name"]].append((ev["ts"] - open_.pop(key)) / 1e3)
    return {"tokens": [out[h.uid] for h in hs], "executor": ex,
            "stats": eng.stats(), "seconds": secs, "spans": spans}


def llm_main_path(torch, MM, TC, S, TF, DEC, C, configs) -> dict:
    """llama3.2-1B, ternary_packed, full width and depth, served through
    CutieEngine + LLMExecutor on the card: tokens, prefix hits and kernel
    7's launch count, then paged against contiguous, then one prefill
    with the plain matmul against the kernel."""
    cfg = configs.get(LLM_ARCH).replace(quant="ternary_packed",
                                        attn_kv_chunk=16)
    params = llm_params(torch, TF, cfg)
    prompts = llm_prompts(cfg)
    sync(torch)
    reset_launches(MM, TC)
    paged = serve(torch, S, params, cfg, prompts)
    sync(torch)
    launches = dict(MM.LAUNCHES)
    st = paged["stats"]["paged_state"]["llm"]
    forwards = st["prefills"] + st["decode_steps"]
    want = 7 * cfg.n_layers * forwards if DEVICE == "cuda" else 0
    lens = [len(t) for t in paged["tokens"]]
    if lens != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"llm: token counts {lens}, want {LLM_NEW} each")
    if not st["prefix_hit_rate"] > 0:
        raise RuntimeError(f"llm: prefix_hit_rate {st['prefix_hit_rate']}")
    if launches["ternary_matmul"] != want or \
            launches["ternary_matmul_dense"] or any(TC.LAUNCHES.values()):
        raise RuntimeError(f"llm: launches {launches} {TC.LAUNCHES}, want "
                           f"ternary_matmul = 7 x {cfg.n_layers} x "
                           f"{forwards} forwards = {want}")
    log(f"phase 4: llm {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, vocab {cfg.vocab}): {LLM_REQUESTS} requests "
        f"x {LLM_PROMPT} tokens -> {LLM_NEW} tokens each; prefix_hit_rate "
        f"{st['prefix_hit_rate']!r}, prefill tokens computed "
        f"{st['prefill_tokens_computed']} of {st['prefill_tokens']}; "
        f"{st['prefills']} prefills + {st['decode_steps']} decode steps; "
        f"ternary_matmul launched {launches['ternary_matmul']} times "
        f"(7 x {cfg.n_layers} x {forwards})")
    contiguous = serve(torch, S, params, cfg, prompts, paged=False)
    if contiguous["tokens"] != paged["tokens"]:
        raise RuntimeError("llm: paged and contiguous tokens differ")
    log("phase 4: llm paged and contiguous serving: tokens identical "
        f"(first request {paged['tokens'][0]})")
    # one prefill with the plain matmul on the card against the kernel
    toks = torch.as_tensor(np.pad(prompts[0], (0, PREFILL_M - LLM_PROMPT))
                           [None], device=DEVICE)
    empty = {n: torch.zeros((cfg.n_layers, 1, 0, cfg.n_kv, cfg.d_head),
                            dtype=torch.bfloat16, device=DEVICE)
             for n in ("k", "v")}
    lg, _ = DEC.prefill_with_prefix(params, toks, empty, cfg)

    class _Plain:                  # `linear` reaches the plain version
        ternary_matmul = staticmethod(MM.ternary_matmul_plain)

    saved, C._mm = C._mm, _Plain
    try:
        lg_plain, _ = DEC.prefill_with_prefix(params, toks, empty, cfg)
    finally:
        C._mm = saved
    sync(torch)
    a = lg[0, :LLM_PROMPT, :cfg.vocab].double()
    b = lg_plain[0, :LLM_PROMPT, :cfg.vocab].double()
    err = float((a - b).abs().max())
    if not (bool(torch.isfinite(a).all()) and err <= LOGIT_TOL):
        raise RuntimeError(f"llm: kernel and plain prefill logits differ by "
                           f"{err} (tolerance {LOGIT_TOL})")
    same = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    log(f"phase 4: llm prefill of {LLM_PROMPT} tokens (bucket {PREFILL_M}) "
        f"with the plain matmul on the card: logits max |err| {err!r} "
        f"(tolerance {LOGIT_TOL}, max |logit| {float(b.abs().max())!r}), "
        f"argmax equal on {same!r} of positions")
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "paged": paged, "contiguous": contiguous,
            "launches": launches["ternary_matmul"], "logit_err": err}


# -- phase 5: timing ---------------------------------------------------------


def program_latency(torch, P, mp, card: str, reps: int = 10) -> None:
    """Host-clock ms per `run` and `measure` of the whole program, ending
    in a synchronize: what a caller of the pipeline waits for; beside it
    the host time until the call returns, before the synchronize (the
    enqueue cost, where nothing in the call waits for the card)."""
    prog, x = mp["program"], mp["x"]
    backends = {"ref": "ref", "cuda": "cuda", "packed": "packed",
                "fused": "fused",
                "fused-split": P.FusedBackend(l2_budget=mp["split_budget"])}
    for label, backend in backends.items():
        pipe = P.CutiePipeline(prog, backend=backend)
        for what, fn in (("run", lambda: pipe.run(x)),
                         ("measure", lambda: pipe.measure(x))):
            fn()
            torch.cuda.synchronize()
            ts, enq = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                enq.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            log(f"phase 5: program {what} on {label!r}, batch {BATCH}: "
                f"median ms {float(np.median(ts))!r} (min "
                f"{min(ts)!r}, max {max(ts)!r}, {reps} runs, host clock; "
                f"host returns after median {float(np.median(enq))!r} ms; "
                f"{card})")


def timed(torch, fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` calls after a warm-up, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, name_part: str, reps: int = 10):
    """Mean device time in ms per call of ``fn`` of the kernels whose name
    holds ``name_part``, from a torch.profiler trace (CUPTI); None when the
    trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if name_part in e.key)
    return us / reps / 1e3 if us else None


def _record(name, launches, worst, ms, plain_ms, bytes_ms, ops_ms,
            library_ms) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms}


def time_kernels(torch, F, K, codec, engine, mp, card: str,
                 worst: dict) -> tuple[list[dict], float]:
    """The conv kernels layer by layer; returns their records and the
    summed f32 `F.conv2d` yardstick (8 calls)."""
    prog, x = mp["program"], mp["x"]
    acts, cur = [], x
    for instr in prog.layers:                  # each layer's real input
        acts.append(cur)
        th = instr.thresholds
        cur = K.ternary_conv2d_plain(
            cur, instr.weights, stride=instr.stride, padding=instr.padding,
            t_lo=th.t_lo, t_hi=th.t_hi, flip=th.flip, const=th.const,
            is_const=th.is_const, pool=instr.pool)
    names = ("ternary_conv2d", "ternary_conv2d_packed")
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
              for name in names}
    log(f"phase 5: per-layer ms at batch {BATCH} on {card} "
        "(CUDA events, mean of 20 after 3 warm-up calls, L2 warm)")
    for li, (instr, a) in enumerate(zip(prog.layers, acts)):
        th = instr.thresholds
        ep = dict(stride=instr.stride, padding=instr.padding, t_lo=th.t_lo,
                  t_hi=th.t_hi, flip=th.flip, const=th.const,
                  is_const=th.is_const, pool=instr.pool)
        w = instr.weights
        k, _, cin, cout = w.shape
        wp = codec.pack_filter_rows(w)
        n, h, wd, _ = a.shape
        oh, ow = engine.conv_out_hw(instr, h, wd)
        ph, pw = ((oh // instr.pool[1], ow // instr.pool[1]) if instr.pool
                  else (oh, ow))
        ops = 2 * n * oh * ow * k * k * cin * cout
        xf = a.permute(0, 3, 1, 2).float()
        wf = w.permute(3, 2, 0, 1).float()
        calls = {
            "ternary_conv2d": (lambda: K.ternary_conv2d(a, w, **ep),
                               lambda: K.ternary_conv2d_plain(a, w, **ep),
                               w.numel()),
            "ternary_conv2d_packed": (
                lambda: K.ternary_conv2d_packed(a, wp, k=k, cin=cin, **ep),
                lambda: K.ternary_conv2d_packed_plain(a, wp, k=k, cin=cin,
                                                      **ep),
                wp.numel()),
        }
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = timed(torch, lambda: F.conv2d(
                xf, wf, stride=instr.stride, padding=k // 2 if
                instr.padding else 0))
        for name, (kern, plain, wbytes) in calls.items():
            nbytes = a.numel() + wbytes + 11 * cout + n * ph * pw * cout
            t = totals[name]
            ms, pms = timed(torch, kern), timed(torch, plain)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops / INT8_OPS_PER_S * 1e3
            t["ms"] += ms
            t["plain_ms"] += pms
            t["library_ms"] += lib_ms
            t["bytes_ms"] += b_ms
            t["ops_ms"] += o_ms
            t["bound_ms"] += max(b_ms, o_ms)
            log(f"  layer {li} {name}: {tuple(a.shape)} -> "
                f"({n}, {ph}, {pw}, {cout}) ms {ms!r} plain_ms {pms!r} "
                f"library_ms {lib_ms!r} bound_ms {max(b_ms, o_ms)!r} "
                f"({ops} ops, {nbytes} B)")
    out = []
    for name, t in totals.items():
        rec = _record(name, mp["launches"][name], worst[name], t["ms"],
                      t["plain_ms"], t["bytes_ms"], t["ops_ms"],
                      t["library_ms"])
        rec["bound_ms"] = t["bound_ms"]       # 8 launches: sum of bounds
        out.append(rec)
        log(f"phase 5: {name} over the 8 layers: ms {t['ms']!r} "
            f"plain_ms {t['plain_ms']!r} library_ms {t['library_ms']!r} "
            f"bound_ms {rec['bound_ms']!r} ({card})")
    return out, totals["ternary_conv2d"]["library_ms"]


def time_new_kernels(torch, FT, TC, mp, card: str, worst: dict,
                     conv_library_ms: float) -> list[dict]:
    """The trunk kernel on the whole program, the codec on the split's
    boundary and the thermometer on the CIFAR input, beside their bounds."""
    prog, x = mp["program"], mp["x"]
    layers = prog.layers
    ops_args = _trunk_operands(torch, layers)
    metas = tuple((li.stride, li.pool) for li in layers)
    trunk = (lambda: FT.fused_trunk(x, *ops_args, metas=metas))
    plain = (lambda: FT.fused_trunk_plain(x, *ops_args, metas=metas))
    ops = sum(2 * BATCH * h * w * 9 * li.weights.shape[2]
              * li.weights.shape[3] for li, (h, w) in
              zip(layers, FT.trunk_shapes((CIFAR_HW, CIFAR_HW), 3,
                                          metas)))
    nl = len(layers)
    nbytes = (x.numel() + ops_args[0].numel() + 11 * nl * CIFAR_WIDTH
              + BATCH * CIFAR_WIDTH)
    ms, pms = timed(torch, trunk), timed(torch, plain)
    out = [_record("fused_trunk", mp["launches"]["fused_trunk"],
                   worst["fused_trunk"], ms, pms,
                   nbytes / HBM_BYTES_PER_S * 1e3,
                   ops / INT8_OPS_PER_S * 1e3, conv_library_ms)]
    log(f"phase 5: fused_trunk, whole program in one launch at batch "
        f"{BATCH}: ms {ms!r} plain_ms {pms!r} bound_ms "
        f"{out[-1]['bound_ms']!r} ({ops} ops, {nbytes} B); library "
        f"yardstick: 8 f32 F.conv2d calls, summed, {conv_library_ms!r} ms "
        f"({card})")
    b = mp["boundary"].reshape(1, -1)
    packed = TC.pack_trits(b)
    levels = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, 2 * THERMO_M + 1, (BATCH * CIFAR_HW * CIFAR_HW * 3,)),
        dtype=torch.int32, device="cuda")
    cases = {
        "pack_trits": (lambda: TC.pack_trits(b),
                       lambda: TC.pack_trits_plain(b),
                       b.numel() + packed.numel(), tuple(b.shape)),
        "unpack_trits": (lambda: TC.unpack_trits(packed),
                         lambda: TC.unpack_trits_plain(packed),
                         packed.numel() * 6, tuple(packed.shape)),
        "thermometer": (lambda: TC.thermometer(levels, THERMO_M),
                        lambda: TC.thermometer_plain(levels, THERMO_M),
                        levels.numel() * (4 + THERMO_M),
                        tuple(levels.shape)),
    }
    for name, (kern, plain, nbytes, shape) in cases.items():
        ms, pms = timed(torch, kern), timed(torch, plain)
        out.append(_record(name, mp["launches"][name], worst[name], ms, pms,
                           nbytes / HBM_BYTES_PER_S * 1e3, 0.0, None))
        log(f"phase 5: {name} on {shape}: ms {ms!r} plain_ms {pms!r} "
            f"bound_ms {out[-1]['bound_ms']!r} ({nbytes} B); library_ms "
            f"null: no single PyTorch call computes it ({card})")
    return out


def time_matmul_kernels(torch, MM, llm, card: str, worst: dict
                        ) -> list[dict]:
    """Kernels 7 and 8 at each projection shape, at the decode M and the
    prefill bucket's M, beside their bounds, plain versions and a library
    call.  The JSON records sum one forward's 7 x n_layers projections:
    kernel 7 at the decode M (one decode step), kernel 8 (no caller on the
    path) at the prefill M, where `torch._int_mm` applies."""
    from repro_torch.kernels import ref as R

    rng = np.random.default_rng(SEED + 7)
    n_layers = llm["cfg"].n_layers
    layer = llm["params"]["layers"][0]
    packed = {"q": layer["attn"]["wq"], "k": layer["attn"]["wk"],
              "v": layer["attn"]["wv"], "o": layer["attn"]["wo"],
              "gate": layer["mlp"]["gate"], "up": layer["mlp"]["up"],
              "down": layer["mlp"]["down"]}
    tot = {(name, m): {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bytes_ms": 0.0, "ops_ms": 0.0, "device_ms": 0.0,
                       "lib_null": False}
           for name in ("ternary_matmul", "ternary_matmul_dense")
           for m in (DECODE_M, PREFILL_M)}
    log(f"phase 5: matmul ms per call at the llama projection shapes on "
        f"{card} (CUDA events, mean of 20 after 3 warm-up calls, L2 warm)")
    for pname, k, n in LLM_PROJ:
        p = packed[pname]
        wp = p["w_packed"]
        alpha = p["scale"].to(torch.bfloat16).float()
        # the library yardstick's weights: trits * bf16(alpha), decoded once
        w_dec = (R.unpack_trits(wp.T).T[:k].to(torch.bfloat16)
                 * alpha.to(torch.bfloat16))
        w8 = torch.as_tensor(rng.integers(-1, 2, (k, n)), dtype=torch.int8,
                             device=DEVICE)
        for m in (DECODE_M, PREFILL_M):
            x = torch.as_tensor(rng.standard_normal((m, k)),
                                dtype=torch.float32,
                                device=DEVICE).to(torch.bfloat16)
            x8 = torch.as_tensor(rng.integers(-1, 2, (m, k)),
                                 dtype=torch.int8, device=DEVICE)
            ops = 2 * m * k * n
            try:
                torch._int_mm(x8, w8)
                int_mm = (lambda: torch._int_mm(x8, w8))
            except RuntimeError:
                int_mm = None
            runs = {
                "ternary_matmul": (
                    lambda: MM.ternary_matmul(x, wp, scale=alpha),
                    lambda: MM.ternary_matmul_plain(x, wp, scale=alpha),
                    lambda: torch.matmul(x, w_dec),
                    wp.numel() + 2 * m * k + 2 * m * n + 4 * n,
                    ops / BF16_OPS_PER_S * 1e3, "torch.matmul bf16 x @ "
                    "pre-decoded bf16 trits*alpha"),
                "ternary_matmul_dense": (
                    lambda: MM.ternary_matmul_dense(x8, w8),
                    lambda: MM.ternary_matmul_dense_plain(x8, w8),
                    int_mm, k * n + m * k + 4 * m * n,
                    ops / INT8_OPS_PER_S * 1e3, "torch._int_mm"),
            }
            for name, (kern, plain, lib, nbytes, o_ms, lib_what) in \
                    runs.items():
                ms, pms = timed(torch, kern), timed(torch, plain)
                dev = device_ms(torch, kern, "matmul_kernel")
                lms = timed(torch, lib) if lib is not None else None
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                t = tot[(name, m)]
                t["ms"] += n_layers * ms
                t["plain_ms"] += n_layers * pms
                t["bytes_ms"] += n_layers * b_ms
                t["ops_ms"] += n_layers * o_ms
                if lms is None:
                    t["lib_null"] = True
                else:
                    t["library_ms"] += n_layers * lms
                t["device_ms"] += n_layers * (
                    dev if dev is not None else float("nan"))
                log(f"  {name} {pname} ({m}, {k}) x ({k}, {n}): ms {ms!r} "
                    f"(device only {dev!r}, torch.profiler) "
                    f"plain_ms {pms!r} library_ms {lms!r} ({lib_what}"
                    f"{'' if lms is not None else ': shape not accepted'}) "
                    f"bound_ms {max(b_ms, o_ms)!r} "
                    f"({'bytes' if b_ms > o_ms else 'operations'}: {nbytes} "
                    f"B, {ops} ops)")
    out = []
    for (name, m), t in tot.items():
        per = (f"one forward's {7 * n_layers} projections at M = {m}")
        log(f"phase 5: {name} summed over {per}: ms {t['ms']!r} (device "
            f"only {t['device_ms']!r}) plain_ms "
            f"{t['plain_ms']!r} library_ms "
            f"{None if t['lib_null'] else t['library_ms']!r} bound_ms "
            f"{max(t['bytes_ms'], t['ops_ms'])!r} ({card})")
        if (name, m) in (("ternary_matmul", DECODE_M),
                         ("ternary_matmul_dense", PREFILL_M)):
            launches = llm["launches"] if name == "ternary_matmul" else 0
            out.append(_record(name, launches, worst[name], t["ms"],
                               t["plain_ms"], t["bytes_ms"], t["ops_ms"],
                               None if t["lib_null"] else t["library_ms"]))
    return out


def _serving_line(label: str, run: dict, card: str) -> None:
    st = run["stats"]
    toks = sum(len(t) for t in run["tokens"])
    dec = run["spans"]["decode"]
    pre = run["spans"]["prefill"]
    lat = st["latency"]
    log(f"phase 5: serving {label}: {LLM_REQUESTS} requests, {toks} tokens "
        f"in {run['seconds']!r} s ({toks / run['seconds']!r} tokens/s); "
        f"decode step ms median {float(np.median(dec))!r} (min {min(dec)!r}, "
        f"{len(dec)} steps); prefill ms median {float(np.median(pre))!r} "
        f"(first {pre[0]!r}, {len(pre)} prefills); latency p50 "
        f"{lat['p50']!r} s p99 {lat['p99']!r} s (host clock, {card})")


def serving_profile(torch, S, params, cfg, prompts, card: str) -> None:
    """One more ternary_packed run under torch.profiler (CUDA activity):
    the device's busy share of the run's host-clock time, and the kernels
    that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = serve(torch, S, params, cfg, prompts)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    log(f"phase 5: serving ternary_packed paged under torch.profiler: "
        f"{run['seconds']!r} s host clock, device busy {busy!r} s "
        f"({busy / run['seconds']!r} of it; idle share "
        f"{1 - busy / run['seconds']!r}); {card}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3!r} ms in {e.count} "
            f"calls: {e.key[:90]}")


def serving_numbers(torch, S, TF, llm, card: str) -> None:
    """The main path's serving times, a second ternary_packed run (warm),
    and the same requests on quant="none", the bf16 baseline the
    reference's examples/serve_ternary.py also serves."""
    cfg, params, prompts = llm["cfg"], llm["params"], llm["prompts"]
    _serving_line("ternary_packed paged (first run)", llm["paged"], card)
    _serving_line("ternary_packed contiguous", llm["contiguous"], card)
    warm = serve(torch, S, params, cfg, prompts)
    _serving_line("ternary_packed paged (second run)", warm, card)
    serving_profile(torch, S, params, cfg, prompts, card)
    base_cfg = cfg.replace(quant="none")
    base_params = llm_params(torch, TF, base_cfg)
    for i in range(2):
        base = serve(torch, S, base_params, base_cfg, prompts)
        _serving_line(f"bf16 baseline quant='none' paged (run {i + 1})",
                      base, card)
    del base_params
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch import compiler, configs
    from repro_torch import pipeline as P
    from repro_torch import serving as S
    from repro_torch.core import codec, engine, thermometer
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_trunk as FT
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_conv2d as K
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.kernels import trit_codec as TC
    from repro_torch.models import common as C
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF

    t0 = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    names = _build.build_all()
    for n in names:
        for line in _build.BUILD_LOGS.get(n, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {n}: {line.strip()}")
    log(f"phase 2: built {names} in {time.perf_counter() - t0:.1f} s")

    worst = compare_kernels(torch, K, codec)
    compare_new_kernels(torch, FT, TC, worst)
    compare_matmul_kernels(torch, MM, worst)
    mp = main_path(torch, K, FT, TC, ops, engine, thermometer, compiler, P)
    llm = llm_main_path(torch, MM, TC, S, TF, DEC, C, configs)
    program_latency(torch, P, mp, card)
    kernels, conv_lib_ms = time_kernels(torch, F, K, codec, engine, mp, card,
                                        worst)
    kernels += time_new_kernels(torch, FT, TC, mp, card, worst, conv_lib_ms)
    kernels += time_matmul_kernels(torch, MM, llm, card, worst)
    serving_numbers(torch, S, TF, llm, card)
    reset_launches(K, FT, TC, MM)          # timing launches are not counted
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
