#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card and check it.

    python3 chip_smoke.py

Phases, each of which fails the script (no result line) when it fails:

1. the card's name and power limit, from nvidia-smi;
2. build every kernel from `src/repro_torch/csrc/` with nvcc (sm_90a);
3. hold each kernel bit for bit against its plain PyTorch version on the
   card: the full-width CIFAR layer shapes plus odd-channel, stride-2/3,
   unpadded, raw-int32 and const-channel cases, counters included;
4. the main path: the paper's CIFAR-10 network (Table III, full width:
   126 -> 128 channels, 32 x 32, 8 layers, max-pools after layers 2, 4, 6
   and avg-pool 4 after layer 7) compiled with `engine.compile_layer`
   from seeded weights, run through `CutiePipeline.run`, a traced run and
   `measure` at batch 64 on the ``cuda`` and ``packed`` backends; outputs,
   tracer rows and energy rows must equal the ``ref`` backend's on the
   same card, and each kernel's launch count must grow by 8 per run;
5. time the whole program (`run`, `measure`) per backend on the host
   clock, then each kernel at the main path's shapes beside its bound, its
   plain version and one f32 `F.conv2d` call as a library yardstick.

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
BATCH = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/csrc/ternary_conv2d.cu"
REPLACES = {
    "ternary_conv2d": "src/repro/kernels/ternary_conv2d.py:223",
    "ternary_conv2d_packed": "src/repro/kernels/ternary_conv2d.py:281",
}
# (op, pool) per layer of paper Table III (repro.configs.cutie_cnn.layout)
CIFAR_POOLS = (None, None, ("max", 2), None, ("max", 2), None, ("max", 2),
               ("avg", 4))
CIFAR_CIN, CIFAR_WIDTH, CIFAR_HW, THERMO_M = 126, 128, 32, 42


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
    dev = "cuda"
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
    worst = {"ternary_conv2d": 0, "ternary_conv2d_packed": 0}
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
        torch.cuda.synchronize()
        for name, y in got.items():
            pairs = zip(y, want) if stats else [(y, want)]
            err = max(int((a.to(torch.int64) - b.to(torch.int64))
                          .abs().max()) for a, b in pairs)
            worst[name] = max(worst[name], err)
            if err != 0:
                raise RuntimeError(f"{name} disagrees with its plain "
                                   f"version on case {i} {c}: max |err| "
                                   f"{err}")
    log(f"phase 3: {len(cases)} cases x 2 kernels bit-identical to the "
        "plain versions (outputs and counters)")
    return worst


# -- phase 4: the main path --------------------------------------------------


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
        layers.append(engine.compile_layer(torch.as_tensor(w, device="cuda"),
                                           bn, pool=pool))
        cin = c
    return engine.CutieProgram(layers, engine.CutieInstance())


def cifar_input(torch, thermometer):
    rng = np.random.default_rng(SEED + 2)
    img = torch.as_tensor(rng.random((BATCH, CIFAR_HW, CIFAR_HW, 3)),
                          dtype=torch.float32, device="cuda")
    return thermometer.encode_image_ternary(img, THERMO_M)


def main_path(torch, K, engine, thermometer, P) -> dict:
    prog = cifar_program(torch, engine)
    x = cifar_input(torch, thermometer)
    if tuple(x.shape) != (BATCH, CIFAR_HW, CIFAR_HW, CIFAR_CIN):
        raise RuntimeError(f"thermometer input has shape {tuple(x.shape)}")
    ref = P.CutiePipeline(prog, backend="ref")
    y_ref = ref.run(x)
    _, rows_ref = ref.run(x, tracer=P.StatsTracer())
    m_ref = ref.measure(x)
    want_shape = (BATCH, 1, 1, CIFAR_WIDTH)
    if tuple(y_ref.shape) != want_shape or not bool(
            ((y_ref >= -1) & (y_ref <= 1)).all()):
        raise RuntimeError(f"ref output {tuple(y_ref.shape)} is not "
                           f"{want_shape} trits")
    nz = float((y_ref != 0).float().mean())
    log(f"phase 4: ref output {want_shape}, nonzero share {nz:.4f}, "
        f"energy {m_ref['energy_uj']!r} uJ/inference")
    kernel_of = {"cuda": "ternary_conv2d", "packed": "ternary_conv2d_packed"}
    launches = {}
    for backend, kname in kernel_of.items():
        pipe = P.CutiePipeline(prog, backend=backend)
        K.reset_launches()
        steps = [("run", lambda: pipe.run(x)),
                 ("run+StatsTracer",
                  lambda: pipe.run(x, tracer=P.StatsTracer())),
                 ("measure", lambda: pipe.measure(x))]
        got = {}
        for i, (what, fn) in enumerate(steps, 1):
            got[what] = fn()
            torch.cuda.synchronize()
            if K.LAUNCHES[kname] != 8 * i:
                raise RuntimeError(
                    f"{backend}: {kname} launched {K.LAUNCHES[kname]} "
                    f"times after {what}, want {8 * i}")
        other = [v for k, v in K.LAUNCHES.items() if k != kname]
        if any(other):
            raise RuntimeError(f"{backend}: unexpected launches "
                               f"{K.LAUNCHES}")
        launches[kname] = K.LAUNCHES[kname]
        y, (y2, rows), m = got["run"], got["run+StatsTracer"], got["measure"]
        checks = {
            "run": torch.equal(y, y_ref),
            "traced run": torch.equal(y2, y_ref),
            "tracer rows": rows == rows_ref,
            "measure final": torch.equal(m["final"], y_ref),
            "measure rows": m["layers"] == m_ref["layers"],
            "energy_uj": m["energy_uj"] == m_ref["energy_uj"],
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"{backend} differs from ref on {bad}")
        log(f"phase 4: backend {backend!r}: run, traced run and measure "
            f"identical to ref; {kname} launched {launches[kname]} times "
            "(8 per run)")
    return {"program": prog, "x": x, "launches": launches}


# -- phase 5: timing ---------------------------------------------------------


def program_latency(torch, P, mp, card: str, reps: int = 10) -> None:
    """Host-clock ms per `run` and `measure` of the whole program, ending
    in a synchronize: what a caller of the pipeline waits for."""
    prog, x = mp["program"], mp["x"]
    for backend in ("ref", "cuda", "packed"):
        pipe = P.CutiePipeline(prog, backend=backend)
        for what, fn in (("run", lambda: pipe.run(x)),
                         ("measure", lambda: pipe.measure(x))):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            log(f"phase 5: program {what} on {backend!r}, batch {BATCH}: "
                f"median ms {float(np.median(ts))!r} (min "
                f"{min(ts)!r}, max {max(ts)!r}, {reps} runs, host clock; "
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


def time_kernels(torch, F, K, codec, engine, mp, card: str,
                 worst: dict) -> list[dict]:
    prog, x = mp["program"], mp["x"]
    acts, cur = [], x
    for instr in prog.layers:                  # each layer's real input
        acts.append(cur)
        th = instr.thresholds
        cur = K.ternary_conv2d_plain(
            cur, instr.weights, stride=instr.stride, padding=instr.padding,
            t_lo=th.t_lo, t_hi=th.t_hi, flip=th.flip, const=th.const,
            is_const=th.is_const, pool=instr.pool)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
              for name in REPLACES}
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
    K.reset_launches()                     # timing launches are not counted
    out = []
    for name, t in totals.items():
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": mp["launches"][name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] > t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"],
        })
        log(f"phase 5: {name} over the 8 layers: ms {t['ms']!r} "
            f"plain_ms {t['plain_ms']!r} library_ms {t['library_ms']!r} "
            f"bound_ms {t['bound_ms']!r} ({card})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.core import codec, engine, thermometer
    from repro_torch.kernels import _build
    from repro_torch.kernels import ternary_conv2d as K
    from repro_torch import pipeline as P

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
    mp = main_path(torch, K, engine, thermometer, P)
    program_latency(torch, P, mp, card)
    kernels = time_kernels(torch, F, K, codec, engine, mp, card, worst)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
