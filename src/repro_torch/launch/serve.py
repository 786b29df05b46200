"""Serving entry point: scheduler-driven engine demo over a reduced config.

``python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8
--scheduler priority``

Drives the unified `CutieEngine` with a resident `LLMExecutor`: the
pluggable scheduler owns admission order (every third request is
submitted at higher priority so the priority/deadline policies visibly
reorder), and the engine's stats report per-request latency percentiles
and queue depth alongside token throughput.  The arguments and output
are the reference's (`repro.launch.serve`); it runs on the card, or on
the CPU only when asked with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import CutieEngine, LLMExecutor, ServerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduler", default="fcfs",
                    choices=("fcfs", "priority", "deadline"))
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cpu on request)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(configs.get(args.arch))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TF.init_params(cfg, gen)
    scfg = ServerConfig(n_slots=args.slots, max_new_tokens=args.max_new,
                        temperature=args.temperature)
    engine = CutieEngine(args.scheduler)
    engine.register("llm", LLMExecutor(params, cfg, scfg))

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                      model="llm", priority=int(i % 3 == 0),
                      deadline=2.0 if i % 3 == 0 else 30.0,
                      tag="urgent" if i % 3 == 0 else "bulk")
    outs = {}
    for handle in engine.stream():
        outs[handle.uid] = handle.request.result
        print(f"req {handle.uid} ({handle.request.tag}, "
              f"{handle.latency * 1e3:.0f} ms): {handle.request.result}")
    dt = time.perf_counter() - t0

    stats = engine.stats()
    total_toks = sum(len(v) for v in outs.values())
    lat = stats["latency"]
    print(f"{len(outs)} requests, {total_toks} tokens in {dt:.2f}s "
          f"({total_toks / dt:.1f} tok/s, scheduler={stats['scheduler']}, "
          f"{args.slots} slots)")
    print(f"latency p50/p95/p99: {lat['p50']:.3f}/{lat['p95']:.3f}/"
          f"{lat['p99']:.3f}s, mean queue depth "
          f"{stats['queue_depth']['mean']:.1f}")
    return outs


if __name__ == "__main__":
    main()
