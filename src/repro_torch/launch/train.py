"""Training entry point:
``python -m repro_torch.launch.train --arch llama3.2-1b ...``.

The reference's CLI (`repro.launch.train`): the reduced (smoke) config
by default, the full-size architecture with ``--full-config``.  It runs
on the card, or on the CPU only when asked with ``--device cpu``.
``--mesh auto`` in a single process means no mesh, as the reference
with one device.  Launched as several processes (``torchrun
--nproc-per-node N -m repro_torch.launch.train ...``, which sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous address),
``--mesh auto`` joins them in one process group (NCCL on cards, one
card per process, ``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and
trains on a ``data`` mesh over them: every rank draws the same params
and batches, trains on its rows, and rank 0 prints and writes the
history.  ``--history PATH`` writes the loop's history rows as JSON
lines.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import tokens
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TF
from repro_torch.models.config import ShapeSpec, reduce_for_smoke
from repro_torch.optim import adam
from repro_torch.train import loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full-size architecture")
    ap.add_argument("--quant", default=None,
                    choices=[None, "none", "ternary"],
                    help="override the config's weight quantization")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "ternary"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (all visible devices as data axis), 'none'")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cpu on request)")
    ap.add_argument("--history", default="",
                    help="write the history rows here (JSON lines)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full_config:
        cfg = reduce_for_smoke(cfg)
    if args.quant:
        cfg = cfg.replace(quant=args.quant)
    mesh = None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh == "auto" and world > 1:
        dev, mesh = _data_mesh(dev, world)

    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    src = tokens.for_arch(cfg, shape)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = TF.stack_layers(TF.init_params(cfg, gen))

    def data_fn(step: int):
        b = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in src.batch(step).items()}
        # the stub inputs of encdec (frames) and vlm (patches), drawn as
        # the reference draws them
        if cfg.family == "encdec":
            rng = np.random.default_rng(step)
            b["frames"] = torch.as_tensor(rng.normal(size=(
                args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32),
                device=dev)
        if cfg.family == "vlm":
            rng = np.random.default_rng(step)
            b["patches"] = torch.as_tensor(rng.normal(size=(
                args.batch, cfg.img_tokens, cfg.d_vision)).astype(
                    np.float32), device=dev)
            b["tokens"] = b["tokens"][:, :args.seq - cfg.img_tokens]
            b["labels"] = b["labels"][:, :args.seq - cfg.img_tokens]
        return b

    def loss_fn(p, batch):
        return TF.forward_loss(TF.unstack_layers(p), batch, cfg)

    tcfg = loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        fail_at_step=args.fail_at_step, grad_compress=args.grad_compress)
    acfg = adam.AdamConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(1, args.steps // 10))

    try:
        result = loop.train(loss_fn, params, data_fn, tcfg, acfg, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if mesh is not None and int(os.environ.get("RANK", "0")) != 0:
        return result
    if args.history:
        loop.write_history(args.history, result)

    last = result["history"][-1]
    print(f"final: step={last['step']} loss={last['loss']:.4f} "
          f"xent={last.get('xent', float('nan')):.4f}")
    if result["restored_from"] is not None:
        print(f"(restored from checkpoint step {result['restored_from']})")
    if result["stragglers"]:
        print(f"stragglers: {len(result['stragglers'])}")
    return result


def _data_mesh(dev: torch.device, world: int):
    """This process's device and a ``data`` mesh over the launched world
    (the rendezvous from the launcher's environment)."""
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev, M.make_mesh((world,), ("data",), dev)


if __name__ == "__main__":
    main()
