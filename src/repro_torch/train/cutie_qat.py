"""QAT training of the paper's CNN on synthcifar (Table IV experiments).

One function = one Table IV row: train the CUTIE CNN with a given
(weight mode x quantization strategy), INQ schedule per paper Fig. 8,
evaluate accuracy + weight sparsity, and compile the bit-true program for
the energy model.  The reference is `repro.train.cutie_qat`: the same
schedule, optimizer and data, on ``device`` (the card unless
``device="cpu"``).

The trainer changes no global torch flag.  The convolutions' values are
float64 (`models.cutie_cnn.CutieCNN.forward`), so a step on the card
quantizes the trits a step on the CPU does; their gradients are float32,
in TF32 on the card where torch's defaults allow it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.cutie_cnn import CutieCNNConfig
from repro_torch.core import engine, inq
from repro_torch.data import cifar
from repro_torch.device import resolve_device
from repro_torch.models import cutie_cnn
from repro_torch.optim import adam


@dataclasses.dataclass(frozen=True)
class QATRunConfig:
    width: int = 32
    steps: int = 240
    batch: int = 64
    lr: float = 2e-3
    mode: str = "ternary"                 # ternary | binary
    strategy: str = "magnitude-inverse"   # inq strategy
    thermometer: str = "ternary"          # ternary | binary (input encoding)
    eval_n: int = 512
    seed: int = 0
    freeze_by: float = 0.75       # fraction of steps by which INQ completes
    data: cifar.SynthCifarConfig = cifar.SynthCifarConfig()


def _model_cfg(rc: QATRunConfig) -> CutieCNNConfig:
    return CutieCNNConfig(width=rc.width, act_mode=rc.mode,
                          weight_mode=rc.mode)


def inq_config(rc: QATRunConfig) -> inq.INQConfig:
    # with_scale=False: weights freeze to PURE trits {-1,0,+1}; the scale
    # lives in BN (gamma), exactly like the hardware (which only ever sees
    # trits + folded thresholds).  Per-phase scales would give different
    # alphas to different weights of one output channel — representable in
    # the float graph but NOT on the OCU, breaking bit-true parity.
    return inq.INQConfig(strategy=rc.strategy, mode=rc.mode,
                         with_scale=False)


def adam_config(rc: QATRunConfig) -> adam.AdamConfig:
    # weight decay is load-bearing for the INQ sparsity dynamics: unfrozen
    # weights decay toward 0 between phases, so orders that freeze large
    # weights LAST (magnitude-inverse) accumulate far more zeros —
    # the paper's Table IV mechanism.
    return adam.AdamConfig(lr=rc.lr, total_steps=rc.steps,
                           warmup_steps=max(1, rc.steps // 20),
                           weight_decay=0.02, grad_clip=5.0)


def train_step(model: cutie_cnn.CutieCNN, opt: dict, batch: dict,
               acfg: adam.AdamConfig) -> tuple[dict, dict]:
    """One INQ training step in place: loss and gradients, frozen
    gradients masked, the Adam update, then the BN running stats.
    Returns (new optimizer state, metrics as tensors)."""
    loss, aux = cutie_cnn.loss_fn(model, batch, train=True, inq=True)
    params = model.trainable()
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    for i, b in enumerate(model.layers):
        grads[f"layers.{i}.w"] = grads[f"layers.{i}.w"] * (1.0 - b.mask)
    new, opt, om = adam.apply_update(params, grads, opt, acfg)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(new[name])
    cutie_cnn.apply_bn_updates(model, aux["bn"])
    return opt, {"loss": loss.detach(), "acc": aux["acc"], **om}


def freeze(model: cutie_cnn.CutieCNN, cum_fraction: float,
           icfg: inq.INQConfig) -> None:
    """Advance the model's INQ state to ``cum_fraction`` frozen."""
    model.load_inq_state(inq.freeze(model.inq_state(),
                                    model.params()["layers"], cum_fraction,
                                    icfg))


def run(rc: QATRunConfig, device=None) -> dict:
    dev = resolve_device(device)
    cfg = _model_cfg(rc)
    icfg = inq_config(rc)
    model = cutie_cnn.CutieCNN(cfg, seed=rc.seed, device=dev)
    opt = adam.init_state(model.trainable())
    acfg = adam_config(rc)
    ternary_in = rc.thermometer == "ternary"

    frac = 0.0
    history = []
    freeze_steps = max(1, int(rc.steps * rc.freeze_by))
    for step in range(rc.steps):
        want = inq.phase_for_step(min(step, freeze_steps), freeze_steps,
                                  icfg)
        if want > frac:
            freeze(model, want, icfg)
            frac = want
        batch = cifar.encoded_batch(
            rc.data, "train", step * rc.batch, rc.batch,
            m=cfg.thermometer_m, ternary=ternary_in, device=dev)
        opt, m = train_step(model, opt, batch, acfg)
        if step % 20 == 0 or step == rc.steps - 1:
            history.append({"step": step, "loss": float(m["loss"]),
                            "acc": float(m["acc"]), "inq_frac": frac})

    # final freeze to 100% (ensures pure trits for compilation)
    freeze(model, 1.0, icfg)

    acc = evaluate(model, rc)
    sparsity = inq.weight_sparsity(model.inq_state(),
                                   model.params()["layers"])
    return {"model": model, "params": model.params(),
            "inq_state": {"layers": model.inq_state(), "fc": None},
            "cfg": cfg, "accuracy": acc, "weight_sparsity": sparsity,
            "history": history, "run_config": rc}


@torch.no_grad()
def evaluate(model: cutie_cnn.CutieCNN, rc: QATRunConfig,
             batch: int = 128) -> float:
    """Test-split accuracy over ``rc.eval_n`` images, BN in inference
    mode, INQ-effective weights."""
    ternary_in = rc.thermometer == "ternary"
    correct = tot = 0
    for start in range(0, rc.eval_n, batch):
        n = min(batch, rc.eval_n - start)
        b = cifar.encoded_batch(rc.data, "test", start, n,
                                m=model.cfg.thermometer_m,
                                ternary=ternary_in, device=model.device)
        logits, _ = model(b["x"], train=False, inq=True)
        correct += int((logits.argmax(-1) == b["y"]).sum())
        tot += n
    return correct / tot


def _fit_instance(result: dict, instance, include_head: bool = False):
    instance = instance or engine.GF22_SCM
    cfg = result["cfg"]
    # width-reduced nets still compile; the instance check needs n_i >= width
    return dataclasses.replace(
        instance, n_i=max(instance.n_i, cfg.in_channels),
        n_o=max(instance.n_o, cfg.width),
        n_layers=max(instance.n_layers,
                     len(cfg.layout) + (1 if include_head else 0)))


def to_graph(result: dict, include_head: bool = False):
    """Emit the trained run as a `repro_torch.compiler` layer graph."""
    return cutie_cnn.to_graph(result["model"], inq=True,
                              include_head=include_head)


def compile(result: dict, instance=None, *, include_head: bool = False,
            optimize: bool = True, **options):
    """Compile a trained run through `repro_torch.compiler` (graph
    emission -> legalization -> exact sparsity passes), on the model's
    device.

    Returns the full :class:`repro_torch.compiler.CompileResult` (program
    + per-pass cost reports); ``include_head=True`` puts the dense
    classifier on-accelerator and sizes the instance's layer FIFO for it.
    ``options`` are extra :class:`repro_torch.compiler.CompilerOptions`
    fields (e.g. ``pad_to=128``).
    """
    from repro_torch import compiler as _compiler

    inst = _fit_instance(result, instance, include_head=include_head)
    return _compiler.compile_graph(
        to_graph(result, include_head=include_head), instance=inst,
        optimize=optimize, device=result["model"].device, **options)


def to_program(result: dict, instance=None, optimize: bool = False):
    """Program-only shorthand over :func:`compile` (trunk, no head)."""
    return compile(result, instance, optimize=optimize).program
