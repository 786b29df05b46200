"""Trainable QAT model of the paper's CIFAR-10 CNN (Table III).

Training graph (float, differentiable):
    thermometer-encoded input (trits as float, channels last)
    -> [conv -> BN -> (pool) -> Hardtanh -> ternarize_STE] x 8
    -> FC -> logits
with weights ternarized via STE (TWN per-channel scale) or — for the INQ
experiments — kept latent and quantized by the `repro_torch.core.inq`
schedule, whose state (``mask``, ``q``) lives with each layer as buffers.

`CutieCNN.params()` is the reference's parameter tree
(`repro.models.cutie_cnn.init_params`): ``{"layers": [{"w", "gamma",
"beta", "mean", "var"}, ...], "fc"}``, with conv weights HWIO; the
tensors are the module's own.  `to_program` compiles the trained model
into a bit-true `core.engine.CutieProgram` (pure trits + folded
thresholds) through `repro_torch.compiler`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.cutie_cnn import CutieCNNConfig
from repro_torch.core import engine
from repro_torch.core import ternary as T
from repro_torch.device import resolve_device

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class ConvBlock(nn.Module):
    """One conv layer's parameters (``w`` HWIO, BN ``gamma``/``beta``),
    BN running stats (``mean``/``var``) and INQ state (``mask``/``q``)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        c_out = w.shape[-1]
        f32 = dict(dtype=torch.float32, device=w.device)
        self.w = nn.Parameter(w)
        self.gamma = nn.Parameter(torch.ones(c_out, **f32))
        self.beta = nn.Parameter(torch.zeros(c_out, **f32))
        self.register_buffer("mean", torch.zeros(c_out, **f32))
        self.register_buffer("var", torch.ones(c_out, **f32))
        self.register_buffer("mask", torch.zeros_like(w))
        self.register_buffer("q", torch.zeros_like(w))


class CutieCNN(nn.Module):
    """The QAT CNN on ``device`` (the card unless ``device="cpu"``),
    initialized from a `torch.Generator` seeded with ``seed`` on that
    device (He-style normal conv weights, fan-in 9*Cin; FC fan-in
    ``width``)."""

    def __init__(self, cfg: CutieCNNConfig = CutieCNNConfig(), *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        blocks, c_in = [], cfg.in_channels
        for _op, mult, _pool in cfg.layout:
            c_out = cfg.width * mult
            w = torch.randn((3, 3, c_in, c_out), generator=gen, device=dev)
            blocks.append(ConvBlock(w * (9 * c_in) ** -0.5))
            c_in = c_out
        self.layers = nn.ModuleList(blocks)
        self.fc = nn.Parameter(
            torch.randn((cfg.width, cfg.n_classes), generator=gen,
                        device=dev) * cfg.width ** -0.5)

    @property
    def device(self) -> torch.device:
        return self.fc.device

    # -- the reference's trees ----------------------------------------------

    def params(self) -> dict:
        """The parameter tree of the reference, on this module's tensors."""
        return {"layers": [{"w": b.w, "gamma": b.gamma, "beta": b.beta,
                            "mean": b.mean, "var": b.var}
                           for b in self.layers],
                "fc": self.fc}

    def trainable(self) -> dict:
        """The trained tensors by name, in the reference's leaf order
        (``fc``, then each layer's ``beta``, ``gamma``, ``w``; the BN
        running stats are buffers, set by `apply_bn_updates`)."""
        out = {"fc": self.fc}
        for i, b in enumerate(self.layers):
            out.update({f"layers.{i}.beta": b.beta,
                        f"layers.{i}.gamma": b.gamma,
                        f"layers.{i}.w": b.w})
        return out

    def inq_state(self) -> list:
        """The INQ state of the conv layers, as the reference's
        ``inq.init_state(params["layers"])`` tree, on this module's
        buffers."""
        return [{"w": {"mask": b.mask, "q": b.q}, "gamma": None,
                 "beta": None, "mean": None, "var": None}
                for b in self.layers]

    @torch.no_grad()
    def load_inq_state(self, state: list) -> None:
        """Copy an INQ state tree (as `inq_state` gives it) into the
        buffers."""
        for b, st in zip(self.layers, state, strict=True):
            b.mask.copy_(st["w"]["mask"])
            b.q.copy_(st["w"]["q"])

    def effective_weight(self, b: ConvBlock, inq: bool) -> torch.Tensor:
        """A layer's weights as the forward uses them: frozen entries
        replaced by their ``q`` (``inq``), else STE-quantized."""
        if inq:
            return torch.where(b.mask > 0, b.q, b.w)
        return _quant_w(b.w, self.cfg.weight_mode)

    # -- forward ------------------------------------------------------------

    def forward(self, x: torch.Tensor, *, train: bool = True,
                inq: bool = False):
        """x: thermometer trits as float (N, 32, 32, in_channels).

        Returns (logits, BN stat updates per layer).  With ``inq`` the
        conv weights come from the INQ mask/q combination and the FC
        stays float (the INQ experiments of Table IV); otherwise every
        weight is STE-quantized.

        Each layer's pre-activation (conv, BN, pool) is computed in
        float64 and rounded once to float32 before the quantizer, so it
        does not depend on the summation order of the device's conv or
        reductions: the card and the CPU quantize the same trits (a value
        within float32 noise of +-0.5 would otherwise flip a trit on one
        of them and part the two runs).  The conv's gradients stay
        float32 (`_Conv64`); the BN running stats stay float32, updated
        from the rounded batch statistics.
        """
        cfg = self.cfg
        bn_updates = []
        for (_op, _mult, pool), b in zip(cfg.layout, self.layers):
            w = self.effective_weight(b, inq)
            z = _Conv64.apply(x.permute(0, 3, 1, 2),
                              w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
            y, stats = _batchnorm(b, z, train)
            bn_updates.append(stats)
            # pooling happens BEFORE the activation quantizer — the
            # hardware pools pre-threshold integers (paper Fig. 5), and BN
            # is affine so pool(BN(z)) == BN(pool(z)).
            if pool is not None:
                kind, win = pool
                n, h, wd, c = y.shape
                yr = y.reshape(n, h // win, win, wd // win, win, c)
                y = (yr.amax(dim=(2, 4)) if kind == "max"
                     else yr.mean(dim=(2, 4)))
            x = _quant_act(y.float(), cfg.act_mode)
        feats = x.reshape(x.shape[0], -1)
        w_fc = self.fc if inq else _quant_w(self.fc, cfg.weight_mode)
        return feats @ w_fc, bn_updates


class _Conv64(torch.autograd.Function):
    """3x3 'same' conv of float32 NCHW ``x`` and OIHW ``w``: the value in
    float64, whose rounding to float32 no summation order moves; the
    gradients in float32, as the float32 conv's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x.double(), w.double(), padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1)
        return gx, gw


def _quant_w(w, mode: str):
    axes = tuple(range(w.dim() - 1))       # per-output-channel reduction
    if mode == "ternary":
        return T.ternarize_ste(w, axis=axes)
    if mode == "binary":
        return T.binarize_ste(w, axis=axes)
    return w


def _quant_act(x, mode: str):
    if mode == "ternary":
        return T.ternarize_act_ste(x)
    if mode == "binary":
        return T.binarize_act_ste(x)
    return x


def _batchnorm(b: ConvBlock, z, train: bool):
    """Returns (normalized, updated (mean, var)); the batch variance is
    the population variance (``correction=0``), as ``jnp.var``."""
    if train:
        mu = z.mean(dim=(0, 1, 2))
        var = z.var(dim=(0, 1, 2), correction=0)
        new_mean = (BN_MOMENTUM * b.mean
                    + (1 - BN_MOMENTUM) * mu.detach().float())
        new_var = (BN_MOMENTUM * b.var
                   + (1 - BN_MOMENTUM) * var.detach().float())
    else:
        mu, var = b.mean, b.var
        new_mean, new_var = b.mean, b.var
    y = b.gamma * (z - mu) * torch.rsqrt(var + BN_EPS) + b.beta
    return y, (new_mean, new_var)


def loss_fn(model: CutieCNN, batch: dict, *, train: bool = True,
            inq: bool = False):
    """Mean cross-entropy of ``batch`` (``x``, int64 ``y``); returns
    (loss, {"acc", "bn"})."""
    logits, bn_updates = model(batch["x"], train=train, inq=inq)
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, batch["y"][:, None]).mean()
    acc = (logits.argmax(-1) == batch["y"]).to(torch.float32).mean()
    return loss, {"acc": acc, "bn": bn_updates}


@torch.no_grad()
def apply_bn_updates(model: CutieCNN, bn_updates) -> None:
    """Set each layer's BN running stats to its update (after the
    optimizer step, as the reference's train step does)."""
    for b, (m, v) in zip(model.layers, bn_updates, strict=True):
        b.mean.copy_(m)
        b.var.copy_(v)


@torch.no_grad()
def to_graph(model: CutieCNN, *, inq: bool = False,
             include_head: bool = False):
    """Emit the trained QAT net as a `repro_torch.compiler` layer graph.

    With ``include_head=True`` the float FC classifier rides along as a
    dense node, which the compiler legalizes onto the OCU weight buffer
    (ternarized logits — the fully-on-accelerator deployment).
    """
    from repro_torch import compiler

    def snap(t):                 # the graph keeps copies, not the module's
        return t.detach().clone()

    cfg = model.cfg
    g = compiler.Graph(in_channels=cfg.in_channels,
                       in_hw=(cfg.img_hw, cfg.img_hw))
    for (_op, _mult, pool), b in zip(cfg.layout, model.layers):
        g.conv(snap(model.effective_weight(b, inq)),
               {k: snap(getattr(b, k)) for k in ("gamma", "beta", "mean",
                                                  "var")},
               pool=pool)
    if include_head:
        g.dense(snap(model.fc if inq
                     else _quant_w(model.fc, cfg.weight_mode)))
    return g


def to_program(model: CutieCNN,
               instance: engine.CutieInstance = engine.GF22_SCM, *,
               inq: bool = False, optimize: bool = False
               ) -> engine.CutieProgram:
    """Compile the trained model into the bit-true CUTIE program, on the
    model's device.

    Routed through `repro_torch.compiler` (graph emission +
    legalization); ``optimize=True`` additionally runs the exact sparsity
    passes (threshold constant folding + dead-channel elimination), which
    preserve outputs bit-exactly but may shrink per-layer channel counts.
    """
    from repro_torch import compiler

    return compiler.compile_graph(to_graph(model, inq=inq),
                                  instance=instance, optimize=optimize,
                                  device=model.device).program
