"""Step builders + abstract input specs for every (arch x shape) cell.

`build_cell(cfg, shape_name, mesh)` returns what a trainer or a server
needs: the step function, which takes and returns each rank's local
slices under the reference's in/out specs (run under the mesh), and
stand-ins of its global arguments on the ``meta`` device (shapes and
dtypes, no allocation), as the reference returns ShapeDtypeStructs.

The reference jits each step with explicit in/out shardings and lets
GSPMD partition it; the port's steps are the same functions run on each
rank's slices (`repro_torch.launch.shardings.shard_tree` makes them),
with the collectives written out in the model code.
"""

from __future__ import annotations

import torch

from repro_torch.launch import shardings as SH
from repro_torch.models import common as C
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.optim import adam
from repro_torch.train import loop

BATCH_AXES = ("pod", "data")
P = SH.P


class _MetaGen:
    """A generator stand-in for `TF.init_params` on the meta device."""
    device = torch.device("meta")


def abstract_params(cfg: ArchConfig, *, stacked: bool = False):
    """The parameter tree on the meta device: the port's layout (one dict
    per layer), or the reference's stacked one with ``stacked``."""
    p = TF.init_params(cfg, _MetaGen())
    return TF.stack_layers(p) if stacked else p


def abstract_opt_state(cfg: ArchConfig, *, stacked: bool = False):
    return adam.init_state(loop._leaves(abstract_params(cfg,
                                                        stacked=stacked)))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Abstract training/prefill batch."""
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.family == "vlm":
        out["tokens"] = _meta((b, s - cfg.img_tokens), torch.int32)
        out["patches"] = _meta((b, cfg.img_tokens, cfg.d_vision),
                               torch.bfloat16)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        out["labels"] = _meta(out["tokens"].shape, torch.int32)
    return out


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    out = {"tokens": P(BATCH_AXES, None)}
    if cfg.family == "vlm":
        out["patches"] = P(BATCH_AXES, None, None)
    if cfg.family == "encdec":
        out["frames"] = P(BATCH_AXES, None, None)
    if shape.kind == "train":
        out["labels"] = P(BATCH_AXES, None)
    return out


def decode_struct(cfg: ArchConfig, shape: ShapeSpec):
    b, s = shape.global_batch, shape.seq_len
    return {"token": _meta((b, 1), torch.int32),
            "pos": _meta((b,), torch.int32),
            "caches": DEC.init_caches(cfg, b, s, device="meta")}


def decode_pspecs(cfg: ArchConfig):
    return {"token": P(BATCH_AXES, None),
            "pos": P(BATCH_AXES),
            "caches": DEC.cache_pspecs(cfg)}


# ---------------------------------------------------------------------------
# Step functions (each rank's slices, under the ambient mesh)
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, adam_cfg: adam.AdamConfig,
                    placement: adam.Placement | None = None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); on a mesh ``placement`` says how the update sees its
    leaves (`build_cell` makes it)."""
    step = loop.make_step(lambda p, b: TF.forward_loss(p, b, cfg), adam_cfg,
                          loop.TrainLoopConfig(), placement)

    def train_step(params, opt_state, batch):
        return step(params, opt_state, None, batch)

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return TF.forward_logits(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig, *, kv_sharded: bool = True,
                     cross_sharded: bool = True):
    def serve_step(params, token, caches, pos):
        return DEC.decode_step(params, token, caches, pos, cfg,
                               kv_sharded=kv_sharded,
                               cross_sharded=cross_sharded)
    return serve_step


def _under(mesh, fn):
    """``fn`` run with ``mesh`` ambient."""
    def run(*args):
        with C.use_mesh(mesh):
            return fn(*args)
    return run


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------


def build_cell(cfg: ArchConfig, shape_name, mesh,
               adam_cfg: adam.AdamConfig | None = None):
    """Returns (step, abstract args, specs) for one (arch, shape) on
    ``mesh``: ``step`` takes and returns each rank's local slices of the
    arguments, whose global stand-ins (meta tensors) are ``abstract
    args`` and whose partition specs (in, out) are ``specs``.
    ``shape_name`` is a key of `SHAPES` or a `ShapeSpec`."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    aparams = abstract_params(cfg)
    pspecs = SH.param_specs(aparams, mesh)

    if shape.kind == "train":
        adam_cfg = adam_cfg or adam.AdamConfig()
        ospecs = SH.opt_state_specs(aparams, pspecs, mesh)
        placement = adam.Placement(mesh, tuple(SH.spec_leaves(pspecs)),
                                   tuple(SH.spec_leaves(ospecs["mu"])))
        bstruct = batch_struct(cfg, shape)
        bspecs = SH.fit_named(mesh, batch_pspecs(cfg, shape), bstruct)
        fn = make_train_step(cfg, adam_cfg, placement)
        ostruct = abstract_opt_state(cfg)
        specs = {"in": (pspecs, ospecs, bspecs),
                 "out": (pspecs, ospecs, P()), "placement": placement}
        return fn, (aparams, ostruct, bstruct), specs

    if shape.kind == "prefill":
        bstruct = batch_struct(cfg, shape)
        bspecs = SH.fit_named(mesh, batch_pspecs(cfg, shape), bstruct)
        b = shape.global_batch
        logits = _meta((b, 1, TF.vocab_padded(cfg)), torch.bfloat16)
        out = SH.fit_named(mesh, P(BATCH_AXES, None, "model"), logits)
        fn = _under(mesh, torch.no_grad()(make_prefill_step(cfg)))
        return fn, (aparams, bstruct), {"in": (pspecs, bspecs), "out": out}

    # decode: specs are fitted to the concrete shapes (batch=1 cells and
    # non-divisible cache dims replicate instead of erroring)
    dstruct = decode_struct(cfg, shape)
    dspecs = decode_pspecs(cfg)
    cache_specs = SH.fit_named(mesh, dspecs["caches"], dstruct["caches"])
    # whether each rank's KV (and whisper's cross) cache holds its model
    # slice of the sequence, or all of it (the dim does not divide)
    kv_sharded, cross_sharded = (
        all(s[2] is not None for s in SH.spec_leaves(cache_specs.get(k)))
        for k in ("kv", "cross"))
    b = shape.global_batch
    logits = _meta((b, 1, TF.vocab_padded(cfg)), torch.bfloat16)
    token_spec = SH.fit_named(mesh, dspecs["token"], dstruct["token"])
    pos_spec = SH.fit_named(mesh, dspecs["pos"], dstruct["pos"])
    fn = _under(mesh, torch.no_grad()(make_decode_step(
        cfg, kv_sharded=kv_sharded, cross_sharded=cross_sharded)))
    specs = {"in": (pspecs, token_spec, cache_specs, pos_spec),
             "out": (SH.fit_named(mesh, P(BATCH_AXES, None, "model"),
                                  logits), cache_specs)}
    args = (aparams, dstruct["token"], dstruct["caches"], dstruct["pos"])
    return fn, args, specs
