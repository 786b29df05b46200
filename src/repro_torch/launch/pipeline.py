"""GPipe pipeline parallelism over the `pod` mesh axis (dense family).

The multi-pod mesh (2, 16, 16) defaults to data parallelism over `pod`;
this module is the pipeline alternative, as in the reference: the layer
stack is split into S = pod contiguous stages (stacked layer leaves
sharded ``P("pod")`` on the layer dim, `stage_pspecs`), and M
microbatches stream through a T = M + S - 1 tick schedule.

The reference runs the stages under a partial-manual ``shard_map`` and
passes activations with ``lax.ppermute``; here each rank is one mesh
position: stage s holds its n_layers / S layers, stage 0 embeds, and at
every tick each stage runs its layers on the microbatch it holds (stage
s has microbatch t - s at tick t; a tick outside that range is a bubble
and computes nothing) and sends the bf16 result to stage s + 1 through
`Mesh.shift`, the reference's collective-permute.  The last stage's
outputs from tick S - 1 on are the batch: ``ln_f``, the head and
`losses.chunked_xent` (vocabulary-sharded under a model axis) run
there, and the loss and token count reach every rank by an all-reduce
over ``pod``.  Inside a stage the ``data`` and ``model`` axes keep the
unpipelined tensor and data parallelism: the stage runs under the mesh
without ``pod`` (`Mesh.sub`), so its batch sums leave the stages out.

Scope: the dense/GQA decoder family (llama / internlm2 / codeqwen /
qwen2.5), forward and loss, as the reference's test and dry run prove
it (its backward trips an XLA:CPU partitioner check; here a backward
would need every stage to take the reverse shifts in step, bubbles
included, and is not offered).  Dry run on the stand-in (2, 16, 16)
mesh, nothing allocated:
``python -m repro_torch.launch.pipeline --arch llama3.2-1b``.
"""

from __future__ import annotations

import torch

from repro_torch.launch import shardings as SH
from repro_torch.models import common as C
from repro_torch.models import losses
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig


def stage_pspecs(aparams, mesh):
    """Param specs of the stacked tree (`TF.stack_layers`): the stacked
    layer leaves gain ``P("pod")`` on the layer dim, the reference's
    specs leaf for leaf."""
    base = SH.param_specs(aparams, mesh)

    def leaf(path, x, spec):
        if path.startswith("layers/"):
            entries = list(spec) + [None] * (x.ndim - len(spec))
            entries[0] = "pod"
            return SH.P(*entries)
        return spec

    def walk(tree, specs, path):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k], f"{path}{k}/") for k, v in
                    tree.items()}
        if tree is None:
            return None
        return leaf(path[:-1], tree, specs)

    return walk(aparams, base, "")


def _check(cfg: ArchConfig, b: int, n_micro: int, n_stages: int) -> None:
    if cfg.family != "dense":
        raise ValueError(f"the pipeline runs the dense family, not "
                         f"{cfg.family}")
    if b % n_micro:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{n_micro} microbatches")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")


def pipeline_forward_loss(params, batch, cfg: ArchConfig, mesh,
                          n_micro: int = 4):
    """GPipe forward + xent loss on this rank's stage.  ``params``: this
    rank's slices under `stage_pspecs` (stacked layers, or the per-layer
    list of its stage's layers); ``batch``: tokens/labels (B, S), this
    rank's rows over ``data``.  Returns (loss, {"xent", "tokens"}) on
    every rank."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    n_stages = mesh.axis_size("pod")
    _check(cfg, b, n_micro, n_stages)
    mb = b // n_micro
    stage = mesh.coord("pod")
    last = stage == n_stages - 1
    layers = params["layers"]
    if isinstance(layers, dict):                 # the stacked form
        layers = TF.unstack_layers({"layers": layers})["layers"]
    inner = mesh.sub(tuple(a for a in mesh.axis_names if a != "pod"))
    positions = torch.arange(s, device=tokens.device)[None]
    run = TF._runner(cfg)
    outs = []
    with C.use_mesh(inner):
        if stage == 0:
            x_mb = TF._embed(params, tokens, cfg).reshape(n_micro, mb, s, -1)
        recv = torch.zeros((mb, s, cfg.d_model), dtype=torch.bfloat16,
                           device=tokens.device)
        for t in range(n_micro + n_stages - 1):
            if 0 <= t - stage < n_micro:
                y = x_mb[t].to(torch.bfloat16) if stage == 0 else recv
                for lp in layers:
                    y = run(TF.dense_block, lp, y, cfg, positions)
                if last:
                    outs.append(y)
            else:
                y = torch.zeros_like(recv)
            recv = mesh.shift(y, "pod")
        if last:
            x = TF._norm(cfg, params["ln_f"], torch.cat(outs))
            loss, cnt = losses.chunked_xent(
                x, TF.head_weight(params, cfg), labels, chunk=cfg.loss_chunk,
                vocab=TF.vocab_padded(cfg))
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            cnt = torch.zeros((), dtype=torch.float32, device=tokens.device)
    loss, cnt = mesh.all_reduce(torch.stack([loss, cnt]), "pod")
    return loss, {"xent": loss, "tokens": cnt}


# ---------------------------------------------------------------------------
# dry-run entry: walk the pipelined step on the stand-in 2x16x16 mesh
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models.config import SHAPES
    from repro_torch.roofline import hlo

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--n-micro", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    shape, axes = M.PRODUCTION[True]
    aparams = steps.abstract_params(cfg, stacked=True)
    train = SHAPES["train_4k"]
    gbatch = {k: steps._meta((train.global_batch, train.seq_len),
                             torch.int32) for k in ("tokens", "labels")}
    for stage in (0, shape[0] - 1):
        mesh = M.StandInMesh(shape, axes, coord={"pod": stage})
        pspecs = stage_pspecs(aparams, mesh)
        local = SH.shard_tree(aparams, pspecs, mesh)
        lbatch = SH.shard_tree(gbatch, {k: SH.P("data", None)
                                        for k in gbatch}, mesh)
        w = hlo.walk(lambda p, bt: pipeline_forward_loss(
            p, bt, cfg, mesh, n_micro=args.n_micro), (local, lbatch), mesh)
        coll = hlo.collective_bytes(w.records)
        perm = coll["by_op"].get("collective-permute", {})
        print(f"PP dry run of stage {stage} walked on {mesh.shape}")
        print("memory:", hlo.memory(w))
        print("collective-permute count:", perm.get("count", 0),
              "bytes:", perm.get("payload_bytes", 0.0))


if __name__ == "__main__":
    main()
