#!/usr/bin/env python3
"""Measure how far bf16 rounding alone moves the SSM families, in the
JAX reference and in the PyTorch port side by side, on the CPU.

    PYTHONPATH=src python tools/ssm_rounding.py drift [--seeds 0 1 2]
    PYTHONPATH=src python tools/ssm_rounding.py grads

``drift``: zamba2-2.7b at reduced width (`reduce_for_smoke`) with its
full depth, 54 mamba2 layers and the shared attention block after every
6th (as the published config has it), seeded weights from the
reference's ``init_params``: the chunked forward over 16 tokens against
16 token-by-token decode steps, in each package on its own.  Per seed
and ``quant`` it prints the correlation of the last position's logits,
their largest difference and whether the decode's argmax is among the
forward's top 5.

``grads``: ``forward_loss``'s bf16 gradients of the reduced hybrid
(``quant="none"``) and of a 4-layer reduced mamba2 (token seeds 5, 6
and 7): per leaf, the relative L2 error of the port's gradient against
the reference's, beside the reference's own spread (the relative L2
distance between its gradients at its parameters and with half the
embedding moved up one bf16 ulp, as tests/test_torch_hybrid.py's
`check_gradients` measures it).
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro_torch import configs, convert
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke

HYBRID, SSM = "zamba2_2_7b", "mamba2_780m"
STEPS = 16


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _models(arch, seed, **kw):
    jcfg = jreduce(jconfigs.get(arch)).replace(**kw)
    cfg = reduce_for_smoke(configs.get(arch)).replace(**kw)
    jp = jax.jit(JTF.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    return jp, jcfg, p, cfg


def _compare(dec, fwd) -> dict:
    a, f = _f32(dec).ravel(), _f32(fwd).ravel()
    return {"corr": float(np.corrcoef(a, f)[0, 1]),
            "max_abs_diff": float(np.abs(a - f).max()),
            "max_abs_logit": float(np.abs(f).max()),
            "argmax_in_top5": bool(np.argmax(a) in np.argsort(f)[-5:])}


def drift(seed: int, quant: str) -> dict:
    jp, jcfg, p, cfg = _models(HYBRID, seed, quant=quant, n_layers=54,
                               attn_every=6)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (1, STEPS))
    with torch.no_grad():
        full = TF.forward_logits(p, {"tokens": torch.as_tensor(toks)}, cfg)
        caches = DEC.init_caches(cfg, 1, 2 * STEPS)
        for i in range(STEPS):
            logits, caches = DEC.decode_step(
                p, torch.as_tensor(toks[:, i:i + 1]), caches,
                torch.full((1,), i), cfg)
    port = _compare(logits[:, -1], full[:, -1])
    jfwd = jax.jit(JTF.forward_logits, static_argnums=2)
    jstep = jax.jit(JDEC.decode_step, static_argnums=4)
    jfull = jfwd(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    jcaches = JDEC.init_caches(jcfg, 1, 2 * STEPS)
    for i in range(STEPS):
        jlogits, jcaches = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jcaches,
                                 jnp.full((1,), i), jcfg)
    ref = _compare(jlogits[:, -1], jfull[:, -1])
    return {"seed": seed, "quant": quant, "reference": ref, "port": port}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nudged(jp):
    e = np.asarray(jp["embed"]).astype(np.float32)
    up = np.random.default_rng(9).random(e.shape) < 0.5
    return dict(jp, embed=jnp.asarray(np.where(up, e * (1 + 2.0 ** -7), e),
                                      jnp.bfloat16))


def grads(arch: str, token_seed: int, **kw) -> dict:
    jp, jcfg, _, cfg = _models(arch, 0, **kw)
    toks = np.random.default_rng(token_seed).integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    p = TF.stack_layers(convert.llm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    paths = [path for path, _ in _leaves(p)]
    leaves = [_at(p, path).requires_grad_(True) for path in paths]
    loss, _ = TF.forward_loss(TF.unstack_layers(p),
                              {k: torch.as_tensor(v) for k, v in
                               batch.items()}, cfg)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad = jax.jit(jax.grad(lambda q: JTF.forward_loss(q, jb, jcfg)[0]))
    want, nudged = jgrad(jp), jgrad(_nudged(jp))
    rows = {}
    for path, g in zip(paths, got):
        w = _f32(_at(want, path))
        norm = np.linalg.norm(w)
        err = np.linalg.norm((np.zeros_like(w) if g is None else _f32(g))
                             - w) / norm
        spread = np.linalg.norm(_f32(_at(nudged, path)) - w) / norm
        rows["/".join(path)] = (float(err), float(spread))
    return {"arch": arch, "token_seed": token_seed, **kw, "leaves": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("drift", "grads"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    if args.what == "drift":
        for seed in args.seeds:
            for quant in ("ternary_packed", "none"):
                print(json.dumps(drift(seed, quant)), flush=True)
        return 0
    runs = [grads(HYBRID, 5, quant="none")]
    runs += [grads(SSM, s, quant="none", n_layers=4) for s in (5, 6, 7)]
    for r in runs:
        errs = [e for e, _ in r["leaves"].values()]
        spreads = [s for _, s in r["leaves"].values()]
        over = {k: v for k, v in r["leaves"].items() if v[0] > 2.0 ** -4}
        print(json.dumps({k: v for k, v in r.items() if k != "leaves"}
                         | {"err_range": [min(errs), max(errs)],
                            "spread_range": [min(spreads), max(spreads)],
                            "over_2^-4": over,
                            "A_log": {k: v for k, v in r["leaves"].items()
                                      if k.endswith("A_log")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
