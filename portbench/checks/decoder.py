"""`correct` for a served decoder cell: a seeded sample of the requests
finished in the window, with the longest prompt in it, run once through
the plain reference over each prompt and its served tokens.

The number compared is the widest gap by which a served (greedy) token's
reference logit lies below the reference's best at its position.  The
control is the reference in float8 activations: at each of the same
positions, the gap of the token it puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as TR


def sample(loop, t_end: float, n: int, seed: int) -> list[dict]:
    done = [r for r in loop.requests
            if r.get("tokens") and r["t_done"] <= t_end]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i]["prompt"]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = TR.rng(seed, "check").choice(len(rest), min(n - 1, len(rest)),
                                        replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def _gaps(logits, tokens) -> float:
    return max(float((lg.max(dim=-1).values
                      - lg.gather(1, t[:, None])[:, 0]).max())
               for lg, t in zip(logits, tokens))


def check(run: dict, ref, seed: int, device, control: bool = False
          ) -> dict:
    loop, limits = run["loop"], run["sizes"]["limits"]
    dims = run["system"].shape(run["sizes"])
    reqs = sample(loop, run["window"]["t_end"],
                  run["traffic"]["check_requests"], seed)
    if not reqs:
        return {"max_gap": {"value": float("inf"),
                            "limit": limits["max_gap"]}}
    seqs = [np.concatenate([r["prompt"], np.asarray(r["tokens"][:-1],
                                                    np.int64)])
            for r in reqs]
    rows = [list(range(len(r["prompt"]) - 1,
                       len(r["prompt"]) - 1 + len(r["tokens"])))
            for r in reqs]
    served = [torch.as_tensor(r["tokens"], device=device).long()
              for r in reqs]
    lg = ref.logits(dims, seed, seqs, rows, device)
    out = {"max_gap": {"value": _gaps(lg, served),
                       "limit": limits["max_gap"]}}
    if control:
        low = ref.logits(dims, seed, seqs, rows, device, act="fp8")
        out["control.max_gap"] = {
            "value": _gaps(lg, [x.argmax(dim=-1) for x in low]),
            "limit": limits["max_gap"]}
    return out
