"""`correct` for a CNN cell: every answer of the window against the
plain reference's class trits for the same image.

The number compared is the count of answered images whose class trits
differ from the reference's in any class.  Every answer is a function of
its image alone, so the reference runs once over the pool, in blocks.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1024


def _outputs(ref, sizes, seed, pool, device, **kw) -> np.ndarray:
    out = [ref.outputs(sizes, seed, pool[i:i + BLOCK].to(device), **kw).cpu()
           for i in range(0, pool.shape[0], BLOCK)]
    return torch.cat(out).numpy()


def _mismatched(loop, want: np.ndarray) -> int:
    b = loop.batch
    return int(sum((res != want[c["chunk"] * b:(c["chunk"] + 1) * b])
                   .any(axis=1).sum()
                   for c, res in zip(loop.calls, loop.results)))


def check(run: dict, ref, seed: int, device, control: bool = False
          ) -> dict:
    loop, sizes, limits = run["loop"], run["sizes"], run["sizes"]["limits"]
    want = _outputs(ref, sizes, seed, loop.pool_host, device)
    out = {"mismatched_images": {"value": _mismatched(loop, want),
                                 "limit": limits["mismatched_images"]}}
    if control:
        ctl = _outputs(ref, sizes, seed, loop.pool_host, device,
                       fold_dtype=torch.bfloat16)
        out["control.mismatched_images"] = {
            "value": _mismatched_as(loop, ctl, want),
            "limit": limits["mismatched_images"]}
    return out


def _mismatched_as(loop, answers: np.ndarray, want: np.ndarray) -> int:
    """The count a run would read had ``answers`` been its answers."""
    b = loop.batch
    per_chunk = [(answers[i * b:(i + 1) * b] != want[i * b:(i + 1) * b])
                 .any(axis=1).sum() for i in range(loop.n_chunks)]
    return int(sum(per_chunk[c["chunk"]] for c in loop.calls))
