"""Parameter counting for MODEL_FLOPS accounting (6*N*D / 6*N_active*D).

The reference's counts (`repro.roofline.params`), over the port's
parameter tree on the meta device (`repro_torch.launch.steps
.abstract_params`), which allocates nothing.
"""

from __future__ import annotations

from repro_torch.launch import shardings as SH
from repro_torch.models.config import ArchConfig


def _leaf_sizes(abstract_params) -> list:
    out = []

    def rec(path, x):
        n = x.numel()
        if path.endswith("w_packed"):
            n *= 5                  # packed trits: 5 weights per byte
        out.append((path, n))
        return x

    SH.tree_map_with_path(rec, abstract_params)
    return out


def count_params(cfg: ArchConfig) -> dict:
    from repro_torch.launch import steps
    sizes = _leaf_sizes(steps.abstract_params(cfg))
    total = sum(s for _, s in sizes)
    embed = sum(s for p, s in sizes
                if p.endswith("embed") or "enc_pos" in p or "dec_pos" in p)
    expert = sum(s for p, s in sizes
                 if any(t in p for t in ("gate_proj", "up_proj",
                                         "down_proj")))
    matmul = total - embed
    if cfg.tie_embeddings:
        # tied head still does a (D, V) matmul per token
        matmul += cfg.d_model * (-(-cfg.vocab // 256) * 256)
    if cfg.n_experts:
        active_expert = expert * cfg.topk / cfg.n_experts
        active = matmul - expert + active_expert
    else:
        active = matmul
    return {
        "total": total,
        "embed": embed,
        "matmul": matmul,
        "expert": expert,
        "active_matmul": int(active),
    }
