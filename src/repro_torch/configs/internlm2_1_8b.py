"""internlm2-1.8b [dense; arXiv:2403.17297, hf]: GQA.

24L, d_model=2048, 16 heads / 8 kv (d_head=128), d_ff=8192, vocab=92544.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    d_head=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1000000.0,
)
