"""mamba2-780m [ssm; arXiv:2405.21060]: SSD, attention-free.

48 layers, d_model=1536 (d_inner=3072, 48 heads x headdim 64),
ssm_state=128, n_groups=1, vocab=50280; decodes in constant memory
(the recurrent state replaces a KV cache).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    d_state=128,
    ssm_headdim=64,
    n_groups=1,
    expand=2,
    chunk=256,
)
