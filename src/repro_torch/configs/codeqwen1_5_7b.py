"""codeqwen1.5-7b [dense; hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch (MHA + QKV bias).

32L, d_model=4096, 32 heads / 32 kv (d_head=128), d_ff=13440, vocab=92416.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_head=128,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1000000.0,
)
