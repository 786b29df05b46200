"""llama3.2-1b [dense; hf:meta-llama/Llama-3.2-1B]: small llama3.

16L, d_model=2048, 32 heads / 8 kv (d_head=64), d_ff=8192, vocab=128256,
tied embeddings, rope theta 500k.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_head=64,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
)
