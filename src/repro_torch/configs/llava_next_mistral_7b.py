"""llava-next-mistral-7b [vlm; hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L, d_model=4096, 32 heads / 8 kv (d_head=128),
d_ff=14336, vocab=32000.  Vision tower is a STUB: the caller provides
precomputed CLIP patch embeddings (576 tokens base res, d_vision=1024);
the 2-layer multimodal projector is real and trained.  Anyres tiling would
add more image tokens at the same interface.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    img_tokens=576,
    d_vision=1024,
    rope_theta=1000000.0,
)
