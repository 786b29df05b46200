"""whisper-medium [audio; arXiv:2212.04356]: enc-dec, conv frontend stub.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (MHA, kv=16),
d_ff=4096, vocab=51865.  The conv frontend is a STUB: the caller provides
precomputed 1500 mel-frame embeddings (paper spec'd 30 s audio -> 1500
frames).  Encoder is non-causal with learned positions; decoder is causal
with RoPE here, as in the reference (HF whisper uses learned decoder
positions; rope is the reference's uniform decoder substrate).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    act="gelu",
    norm="layernorm",
)
