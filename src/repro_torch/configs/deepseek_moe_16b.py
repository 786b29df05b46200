"""deepseek-moe-16b [moe; arXiv:2401.06066, hf]: fine-grained MoE.

28L, d_model=2048, 16 heads / 16 kv (d_head=128), vocab=102400.
64 routed experts (d_ff=1408 each) top-6 + 2 shared experts; layer 0 is a
dense FFN (d_ff=10944), per the released model.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=10944,            # dense first layer width
    vocab=102400,
    n_experts=64,
    topk=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    first_dense=1,
)
