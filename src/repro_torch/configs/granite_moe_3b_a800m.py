"""granite-moe-3b-a800m — fine-grained MoE [hf:ibm-granite/granite-3.0; hf].

32L d_model=1536 24H (GQA kv=8) vocab=49155, 40 experts top-8, expert d_ff=512.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
)
