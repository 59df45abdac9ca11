"""mixtral-8x22b — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, SWA window 4096.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1_000_000.0,
)
