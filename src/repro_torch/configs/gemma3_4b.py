"""gemma3-4b — 5:1 local:global attention, 128k ctx [hf:google/gemma-3; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. d_head=256 (gemma's
attention inner dim != d_model). Local layers use SWA-1024.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
)
