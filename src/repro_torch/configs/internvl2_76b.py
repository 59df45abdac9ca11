"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821; unverified].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Vision tower is a
stub: inputs are precomputed patch embeddings per assignment spec.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    rope_theta=1_000_000.0,
)
