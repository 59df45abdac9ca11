"""qwen2.5-7b — the paper's primary evaluation model [arXiv:2412.15115; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. The paper quotes
28 KB/token KV (3584 hidden x 4 kv heads ... 2B) which this config matches:
4 kv heads x 128 d_head x 2 (K+V) x 2 B x 28 layers = 28.7 KB/token.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
