"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064. The paper's own
evaluation family (ContiguousKV evaluates Qwen2.5-7B/14B/32B).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
