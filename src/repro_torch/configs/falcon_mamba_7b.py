"""falcon-mamba-7b — attention-free mamba-1 [arXiv:2410.05355; unverified].

64L d_model=4096, ssm_state=16, vocab 65024, d_ff=0 (mamba mixer only).
ContiguousKV's KV-offload technique does not apply (there is no KV cache);
the architecture is served by the state-space engine instead.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
)
