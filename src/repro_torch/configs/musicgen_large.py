"""musicgen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32 == MHA) d_ff=8192 vocab=2048. Audio frontend
(EnCodec) is a stub: inputs arrive as precomputed frame embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
)
