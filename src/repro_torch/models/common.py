"""Shared model-configuration dataclass.

Every architecture is described by one `ModelConfig`. Models are plain
functions over a params dict whose per-layer tensors are stacked along axis 0,
with the same keys as the JAX package's pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # attention extras
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # applied on "local" layers
    local_global_ratio: int = 0  # e.g. 5 -> 5 local : 1 global (gemma3); 0 = all global
    # when sliding_window is set and local_global_ratio == 0 every layer is local
    # (mixtral-style SWA on all layers).

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (granite: 512; mixtral: 16384)
    moe_capacity_factor: float = 1.25  # >= n_experts/top_k makes dispatch dropless

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128  # chunked-scan block length (perf knob, §Perf)
    ssm_scan_dtype: str = "float32"  # "bfloat16" halves scan traffic

    # frontend stub: None | "audio" | "vision" — inputs arrive as precomputed
    # frame/patch embeddings of width d_model instead of token ids.
    frontend: Optional[str] = None

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return not self.is_attention_free

    def layer_is_local(self, layer_idx: int) -> bool:
        """True if `layer_idx` uses sliding-window (local) attention."""
        if self.sliding_window is None:
            return False
        if self.local_global_ratio <= 0:
            return True  # SWA everywhere (mixtral)
        # gemma3 pattern: ratio local layers then 1 global, repeating
        return (layer_idx % (self.local_global_ratio + 1)) != self.local_global_ratio

    def window_sizes(self) -> np.ndarray:
        """Per-layer attention window (0 => full causal). Shape (n_layers,)."""
        out = np.zeros((self.n_layers,), np.int32)
        for i in range(self.n_layers):
            if self.layer_is_local(i):
                out[i] = self.sliding_window
        return out

    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    # parameter counting -------------------------------------------------------
    def param_count(self) -> int:
        c = self
        n = 0
        n += c.vocab_size * c.d_model  # embed
        if not c.tie_embeddings:
            n += c.vocab_size * c.d_model  # unembed
        per_layer = 0
        if c.family == "ssm":
            d_in = c.d_inner
            per_layer += c.d_model * 2 * d_in  # in_proj
            per_layer += d_in * c.ssm_conv  # conv1d (depthwise)
            per_layer += d_in * (c.ssm_state * 2 + 1)  # x_proj -> (B, C, dt)
            per_layer += d_in  # dt bias
            per_layer += d_in * c.ssm_state  # A_log
            per_layer += d_in  # D
            per_layer += d_in * c.d_model  # out_proj
            per_layer += c.d_model  # norm
        else:
            # attention
            per_layer += c.d_model * c.attn_dim  # W_q
            per_layer += 2 * c.d_model * c.kv_dim  # W_k, W_v
            per_layer += c.attn_dim * c.d_model  # W_o
            if c.qkv_bias:
                per_layer += c.attn_dim + 2 * c.kv_dim
            per_layer += 2 * c.d_model  # 2 norms
            if c.family == "hybrid":
                d_in = c.d_inner
                per_layer += c.d_model * 2 * d_in + d_in * c.ssm_conv
                per_layer += d_in * (c.ssm_state * 2 + 1) + d_in
                per_layer += d_in * c.ssm_state + d_in + d_in * c.d_model
            # ffn
            if c.family == "moe":
                per_layer += c.d_model * c.n_experts  # router
                per_layer += c.n_experts * 3 * c.d_model * c.moe_d_ff
            elif c.d_ff:
                per_layer += 3 * c.d_model * c.d_ff  # SwiGLU
        n += c.n_layers * per_layer
        n += c.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        c = self
        full = self.param_count()
        moe_all = c.n_layers * c.n_experts * 3 * c.d_model * c.moe_d_ff
        moe_active = c.n_layers * c.top_k * 3 * c.d_model * c.moe_d_ff
        return full - moe_all + moe_active
