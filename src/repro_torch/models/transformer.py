"""Decoder-only LM, dense family: GQA attention + SwiGLU.

Layers are stacked (leading axis = layer) in the params dict, with the JAX
package's keys, and run one after another in a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_prefill, qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import matmul, rms_norm, swiglu

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights with the JAX package's shapes, scales and dtypes.

    ``generator`` must live on ``device``. Each layer is drawn in float32 and
    cast into its slot of the stacked tensor, so the float32 transient stays
    one layer's tensor at full width."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family!r} family is not ported yet")
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    d, L = cfg.d_model, cfg.n_layers

    def normal(shape, std):
        return (std * torch.randn(shape, generator=generator, device=dev)).to(dtype)

    def stacked(shape, std):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for l in range(L):
            out[l] = normal(shape, std)
        return out

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    s_in = d ** -0.5
    layers: Params = {
        "wq": stacked((d, cfg.n_heads, cfg.d_head), s_in),
        "wk": stacked((d, cfg.n_kv_heads, cfg.d_head), s_in),
        "wv": stacked((d, cfg.n_kv_heads, cfg.d_head), s_in),
        "wo": stacked((cfg.n_heads, cfg.d_head, d), cfg.attn_dim ** -0.5),
        "attn_norm": zeros((L, d)),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros((L, cfg.n_heads, cfg.d_head))
        layers["bk"] = zeros((L, cfg.n_kv_heads, cfg.d_head))
        layers["bv"] = zeros((L, cfg.n_kv_heads, cfg.d_head))
    if cfg.qk_norm:
        layers["q_norm"] = zeros((L, cfg.d_head))
        layers["k_norm"] = zeros((L, cfg.d_head))
    if cfg.d_ff:
        f = cfg.d_ff
        layers["w_gate"] = stacked((d, f), s_in)
        layers["w_up"] = stacked((d, f), s_in)
        layers["w_down"] = stacked((f, d), f ** -0.5)
        layers["ffn_norm"] = zeros((L, d))
    params: Params = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "layers": layers,
        "final_norm": zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((d, cfg.vocab_size), d ** -0.5)
    return params


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked per-layer tensors (views)."""
    return {k: v[l] for k, v in params["layers"].items()}


def _ffn(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    if "w_gate" in lp:
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return h


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["unembed"] if not cfg.tie_embeddings else params["embed"].T
    return matmul(h, w).to(torch.float32)


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    block_q: int = 512,
    logits_positions: str = "all",  # "all" (training) | "last" (prefill)
    return_kv: bool = False,
):
    """Full causal forward over ``batch["tokens"]`` (b, s).

    Returns logits (and per-layer KV, each (L, b, s, n_kv, d_head), if asked)."""
    h = params["embed"][batch["tokens"]]
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    windows = cfg.window_sizes()
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qkv_project(x, lp, cfg, positions)
        attn = attention_prefill(q, k, v, window=int(windows[l]), block_q=block_q)
        h = h + matmul(attn.reshape(b, s, -1), lp["wo"].reshape(-1, cfg.d_model))
        h = _ffn(h, lp, cfg)
        if return_kv:
            ks.append(k)
            vs.append(v)
    logits = _logits(params, h[:, -1:] if logits_positions == "last" else h, cfg)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits
