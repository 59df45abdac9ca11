"""Decoder-only LM: the dense, ssm and hybrid families.

Families:
  dense   — GQA attention + SwiGLU
  ssm     — mamba-1 mixer only (falcon-mamba)
  hybrid  — parallel attention + mamba heads, then SwiGLU (hymba)

Layers are stacked (leading axis = layer) in the params dict, with the JAX
package's keys, and run one after another in a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import attention_decode, attention_prefill, qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import matmul, rms_norm, swiglu
from repro_torch.models.ssm import (
    init_mamba_params,
    init_mamba_state,
    mamba_block,
    mamba_decode_step,
)

Params = Dict[str, Any]
STATE_FAMILIES = ("ssm", "hybrid")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights with the JAX package's shapes, scales and dtypes.

    ``generator`` must live on ``device``. Each layer is drawn in float32 and
    cast into its slot of the stacked tensor, so the float32 transient stays
    one layer's tensor at full width."""
    if cfg.family not in ("dense",) + STATE_FAMILIES:
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
    layers: Params = {}
    if cfg.has_attention:
        layers.update({
            "wq": stacked((d, cfg.n_heads, cfg.d_head), s_in),
            "wk": stacked((d, cfg.n_kv_heads, cfg.d_head), s_in),
            "wv": stacked((d, cfg.n_kv_heads, cfg.d_head), s_in),
            "wo": stacked((cfg.n_heads, cfg.d_head, d), cfg.attn_dim ** -0.5),
        })
        if cfg.qkv_bias:
            layers["bq"] = zeros((L, cfg.n_heads, cfg.d_head))
            layers["bk"] = zeros((L, cfg.n_kv_heads, cfg.d_head))
            layers["bv"] = zeros((L, cfg.n_kv_heads, cfg.d_head))
        if cfg.qk_norm:
            layers["q_norm"] = zeros((L, cfg.d_head))
            layers["k_norm"] = zeros((L, cfg.d_head))
    layers["attn_norm"] = zeros((L, d))  # pre-mixer norm of every family
    if cfg.family in STATE_FAMILIES:
        layers["mamba"] = init_mamba_params(cfg, generator, dtype, dev, L)
    if cfg.d_ff and cfg.family != "ssm":
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
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
            for k, v in params["layers"].items()}


def _ffn(h: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    if "w_gate" in lp:
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return h


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["unembed"] if not cfg.tie_embeddings else params["embed"].T
    return matmul(h, w).to(torch.float32)


def _out_proj(attn: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    b, s = attn.shape[:2]
    return matmul(attn.reshape(b, s, -1), lp["wo"].reshape(-1, cfg.d_model))


def _layer_prefill(h, lp, window, positions, cfg, block_q):
    """One layer over the whole prompt: (h, (k, v) or None, mamba state or None)."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    if cfg.family == "ssm":
        out, st = mamba_block(x, lp["mamba"], cfg, return_state=True)
        return h + out, None, st
    q, k, v = qkv_project(x, lp, cfg, positions)
    out = _out_proj(attention_prefill(q, k, v, window=window, block_q=block_q), lp, cfg)
    st = None
    if cfg.family == "hybrid":
        s_out, st = mamba_block(x, lp["mamba"], cfg, return_state=True)
        out = 0.5 * (out + s_out)
    h = _ffn(h + out, lp, cfg)
    return h, (k, v), st


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

    Returns logits (and per-layer KV, each (L, b, s, n_kv, d_head), if asked;
    None for the attention-free family)."""
    h = params["embed"][batch["tokens"]]
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    windows = cfg.window_sizes()
    ks, vs = [], []
    for l in range(cfg.n_layers):
        h, kv, _ = _layer_prefill(h, layer_params(params, l), int(windows[l]), positions,
                                  cfg, block_q)
        if return_kv and kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    logits = _logits(params, h[:, -1:] if logits_positions == "last" else h, cfg)
    if return_kv:
        return logits, ((torch.stack(ks), torch.stack(vs)) if ks else None)
    return logits


# --------------------------------------------------------------------------
# serving: prefill -> serve state, decode_step
# --------------------------------------------------------------------------
def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     device="cuda") -> Dict[str, Any]:
    """Zeroed serve state: ``length`` (valid positions, a Python int), the
    attention KV buffers ``k``/``v`` (L, b, max_len, n_kv, d_head) and the
    mamba state ``ssm_h`` (L, b, d_inner, n) float32 and ``ssm_conv``
    (L, b, k - 1, d_inner), as the family has them."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype()
    state: Dict[str, Any] = {"length": 0}
    if cfg.has_attention:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        state["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family in STATE_FAMILIES:
        h0, conv0 = init_mamba_state(batch, cfg, dtype, dev)
        state["ssm_h"] = h0.expand((cfg.n_layers,) + h0.shape).contiguous()
        state["ssm_conv"] = conv0.expand((cfg.n_layers,) + conv0.shape).contiguous()
    return state


def prefill(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    state: Dict[str, Any],
    *,
    block_q: int = 512,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, fill the serve state, return first-token logits.

    The state's buffers are written in place and the same dict is returned."""
    h = params["embed"][batch["tokens"]]
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    windows = cfg.window_sizes()
    for l in range(cfg.n_layers):
        h, kv, st = _layer_prefill(h, layer_params(params, l), int(windows[l]), positions,
                                   cfg, block_q)
        if kv is not None:
            state["k"][l, :, :s] = kv[0]
            state["v"][l, :, :s] = kv[1]
        if st is not None:
            state["ssm_h"][l] = st[0]
            state["ssm_conv"][l] = st[1]
    state["length"] = s
    return _logits(params, h[:, -1:], cfg), state


def decode_step(
    params: Params,
    token: torch.Tensor,  # (b, 1) integer
    cfg: ModelConfig,
    state: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step: append the token's KV, attend over the cache,
    advance the mamba state (through the selective_scan kernel at s = 1).

    The state's buffers are updated in place and the same dict is returned."""
    h = params["embed"][token]
    b = h.shape[0]
    length = int(state["length"])  # valid positions already in the cache
    positions = torch.full((b, 1), length, dtype=torch.long, device=h.device)
    windows = cfg.window_sizes()
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        xn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        if cfg.has_attention:
            q, k_new, v_new = qkv_project(xn, lp, cfg, positions)
            state["k"][l, :, length: length + 1] = k_new
            state["v"][l, :, length: length + 1] = v_new
            attn = attention_decode(q, state["k"][l], state["v"][l], length=length + 1,
                                    window=int(windows[l]))
            out = _out_proj(attn, lp, cfg)
        if cfg.family in STATE_FAMILIES:
            s_out, (h_s, conv_s) = mamba_decode_step(
                xn, (state["ssm_h"][l], state["ssm_conv"][l]), lp["mamba"], cfg)
            state["ssm_h"][l] = h_s
            state["ssm_conv"][l] = conv_s
            out = s_out if cfg.family == "ssm" else 0.5 * (out + s_out)
        h = _ffn(h + out, lp, cfg)
    state["length"] = length + 1
    return _logits(params, h, cfg), state
