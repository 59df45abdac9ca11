"""Per-layer FLOP/byte cost model for the Re-Prefill simulator.

Used only in simulated mode (paper-scale configs on the CPU container); real
mode measures wall time. Costs are per single request (batch=1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class LayerCost:
    flops: float
    hbm_bytes: float


def ssm_layer_weights(cfg: ModelConfig) -> int:
    """Parameter count of one layer's mamba mixer (in/out projections, the
    depthwise conv, x-projection and the per-channel scan parameters)."""
    d, d_in, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return (d * 2 * d_in            # in_proj -> (x, z)
            + k * d_in + d_in       # depthwise conv + bias
            + d_in * (2 * n + 1)    # x_proj -> (B, C, dt)
            + d_in * n + 2 * d_in   # A_log, D, dt_bias-ish
            + d_in * d)             # out_proj


def layer_weight_bytes(cfg: ModelConfig, bytes_per_el: int = 2) -> int:
    """Weight bytes streamed from HBM by one token batch through one layer.

    Family-aware: an MoE layer streams the router plus only the ``top_k``
    *active* experts' FFN weights (not the full expert stack); an SSM layer
    streams the mamba mixer parameters instead of attention projections; a
    hybrid layer streams both its attention half and its mamba mixer."""
    per_layer = cfg.d_model * cfg.attn_dim + 2 * cfg.d_model * cfg.kv_dim
    per_layer += cfg.attn_dim * cfg.d_model
    if cfg.family == "moe":
        # router + only the active experts' weights stream per token batch
        per_layer += cfg.d_model * cfg.n_experts
        per_layer += cfg.top_k * 3 * cfg.d_model * cfg.moe_d_ff
    else:
        per_layer += 3 * cfg.d_model * cfg.d_ff
    if cfg.family in ("ssm", "hybrid"):
        per_layer += ssm_layer_weights(cfg)
    return per_layer * bytes_per_el


def ssm_state_bytes(cfg: ModelConfig) -> int:
    """Per-layer recurrent-state bytes of an SSM/hybrid layer: the fp32
    recurrence h (d_inner, ssm_state) plus the (ssm_conv - 1, d_inner)
    activation-dtype conv window.  Constant — decode never grows it."""
    if not cfg.ssm_state:
        return 0
    return (cfg.d_inner * cfg.ssm_state * 4
            + (cfg.ssm_conv - 1) * cfg.d_inner * 2)


def suffix_layer_cost(cfg: ModelConfig, suffix_len: int, attended_tokens: int) -> LayerCost:
    """One transformer layer over the suffix, attending to `attended_tokens`
    (selected prefix tokens + suffix)."""
    s = suffix_len
    proj = 2 * s * cfg.d_model * (cfg.attn_dim + 2 * cfg.kv_dim + cfg.attn_dim)
    attn = 2 * 2 * s * attended_tokens * cfg.n_heads * cfg.d_head  # qk + pv
    if cfg.family == "moe":
        ffn = 2 * 3 * s * cfg.top_k * cfg.d_model * cfg.moe_d_ff
    else:
        ffn = 2 * 3 * s * cfg.d_model * cfg.d_ff
    kv_bytes = 2 * attended_tokens * cfg.kv_dim * 2
    return LayerCost(
        flops=float(proj + attn + ffn),
        hbm_bytes=float(layer_weight_bytes(cfg) + kv_bytes),
    )


def identification_cost(cfg: ModelConfig, suffix_len: int, prefix_len: int) -> LayerCost:
    """Score q_suffix against all prefix (probe) keys: s x n x H x d matmul."""
    flops = 2 * suffix_len * prefix_len * cfg.n_heads * cfg.d_head
    bytes_ = prefix_len * cfg.kv_dim * 2
    return LayerCost(flops=float(flops), hbm_bytes=float(bytes_))


def probe_bytes(cfg: ModelConfig, prefix_len: int, key_ratio: float = 1.0) -> int:
    """Bytes of per-layer probing keys (K only)."""
    return int(prefix_len * cfg.kv_dim * 2 * key_ratio)


def token_kv_bytes(cfg: ModelConfig) -> int:
    """K+V bytes per token per layer (bf16)."""
    return 2 * cfg.kv_dim * 2


def prefill_chunk_cost(cfg: ModelConfig, chunk_len: int,
                       attended_tokens: int) -> LayerCost:
    """One prefill chunk of ``chunk_len`` suffix tokens through one layer's
    part-B (attention over the attended set + out-proj + FFN).

    FLOPs are the chunk's linear share of the monolithic op (projections,
    attention and FFN all scale with the token count, so the chunks sum
    exactly to the unchunked FLOPs), but HBM traffic is *not* linear: every
    chunk re-streams the layer weights and re-reads the whole attended KV,
    which is the real cost of chunked prefill.  The weight slice is the
    batch-shared part — a mixed batch iteration pays it once
    (``layer_weight_bytes``), so chunks riding a decode iteration add only
    their KV traffic."""
    lc = suffix_layer_cost(cfg, chunk_len, attended_tokens)
    part_a = 2.0 * chunk_len * cfg.d_model * (cfg.attn_dim + 2 * cfg.kv_dim)
    return LayerCost(flops=float(lc.flops - part_a), hbm_bytes=lc.hbm_bytes)


def chunk_recompute_cost(cfg: ModelConfig, span_tokens: int,
                         frontier_tokens: int = 0) -> LayerCost:
    """Recompute `span_tokens` of prefix KV by extending a causal recompute
    frontier that currently ends at `frontier_tokens`.

    The span runs through *every* layer of the model (one truncated causal
    forward), each position attending to the frontier plus its own causal
    prefix within the span, so the attention term uses the average attended
    length ``frontier + (span + 1) / 2``.  The cost is exactly additive in
    the frontier: ``cost(a, 0) + cost(b - a, a) == cost(b, 0)`` FLOP-wise,
    which is what lets the hybrid planner walk cut points incrementally.

    HBM traffic per layer = weights + the KV read of the attended set; the
    embedding lookup is included, the LM head is not (recompute produces KV,
    not logits).  The batch-shared slice is ``n_layers * layer_weight_bytes``
    (the whole model streams once per iteration), matching ``weight_key =
    "model"`` in the step plan."""
    avg_attended = frontier_tokens + (span_tokens + 1) / 2.0
    lc = suffix_layer_cost(cfg, span_tokens, avg_attended)
    flops = cfg.n_layers * lc.flops + 2.0 * span_tokens * cfg.d_model
    hbm = cfg.n_layers * lc.hbm_bytes
    return LayerCost(flops=float(flops), hbm_bytes=float(hbm))


def decode_layer_cost(cfg: ModelConfig, attended_tokens: int) -> LayerCost:
    """One decode position through one layer: the suffix cost at s=1."""
    return suffix_layer_cost(cfg, 1, attended_tokens)


def decode_weight_bytes(cfg: ModelConfig) -> float:
    """HBM weight bytes streamed per decode step (all layers + LM head).

    This is the batch-shared part of a decode step's memory traffic:
    continuous batching pays it once per iteration regardless of how many
    requests' tokens are in the batch."""
    return float(cfg.n_layers * layer_weight_bytes(cfg)
                 + cfg.d_model * cfg.vocab_size * 2)


def ssm_decode_cost(cfg: ModelConfig, attended_per_layer=None) -> LayerCost:
    """One SSM/hybrid decode position across all layers + the LM head.

    Pure SSM layers touch a *constant* footprint per step: the mixer weights
    plus the fixed-size recurrence state (``ssm_state_bytes``) — no KV read
    that grows with the decoded length.  Hybrid layers additionally pay the
    attention-side decode cost over ``attended_per_layer``."""
    d, d_in, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    mixer_flops = 2.0 * (d * 2 * d_in              # in_proj
                         + cfg.ssm_conv * d_in     # depthwise conv window
                         + d_in * (2 * n + 1)      # x_proj
                         + 3 * d_in * n            # dA*h + dB*x, C readout
                         + d_in * d)               # out_proj
    flops = cfg.n_layers * mixer_flops
    hbm = cfg.n_layers * float(layer_weight_bytes(cfg) + ssm_state_bytes(cfg))
    if cfg.family == "hybrid" and attended_per_layer is not None:
        for m in attended_per_layer:
            attn = 2 * 2 * 1 * int(m) * cfg.n_heads * cfg.d_head
            flops += attn
            hbm += 2 * int(m) * cfg.kv_dim * 2
    flops += 2.0 * cfg.d_model * cfg.vocab_size
    hbm += cfg.d_model * cfg.vocab_size * 2
    return LayerCost(flops=float(flops), hbm_bytes=float(hbm))


def ssm_prefill_cost(cfg: ModelConfig, chunk_len: int,
                     attended_tokens: int = 0) -> LayerCost:
    """One prefill chunk of ``chunk_len`` tokens through all layers of an
    SSM/hybrid model.  The scan is linear in the chunk length (no quadratic
    attention term for pure SSM); hybrid adds attention over
    ``attended_tokens``."""
    d, d_in, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    s = chunk_len
    mixer_flops = 2.0 * s * (d * 2 * d_in + cfg.ssm_conv * d_in
                             + d_in * (2 * n + 1) + 3 * d_in * n + d_in * d)
    flops = cfg.n_layers * mixer_flops
    hbm = cfg.n_layers * float(layer_weight_bytes(cfg) + ssm_state_bytes(cfg))
    if cfg.family == "hybrid":
        for _ in range(cfg.n_layers):
            flops += 2 * 2 * s * max(attended_tokens, s) * cfg.n_heads * cfg.d_head
            hbm += 2 * max(attended_tokens, s) * cfg.kv_dim * 2
    flops += 2.0 * s * cfg.d_model  # embedding
    return LayerCost(flops=float(flops), hbm_bytes=float(hbm))


def decode_step_cost(cfg: ModelConfig, attended_per_layer) -> LayerCost:
    """One decode position across all layers + the LM head.

    `attended_per_layer` gives the token count attended at each layer
    (selected units * unit_tokens + suffix + decoded-so-far)."""
    flops = 0.0
    hbm = 0.0
    for m in attended_per_layer:
        lc = decode_layer_cost(cfg, int(m))
        flops += lc.flops
        hbm += lc.hbm_bytes
    flops += 2.0 * cfg.d_model * cfg.vocab_size
    hbm += cfg.d_model * cfg.vocab_size * 2
    return LayerCost(flops=float(flops), hbm_bytes=float(hbm))
