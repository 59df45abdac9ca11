"""Decoder-only LM covering every assigned family.

Families:
  dense   — GQA attention + SwiGLU
  moe     — GQA attention + top-k MoE FFN (models/moe.py)
  ssm     — mamba-1 mixer only (falcon-mamba)
  hybrid  — parallel attention + mamba heads, then SwiGLU (hymba)
  audio / vlm — dense backbone; inputs are precomputed frame/patch
           embeddings (models/frontends.py), ``{"embeds": (b, s, d_model)}``

Layers are stacked (leading axis = layer) in the params dict, with the JAX
package's keys, and run one after another in a Python loop. ``forward``
takes the JAX package's ``remat`` (per-layer activation checkpointing) and
``loss_fn`` is its next-token cross entropy, for training.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.launch import act_sharding
from repro_torch.models.attention import attention_decode, attention_prefill, qkv_project
from repro_torch.models.common import Leaves, ModelConfig
from repro_torch.models.layers import matmul, rms_norm, swiglu
from repro_torch.models.moe import init_moe_params, moe_ffn
from repro_torch.models.ssm import (
    init_mamba_params,
    init_mamba_state,
    mamba_block,
    mamba_decode_step,
)

Params = Dict[str, Any]
STATE_FAMILIES = ("ssm", "hybrid")
FAMILIES = ("dense", "moe", "audio", "vlm") + STATE_FAMILIES


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", shardings=None) -> Params:
    """Random weights with the JAX package's shapes, scales and dtypes.

    ``generator`` must live on ``device`` (on ``device="meta"``, which
    allocates nothing and gives the shapes and dtypes alone, it may be
    None). Each layer is drawn in float32 and
    cast into its slot of the stacked tensor, so the float32 transient stays
    one layer's tensor at full width.

    ``shardings`` (a tree of ``NamedSharding`` in the params' structure,
    ``launch.sharding.param_shardings``): the params laid out on its mesh,
    a tree of ``ShardedTensor`` bit for bit ``shard_tree(init_params(cfg,
    generator, device), shardings)``. The same draws are made on ``device``
    in the same order, and each layer's cast slice is written straight into
    the blocks that hold it: no whole stacked leaf is ever formed, so a
    model no one device holds can be laid out over several."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    dev = resolve_device(device)
    if shardings is None:
        make = Leaves(generator, dev)
    else:
        from repro_torch.launch.sharding import LaidOutLeaves

        make = LaidOutLeaves(generator, dev, shardings)
    dtype = cfg.activation_dtype()
    d, L = cfg.d_model, cfg.n_layers

    def stacked(name, shape, std):
        return make.stacked(("layers", name), L, shape, std, dtype)

    def zeros(path, shape):
        return make.const(path, lambda at: torch.zeros(shape, dtype=dtype, device=at))

    s_in = d ** -0.5
    layers: Params = {}
    if cfg.has_attention:
        layers.update({
            "wq": stacked("wq", (d, cfg.n_heads, cfg.d_head), s_in),
            "wk": stacked("wk", (d, cfg.n_kv_heads, cfg.d_head), s_in),
            "wv": stacked("wv", (d, cfg.n_kv_heads, cfg.d_head), s_in),
            "wo": stacked("wo", (cfg.n_heads, cfg.d_head, d), cfg.attn_dim ** -0.5),
        })
        if cfg.qkv_bias:
            layers["bq"] = zeros(("layers", "bq"), (L, cfg.n_heads, cfg.d_head))
            layers["bk"] = zeros(("layers", "bk"), (L, cfg.n_kv_heads, cfg.d_head))
            layers["bv"] = zeros(("layers", "bv"), (L, cfg.n_kv_heads, cfg.d_head))
        if cfg.qk_norm:
            layers["q_norm"] = zeros(("layers", "q_norm"), (L, cfg.d_head))
            layers["k_norm"] = zeros(("layers", "k_norm"), (L, cfg.d_head))
    layers["attn_norm"] = zeros(("layers", "attn_norm"), (L, d))  # pre-mixer norm of every family
    if cfg.family in STATE_FAMILIES:
        layers["mamba"] = init_mamba_params(cfg, make, dtype, L)
    if cfg.family == "moe":
        layers["moe"] = init_moe_params(cfg, make, dtype, L)
        layers["ffn_norm"] = zeros(("layers", "ffn_norm"), (L, d))
    elif cfg.d_ff and cfg.family != "ssm":
        f = cfg.d_ff
        layers["w_gate"] = stacked("w_gate", (d, f), s_in)
        layers["w_up"] = stacked("w_up", (d, f), s_in)
        layers["w_down"] = stacked("w_down", (f, d), f ** -0.5)
        layers["ffn_norm"] = zeros(("layers", "ffn_norm"), (L, d))
    params: Params = {
        "embed": make.normal(("embed",), (cfg.vocab_size, d), d ** -0.5, dtype),
        "layers": layers,
        "final_norm": zeros(("final_norm",), (d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = make.normal(("unembed",), (d, cfg.vocab_size), d ** -0.5, dtype)
    return params


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked per-layer tensors (views), for
    callers that touch one layer at a time without grad (prefill, decode,
    the serving backends). A loop over every layer under autograd uses
    ``unstacked_layers``."""
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
            for k, v in params["layers"].items()}


def unstacked_layers(params: Params, n_layers: int) -> List[Params]:
    """Every layer's views of the stacked tensors, made with one ``unbind``
    per tensor: under autograd the layers' gradients are then stacked once,
    where indexing each layer would add a stacked-size gradient per layer."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: p[l] for k, p in parts.items()} for l in range(n_layers)]
        return tree.unbind(0)

    return split(params["layers"])


# remat="dots": the matrix products without batch dims (the projections, the
# FFN, the unembedding: aten.mm / addmm) are saved and the rest is
# recomputed, as jax.checkpoint_policies.dots_with_no_batch_dims_saveable
# saves dot_generals without batch dims
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def rematerialized(layer, remat: Union[bool, str], **kw):
    """``layer`` under ``remat`` (``forward``'s): checkpointed
    (``torch.utils.checkpoint``, non-reentrant, with ``kw``) saving nothing
    inside it (True) or its products without batch dims ("dots"), or as it
    is."""
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, layer, use_reentrant=False, context_fn=context_fn,
                                 **kw)
    if remat:
        return functools.partial(checkpoint, layer, use_reentrant=False, **kw)
    return layer


def _ffn(h: torch.Tensor, lp: Params, cfg: ModelConfig, *,
         dropless: bool = False, route=None) -> torch.Tensor:
    """The FFN sublayer with its residual. An MoE layer drops assignments
    past its experts' capacity unless ``dropless`` (decode, part B);
    ``route`` (``moe.MoeRoute``) makes h a part of a larger microbatch."""
    if cfg.family == "moe":
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        return act_sharding.constrain(h + moe_ffn(
            x, lp["moe"], n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity_factor, dropless=dropless, route=route),
            "hidden")
    if "w_gate" in lp:
        x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        return act_sharding.constrain(h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]),
                                      "hidden")
    return h


def _inputs_to_h(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    if "embeds" in batch:  # the audio / vlm stub frontends supply embeddings
        return batch["embeds"].to(cfg.activation_dtype())
    return params["embed"][batch["tokens"]]


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["unembed"] if not cfg.tie_embeddings else params["embed"].T
    return matmul(h, w).to(torch.float32)


def _out_proj(attn: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    b, s = attn.shape[:2]
    return matmul(attn.reshape(b, s, -1), lp["wo"].reshape(-1, cfg.d_model))


def attention_sublayer(x, lp, window, positions, cfg, block_q, kv_heads=None):
    """The prompt's attention over lp's q heads (all of them, or a tensor
    shard's, ``launch/tp_compute.py``): (out (b, s, d_model), k, v), out a
    partial sum where the heads are a shard's. ``kv_heads``: the index into
    k's and v's heads of each q head's kv head, where the shard's q heads
    are not whole groups of its kv heads (the attention then reads those
    heads, one a q head)."""
    q, k, v = qkv_project(x, lp, cfg, positions)
    kq, vq = (k, v) if kv_heads is None else (k[:, :, kv_heads], v[:, :, kv_heads])
    out = _out_proj(attention_prefill(q, kq, vq, window=window, block_q=block_q), lp, cfg)
    return out, k, v


def mixer_out(cfg: ModelConfig, a_out, s_out):
    """The token mixer's output from the attention's (``a_out``) and the
    mamba heads' (``s_out``) as the family has them: the hybrid family's
    mean of the two."""
    if cfg.family == "ssm":
        return s_out
    return a_out if s_out is None else 0.5 * (a_out + s_out)


def _layer_prefill(h, lp, window, positions, cfg, block_q, route=None):
    """One layer over the whole prompt: (h, (k, v) or None, mamba state or
    None). ``route``: the MoE FFN's part of a split microbatch."""
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    if cfg.family == "ssm":
        out, st = mamba_block(x, lp["mamba"], cfg, return_state=True)
        return h + out, None, st
    out, k, v = attention_sublayer(x, lp, window, positions, cfg, block_q)
    s_out = st = None
    if cfg.family == "hybrid":
        s_out, st = mamba_block(x, lp["mamba"], cfg, return_state=True)
    h = _ffn(h + mixer_out(cfg, out, s_out), lp, cfg, route=route)
    return h, (k, v), st


def forward(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    block_q: int = 512,
    logits_positions: str = "all",  # "all" (training) | "last" (prefill)
    return_kv: bool = False,
    remat: Union[bool, str] = False,
    moe_routes=None,
):
    """Full causal forward over ``batch["tokens"]`` (b, s), or
    ``batch["embeds"]`` (b, s, d_model) for the frontend families.

    ``remat`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant): True saves nothing inside it and recomputes the layer in
    the backward pass; "dots" saves its matrix products without batch dims
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).

    ``moe_routes`` (a ``moe.MoeRoute`` a layer) makes the batch a part of a
    larger microbatch whose MoE dispatch it keeps.

    Returns logits (and per-layer KV, each (L, b, s, n_kv, d_head), if asked;
    None for the attention-free family)."""
    h = _inputs_to_h(params, batch, cfg)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    windows = cfg.window_sizes()

    def layer(h, lp, window, route):
        return _layer_prefill(h, lp, window, positions, cfg, block_q, route)

    layer = rematerialized(layer, remat)
    ks, vs = [], []
    for l, lp in enumerate(unstacked_layers(params, cfg.n_layers)):
        h, kv, _ = layer(h, lp, int(windows[l]), None if moe_routes is None else moe_routes[l])
        if return_kv and kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    logits = _logits(params, h[:, -1:] if logits_positions == "last" else h, cfg)
    if return_kv:
        return logits, ((torch.stack(ks), torch.stack(vs)) if ks else None)
    return logits


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            block_q: int = 512, remat: Union[bool, str] = False,
            moe_routes=None) -> torch.Tensor:
    """Next-token cross entropy. ``batch`` needs tokens or embeds, and
    labels; an optional ``loss_mask`` weights the positions. ``moe_routes``
    as ``forward`` takes them."""
    logits = forward(params, batch, cfg, block_q=block_q, remat=remat, moe_routes=moe_routes)
    return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """``loss_fn``'s loss of float32 ``logits`` (..., vocab): the mean of
    each position's negative log-likelihood of its label, or its sum
    weighted by ``mask`` over max(mask's sum, 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


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
    h = _inputs_to_h(params, batch, cfg)
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
    token: torch.Tensor,  # (b, 1) integer, or (b, 1, d_model) embeds for the stub frontends
    cfg: ModelConfig,
    state: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step: append the token's KV, attend over the cache,
    advance the mamba state (through the selective_scan kernel at s = 1).

    An MoE layer runs dropless. The state's buffers are updated in place and
    the same dict is returned."""
    h = token.to(cfg.activation_dtype()) if token.dim() == 3 else params["embed"][token]
    b = h.shape[0]
    length = int(state["length"])  # valid positions already in the cache
    positions = torch.full((b, 1), length, dtype=torch.long, device=h.device)
    windows = cfg.window_sizes()
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        xn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        out = s_out = None
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
        h = _ffn(h + mixer_out(cfg, out, s_out), lp, cfg, dropless=True)
    state["length"] = length + 1
    return _logits(params, h, cfg), state
