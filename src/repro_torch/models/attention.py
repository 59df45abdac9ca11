"""Attention: GQA prefill, single-step decode over a KV cache, QKV projection.

On the card, prefill runs the flash_attention kernel, and under autograd
its backward kernel too (``FlashAttentionFn``); meta tensors (the dry run)
take the same calls, whose meta routes count the kernels' work without
launching. On the CPU it runs the JAX
package's block-wise form (``attention_prefill_blockwise``): one query block
at a time, so peak score memory is block_q x seq_k rather than seq^2, and
autograd differentiates it as it is. Decode is plain torch on both, as the
JAX package computes it outside any kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import FlashAttentionFn, flash_attention
from repro_torch.launch import act_sharding
from repro_torch.models.layers import apply_rope, matmul, rms_norm

NEG_INF = -1e30


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (b, sq, n_q, d) k: (b, sk, n_kv, d) -> scores (b, n_q, sq, sk) for GQA."""
    b, sq, n_q, d = q.shape
    n_kv = k.shape[2]
    group = n_q // n_kv
    qg = q.reshape(b, sq, n_kv, group, d)
    s = torch.einsum("bsngd,btnd->bngst", qg, k)  # (b, n_kv, group, sq, sk)
    return s.reshape(b, n_q, sq, k.shape[1])


def _grouped_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (b, n_q, sq, sk) v: (b, sk, n_kv, d) -> (b, sq, n_q, d)."""
    b, n_q, sq, sk = p.shape
    n_kv = v.shape[2]
    group = n_q // n_kv
    pg = p.reshape(b, n_kv, group, sq, sk)
    o = torch.einsum("bngst,btnd->bsngd", pg, v)
    return o.reshape(b, sq, n_q, v.shape[3])


def attention_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    block_q: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q: (b, s, n_q, d); k, v: (b, s, n_kv, d). `window` 0 means full causal.
    Returns (b, s, n_q, d).

    CUDA tensors go through the flash_attention kernel, read in place through
    their (b, s, n, d) strides: float32 scores and probabilities, output
    rounded once. When grad mode is on and an input requires grad, the call
    goes through ``FlashAttentionFn``, whose backward is the flash_attention
    backward kernel; without grad the forward kernel alone runs. Meta tensors
    take the same calls (the wrappers' meta routes). CPU tensors take
    ``attention_prefill_blockwise``.
    """
    if q.device.type in ("cuda", "meta"):
        if scale is not None:
            raise ValueError("the flash_attention kernel scales by d ** -0.5 only")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            out = FlashAttentionFn.apply(qt, kt, vt, True, int(window), 0)
        else:
            out = flash_attention(qt, kt, vt, causal=True, window=int(window))
        return out.transpose(1, 2)
    return attention_prefill_blockwise(q, k, v, window=window, block_q=block_q, scale=scale)


def attention_prefill_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    block_q: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The JAX package's block-wise causal attention in plain torch, on any
    device: scores in the input dtype, softmax in float32, probabilities
    rounded to v's dtype before the product with V. Shapes as
    ``attention_prefill``."""
    b, s, n_q, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    kpos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, block_q):
        qblk = q[:, lo: lo + block_q]
        qpos = torch.arange(lo, lo + qblk.shape[1], device=q.device)
        scores = _grouped_scores(qblk, k).to(torch.float32) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        scores = torch.where(mask[None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(_grouped_out(p, v))
    return torch.cat(outs, dim=1)


def attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    length: int,
    window: int = 0,
    scale: Optional[float] = None,
    pos0: int = 0,
    return_lse: bool = False,
):
    """Single-step decode. q: (b, 1, n_q, d); caches: (b, S, n_kv, d).

    `length` = number of valid cache positions (the new token's KV must already
    be written at position length-1). ``pos0``: the caches hold positions
    ``pos0 .. pos0 + S - 1`` (a block of a cache split by sequence).

    ``return_lse=True`` also returns each row's logsumexp of its masked,
    scaled float32 scores, (b, n_q) float32, for the flash-decode combine of
    blocks (``launch/sharded_sparse.combine_partials``); a block with no
    valid position gives a value near NEG_INF there, which the combine
    weighs 0. The output is the same bits either way.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    pos = pos0 + torch.arange(k_cache.shape[1], device=q.device)
    mask = pos < length
    if window > 0:
        mask = mask & ((length - 1) - pos < window)
    scores = _grouped_scores(q, k_cache).to(torch.float32) * scale  # (b, n_q, 1, S)
    scores = torch.where(mask[None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = _grouped_out(p, v_cache)
    if return_lse:
        return out, torch.logsumexp(scores[:, :, 0], dim=-1)
    return out


def qkv_project(
    x: torch.Tensor,
    p: dict,
    cfg,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project hidden states (b, s, d_model) to rotary-embedded Q, K and V."""
    b, s, d_model = x.shape

    def proj(w):  # "bsd,dhk->bshk"
        return matmul(x, w.reshape(d_model, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q = act_sharding.constrain(proj(p["wq"]), "heads")
    k = act_sharding.constrain(proj(p["wk"]), "heads")
    v = act_sharding.constrain(proj(p["wv"]), "heads")
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
