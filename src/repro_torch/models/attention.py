"""Attention: GQA prefill (block-wise, memory-bounded) and the QKV projection.

Prefill runs one query block at a time so peak score memory is
block_q x seq_k rather than seq^2 (a 4096-token ingest at full width would
otherwise hold a (28, 4096, 4096) float32 score tensor).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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
    Scores are taken in the input dtype, then softmaxed in float32.
    Returns (b, s, n_q, d).
    """
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

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
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
