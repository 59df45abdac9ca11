"""Plain versions of the flash_attention kernel (causal GQA attention), of
the logsumexp its wgmma form saves for the backward, and of its backward."""
from __future__ import annotations

import math

import torch


def _visible(s_q: int, s_k: int, causal: bool, window: int, q_offset: int, lo: int, device):
    """(rows of query block ``lo``, s_k) mask of the keys each query sees."""
    kpos = torch.arange(s_k, device=device)
    qpos = q_offset + torch.arange(lo, lo + s_q, device=device)
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (b, n_q, s_q, d)
    k: torch.Tensor,  # (b, n_kv, s_k, d)
    v: torch.Tensor,  # (b, n_kv, s_k, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    block_q: int = 512,
) -> torch.Tensor:
    """Attention of query positions ``q_offset + i`` over key positions ``t``:
    key t is visible if ``t <= q_offset + i`` (when ``causal``) and
    ``q_offset + i - t < window`` (when ``window > 0``).

    Scores, softmax and the product with V run in float32 and the output is
    rounded once to q's dtype, as the kernel does; a row with no visible key
    gives zeros. Query rows go ``block_q`` at a time, so peak memory is
    block_q x s_k scores per head. Returns (b, n_q, s_q, d)."""
    b, n_q, s_q, d = q.shape
    n_kv, s_k = k.shape[1], k.shape[2]
    group = n_q // n_kv
    scale = d ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for lo in range(0, s_q, block_q):
        qb = q[:, :, lo: lo + block_q].to(torch.float32)
        sq = qb.shape[2]
        qg = qb.reshape(b, n_kv, group, sq, d)
        sc = torch.einsum("bngsd,bntd->bngst", qg, kf) * scale
        mask = _visible(sq, s_k, causal, window, q_offset, lo, q.device)
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bngst,bntd->bngsd", p, vf) / l.clamp_min(1e-30)
        out[:, :, lo: lo + sq] = o.reshape(b, n_q, sq, d).to(q.dtype)
    return out


def flash_attention_lse_ref(
    q: torch.Tensor,  # (b, n_q, s_q, d)
    k: torch.Tensor,  # (b, n_kv, s_k, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    block_q: int = 512,
) -> torch.Tensor:
    """Each query row's logsumexp over its visible keys, in the kernel's
    units: log2 of the sum of exp2(log2(e) d ** -0.5 q.k), i.e. the natural
    logsumexp of the scaled scores times log2(e), so that the backward's
    P = exp2(log2(e) d ** -0.5 q.k - lse). 0 for a row that sees no key.
    Float32 throughout; returns (b, n_q, s_q) float32."""
    b, n_q, s_q, d = q.shape
    n_kv, s_k = k.shape[1], k.shape[2]
    group = n_q // n_kv
    kf = k.to(torch.float32)
    lse = torch.empty((b, n_q, s_q), dtype=torch.float32, device=q.device)
    for lo in range(0, s_q, block_q):
        qb = q[:, :, lo: lo + block_q].to(torch.float32)
        sq = qb.shape[2]
        sc = torch.einsum("bngsd,bntd->bngst", qb.reshape(b, n_kv, group, sq, d), kf) * d ** -0.5
        mask = _visible(sq, s_k, causal, window, q_offset, lo, q.device)
        sc = sc.masked_fill(~mask, float("-inf"))
        row = torch.logsumexp(sc, dim=-1) * (1.0 / math.log(2.0))
        row = torch.where(mask.any(dim=-1), row, torch.zeros_like(row))
        lse[:, :, lo: lo + sq] = row.reshape(b, n_q, sq)
    return lse


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (b, n_q, s_q, d)
    k: torch.Tensor,  # (b, n_kv, s_k, d)
    v: torch.Tensor,  # (b, n_kv, s_k, d)
    out: torch.Tensor,  # (b, n_q, s_q, d): the forward's output
    dout: torch.Tensor,  # (b, n_q, s_q, d)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    block_q: int = 512,
):
    """(dq, dk, dv) of ``flash_attention_ref`` in float32, each rounded once
    to its input's dtype, by the kernel's formulas: P = softmax(scale Q K^T)
    over the visible keys, D = rowsum(dO o O), dP = dO V^T,
    dS = P o (dP - D), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, the
    query heads of a group summed into their kv head. A row that sees no key
    has P = 0. Query rows go ``block_q`` at a time."""
    b, n_q, s_q, d = q.shape
    n_kv, s_k = k.shape[1], k.shape[2]
    group = n_q // n_kv
    scale = d ** -0.5
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    dq = torch.empty((b, n_q, s_q, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, n_kv, s_k, d), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for lo in range(0, s_q, block_q):
        sq = min(block_q, s_q - lo)

        def rows(t):
            return t[:, :, lo: lo + sq].to(f32).reshape(b, n_kv, group, sq, d)

        qb, ob, dob = rows(q), rows(out), rows(dout)
        sc = torch.einsum("bngsd,bntd->bngst", qb, kf) * scale
        mask = _visible(sq, s_k, causal, window, q_offset, lo, q.device)
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(sc - m)
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        dsum = (dob * ob).sum(dim=-1, keepdim=True)
        dp = torch.einsum("bngsd,bntd->bngst", dob, vf)
        ds = p * (dp - dsum)
        dv += torch.einsum("bngst,bngsd->bntd", p, dob)
        dk += torch.einsum("bngst,bngsd->bntd", ds, qb) * scale
        dq[:, :, lo: lo + sq] = (torch.einsum("bngst,bntd->bngsd", ds, kf)
                                 * scale).reshape(b, n_q, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
