"""Plain version of the flash_attention kernel (causal GQA attention)."""
from __future__ import annotations

import torch


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
    kpos = torch.arange(s_k, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for lo in range(0, s_q, block_q):
        qb = q[:, :, lo: lo + block_q].to(torch.float32)
        sq = qb.shape[2]
        qg = qb.reshape(b, n_kv, group, sq, d)
        sc = torch.einsum("bngsd,bntd->bngst", qg, kf) * scale
        qpos = q_offset + torch.arange(lo, lo + sq, device=q.device)
        mask = torch.ones((sq, s_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bngst,bntd->bngsd", p, vf) / l.clamp_min(1e-30)
        out[:, :, lo: lo + sq] = o.reshape(b, n_q, sq, d).to(q.dtype)
    return out
