"""Plain versions of the chunk_score kernel: the engine's identify arithmetic.

``chunk_score_ref`` is the token attention mass over the prefix
(``probe_token_scores``), then the padded ``np.add.reduceat`` over each
chunk's c tokens, exactly as the JAX engine computes chunk scores
(src/repro/core/engine.py:834-843). ``chunk_score_split_ref`` repeats the
kernel's decomposition: float16 hi + lo products of power-of-two scaled
query rows, per-split statistics and masses, and the ordered merge.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse_attention import probe_token_scores


def chunk_score_ref(q: torch.Tensor, k: torch.Tensor, chunk_tokens: int) -> torch.Tensor:
    """q: (s, n_q, d) suffix queries; k: (n, n_kv, d) prefix keys.
    Returns the (ceil(n / c),) float32 chunk scores on q's device."""
    a = probe_token_scores(q, k).cpu().numpy()
    n, c = a.shape[0], chunk_tokens
    m = -(-n // c)
    cs = np.add.reduceat(np.pad(a, (0, m * c - n)), np.arange(0, m * c, c))
    return torch.from_numpy(np.asarray(cs, np.float32)).to(q.device)


def _f16_split_rows(x: torch.Tensor):
    """(hi, lo, back) of float32 rows x (..., d), as the kernel forms its A
    fragments: each row scaled by 2^(141 - E), E the biased exponent of its
    largest |x| clamped to [15, 254] (so that largest lies in [2^14, 2^15)),
    then hi = float16(x') and lo = float16(x' - hi), both returned as
    float32; back (..., 1) = 2^(E - 141) undoes the scaling of a product."""
    mx = x.abs().amax(-1, keepdim=True).contiguous()
    e = ((mx.view(torch.int32) >> 23) & 0xFF).clamp(15, 254)
    up, back = ((268 - e) << 23).view(torch.float32), ((e - 14) << 23).view(torch.float32)
    xs = x * up
    hi = xs.half().float()
    return hi, (xs - hi).half().float(), back


def chunk_score_split_ref(q: torch.Tensor, k: torch.Tensor, chunk_tokens: int,
                          split_chunks: int = 32) -> torch.Tensor:
    """``chunk_score_ref`` as the kernel computes it, in float32.

    The logits are (q_lo k + q_hi k) back d^-0.5 (``_f16_split_rows`` of q;
    16-bit queries keep hi alone, as the kernel does). The keys go in splits
    of ``split_chunks`` whole chunks;
    per split and query row: the max m_s, the denominator l_s and each
    chunk's mass exp(logit - m_s) summed over its tokens. Per row, in split
    order: m = max_s m_s and l = sum_s l_s exp(m_s - m). A_j sums, over kv
    heads in order and then their rows, mass_j exp(m_s(j) - m) / max(l,
    1e-30). The kernel takes its exponentials in log2 units (ex2 of logit *
    log2 e), which moves them by rounding only. Returns the (ceil(n / c),)
    float32 chunk scores."""
    s, n_q, d = q.shape
    n, n_kv, _ = k.shape
    c, group = chunk_tokens, n_q // n_kv
    # rows of kv head h: position-major, r = pos * group + head within the group
    qr = q.float().reshape(s, n_kv, group, d).transpose(0, 1).reshape(n_kv, s * group, d)
    kr = k.float().transpose(0, 1)  # (n_kv, n, d)
    hi, lo, back = _f16_split_rows(qr)
    if q.dtype != torch.float32:
        lo = torch.zeros_like(lo)
    logits = (torch.einsum("hrd,htd->hrt", lo, kr)
              + torch.einsum("hrd,htd->hrt", hi, kr)) * back * d ** -0.5
    span = split_chunks * c
    stats, masses = [], []
    for t0 in range(0, n, span):
        blk = logits[..., t0: t0 + span]
        m_s = blk.amax(-1)
        p = torch.exp(blk - m_s[..., None])
        stats.append((m_s, p.sum(-1)))
        n_ch = -(-blk.shape[-1] // c)
        p = torch.nn.functional.pad(p, (0, n_ch * c - blk.shape[-1]))
        masses.append(p.reshape(*p.shape[:2], n_ch, c).sum(-1))
    m_r = torch.stack([m_s for m_s, _ in stats]).amax(0)
    l_r = torch.zeros_like(m_r)
    for m_s, l_s in stats:
        l_r = l_r + l_s * torch.exp(m_s - m_r)
    inv_l = 1.0 / l_r.clamp_min(1e-30)
    scaled = torch.cat([mass * (torch.exp(m_s - m_r) * inv_l)[..., None]
                        for (m_s, _), mass in zip(stats, masses)], -1)
    per_head = scaled.sum(1)  # (n_kv, m): each kv head's rows
    out = torch.zeros_like(per_head[0])
    for h in range(n_kv):
        out = out + per_head[h]
    return out
