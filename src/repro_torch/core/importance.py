"""Importance scoring: token attention mass -> ContiguousChunk scores (Eq. 1).

The paper follows H2O/ChunkKV: token score a_i = column-sum of the softmaxed
attention matrix; chunk score A_j sums a_i over the chunk's tokens. Selection
keeps the top ceil(budget * m) chunks (chunk-level, ours/ChunkKV) or the top
ceil(budget * n) tokens (token-level, H2O — used by the baselines).
"""
from __future__ import annotations

import numpy as np
import torch


def token_attention_scores(q: torch.Tensor, k: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """a_i for prefix tokens given probe queries.

    q: (sq, n_q, d) suffix/probe queries; k: (sk, n_kv, d) prefix keys.
    Returns (sk,) fp32 — attention mass each prefix token receives, summed
    over heads and query positions (GQA: kv heads broadcast over groups).
    """
    sq, n_q, d = q.shape
    sk, n_kv, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    group = n_q // n_kv
    qg = q.reshape(sq, n_kv, group, d).to(torch.float32)
    logits = torch.einsum("sngd,tnd->ngst", qg, k.to(torch.float32)) * scale
    probs = torch.softmax(logits, dim=-1)  # over prefix tokens
    return probs.sum(dim=(0, 1, 2))  # (sk,)


def chunk_scores_from_token_scores(a: torch.Tensor, chunk_tokens: int) -> torch.Tensor:
    """A_j = sum of a_i within chunk j (Eq. 1). a: (n,) -> (m,); a partial
    last chunk is padded with zeros."""
    n = a.shape[0]
    m = -(-n // chunk_tokens)
    pad = m * chunk_tokens - n
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
    return a.reshape(m, chunk_tokens).sum(dim=-1)


def select_topk_chunks(scores: np.ndarray, budget_ratio: float) -> np.ndarray:
    """Top ceil(budget*m) chunk ids, ascending order (for I/O coalescing)."""
    m = scores.shape[0]
    k = max(1, int(np.ceil(budget_ratio * m)))
    k = min(k, m)
    idx = np.argpartition(-scores, k - 1)[:k]
    return np.sort(idx)


def select_topk_tokens(scores: np.ndarray, budget_ratio: float) -> np.ndarray:
    """H2O-style token-level selection (baselines)."""
    n = scores.shape[0]
    k = max(1, int(np.ceil(budget_ratio * n)))
    k = min(k, n)
    idx = np.argpartition(-scores, k - 1)[:k]
    return np.sort(idx)


def coverage_ratio(a: np.ndarray, b: np.ndarray) -> float:
    """|a ∩ b| / |a| — the paper's similarity metric (Fig. 7)."""
    if len(a) == 0:
        return 1.0
    return len(np.intersect1d(a, b)) / len(a)
