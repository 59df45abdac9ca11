"""Plain version of the chunk_score kernel: the engine's identify arithmetic.

Token attention mass over the prefix (``probe_token_scores``), then the
padded ``np.add.reduceat`` over each chunk's c tokens, exactly as the JAX
engine computes chunk scores (src/repro/core/engine.py:834-843).
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
