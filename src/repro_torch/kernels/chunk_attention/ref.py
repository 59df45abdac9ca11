"""Plain version of the chunk_attention kernel: the engine's part-B attention.

``core/sparse_attention.py:reprefill_attention`` with the valid chunks given
as a count (a prefix of the bucket), which is how the engine pads them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sparse_attention import reprefill_attention


def chunk_attention_ref(q, k_sel, v_sel, n_valid: int, k_suf, v_suf
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (s, n_q, d) float32, chunk_mass (nb,) float32)."""
    valid = torch.arange(k_sel.shape[0], device=q.device) < n_valid
    return reprefill_attention(q, k_sel, v_sel, valid, k_suf, v_suf,
                               chunk_tokens=k_sel.shape[1])
