"""Wrapper of the chunk_score kernel (csrc/chunk_score.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.chunk_score.ref import chunk_score_ref

launches = 0  # kernel launches since the count was last set to 0
KEYS_PER_SPLIT = 512  # prefix keys per CTA of the row-statistics pass


def chunk_score(q: torch.Tensor, k: torch.Tensor, chunk_tokens: int) -> torch.Tensor:
    """ContiguousChunk scores (Eq. 1): (ceil(n / c),) float32.

    q: (s, n_q, d) float32/bfloat16/float16 suffix queries;
    k: (n, n_kv, d) float16 prefix (probe) keys; any n, any c <= 64."""
    global launches
    if B.on_cpu(q, k):
        return chunk_score_ref(q, k, chunk_tokens)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    B.require(k, "k", 3, (torch.float16,))
    s, n_q, d = q.shape
    n, n_kv, dk = k.shape
    c = int(chunk_tokens)
    if dk != d or d > B.MAX_HEAD_DIM or d % 8 or n_q % n_kv or n < 1 or s < 1:
        raise ValueError(f"chunk_score: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if not 1 <= c <= 64:
        raise ValueError(f"chunk_score: chunk_tokens {c} not in [1, 64]")
    m = -(-n // c)
    n_split = -(-n // KEYS_PER_SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty(m, **f32)
    m_stat, l_stat = torch.empty(2, n_q * s, **f32)
    m_part, l_part = torch.empty(2, n_split * n_q * s, **f32)
    partial = torch.empty(n_kv * m, **f32)
    rc = B.library().ckv_chunk_score(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), m_stat.data_ptr(), l_stat.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), partial.data_ptr(),
        s, n_q, n_kv, n, d, c, KEYS_PER_SPLIT, B.dtype_code(q), B.stream_handle(q))
    B.check(rc, "chunk_score")
    launches += 1
    return out
