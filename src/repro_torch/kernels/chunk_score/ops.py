"""Wrapper of the chunk_score kernel (csrc/chunk_score.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take. One call is two device
kernels: the split pass, a CTA per (64-row tile, kv head, split of the key
tiles) on the tensor cores, then the merge, whose last CTA sums A_j. The
kernel's source chooses the splits and says how much scratch they need; the
scratch and counter are kept from call to call (``build.workspace``), so a
call allocates only its output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.chunk_score.ref import chunk_score_ref

launches = 0  # kernel launches since the count was last set to 0


def chunk_score(q: torch.Tensor, k: torch.Tensor, chunk_tokens: int) -> torch.Tensor:
    """ContiguousChunk scores (Eq. 1): (ceil(n / c),) float32.

    q: (s, n_q, d) float32/bfloat16/float16 suffix queries;
    k: (n, n_kv, d) float16 prefix (probe) keys; any n, any d <= 128 (a
    partial-key probe passes the first d dims of q and k), any c <= 64."""
    global launches
    if B.on_cpu(q, k):
        return chunk_score_ref(q, k, chunk_tokens)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    B.require(k, "k", 3, (torch.float16,))
    s, n_q, d = q.shape
    n, n_kv, dk = k.shape
    c = int(chunk_tokens)
    if dk != d or d > B.MAX_HEAD_DIM or n_q % n_kv or n < 1 or s < 1:
        raise ValueError(f"chunk_score: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if not 1 <= c <= 64:
        raise ValueError(f"chunk_score: chunk_tokens {c} not in [1, 64]")
    lib = B.library()
    n_work = lib.ckv_chunk_score_work_floats(s, n_q, n_kv, n, d, c)
    if n_work < 0:
        raise RuntimeError("chunk_score: the kernel could not lay out its work")
    work, counters = B.workspace("chunk_score", q, n_work, 1)
    out = torch.empty(-(-n // c), dtype=torch.float32, device=q.device)
    rc = lib.ckv_chunk_score(
        q.data_ptr(), k.data_ptr(), out.data_ptr(), work.data_ptr(), work.numel(),
        counters.data_ptr(), s, n_q, n_kv, n, d, c, B.dtype_code(q), B.stream_handle(q))
    B.check(rc, "chunk_score")
    launches += 1
    return out
