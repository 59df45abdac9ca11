"""Wrapper of the chunk_attention kernel (csrc/chunk_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take. One call is two device
kernels: the attention pass, a CTA per (64-row tile, member and kv head,
split of the key tiles), then the merge, a CTA per (16 rows, kv head,
member), whose last CTA of a member sums its A_j. The kernel's source
chooses the splits and says how much scratch they need; the scratch and the
members' counters are kept from call to call (``build.workspace``), so a
call allocates one buffer for its two outputs.

Two forms: :func:`chunk_attention` over one request's gathered chunks, and
:func:`chunk_attention_indexed` over b requests in one launch, each reading
its chunks out of one pool by index. Both count in ``launches``, and by
form in ``launches_by_variant``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.chunk_attention.ref import (chunk_attention_indexed_ref,
                                                     chunk_attention_ref)

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = {"gathered": 0, "indexed": 0}


def _check_geometry(name, s, n_q, d, c, n_kv, dk, shapes):
    # d: a multiple of 8 up to 128, or the kernel's wide instance at MAX_HEAD_DIM
    if (dk != d or (d > 128 and d != B.MAX_HEAD_DIM) or d % 8 or n_q % n_kv
            or not 1 <= c <= 64 or s < 1):
        raise ValueError(f"{name}: unsupported shapes {shapes}")


@B.on_own_device
def chunk_attention(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
                    n_valid: int, k_suf: torch.Tensor, v_suf: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-Prefill attention over [selected chunks ; causal suffix].

    q: (s, n_q, d) and k_suf/v_suf: (s, n_kv, d), all of one float dtype,
    d a multiple of 8 up to 128, or 256; k_sel/v_sel: (nb, c, n_kv, d)
    float16, of which the first ``n_valid``
    chunks are valid. Returns (out (s, n_q, d) float32, A_j (nb,) float32):
    A_j is the probability mass over [chunks ; suffix] landing on chunk j,
    summed over heads, queries and the chunk's tokens (0 for padding)."""
    global launches
    if B.on_cpu(q, k_sel, v_sel, k_suf, v_suf):
        return chunk_attention_ref(q, k_sel, v_sel, n_valid, k_suf, v_suf)
    B.refuse_grad("chunk_attention", q, k_sel, v_sel, k_suf, v_suf)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    for name, t in (("k_suf", k_suf), ("v_suf", v_suf)):
        B.require(t, name, 3, (q.dtype,))
    for name, t in (("k_sel", k_sel), ("v_sel", v_sel)):
        B.require(t, name, 4, (torch.float16,))
    s, n_q, d = q.shape
    nb, c, n_kv, dk = k_sel.shape
    n_valid = int(n_valid)
    shapes = (f"q {tuple(q.shape)} k_sel {tuple(k_sel.shape)} k_suf {tuple(k_suf.shape)} "
              f"n_valid {n_valid}")
    _check_geometry("chunk_attention", s, n_q, d, c, n_kv, dk, shapes)
    if (v_sel.shape != k_sel.shape or k_suf.shape != (s, n_kv, d)
            or v_suf.shape != k_suf.shape or not 0 <= n_valid <= nb):
        raise ValueError(f"chunk_attention: unsupported shapes {shapes}")
    lib = B.library()
    n_work = lib.ckv_chunk_attention_work_floats(s, n_q, n_kv, c, n_valid, d)
    if n_work < 0:
        raise RuntimeError("chunk_attention: the kernel could not lay out its work")
    work, counters = B.workspace("chunk_attention", q, n_work, 1)
    res = torch.empty(s * n_q * d + nb, dtype=torch.float32, device=q.device)
    out, mass = res[: s * n_q * d].view(s, n_q, d), res[s * n_q * d:]
    rc = lib.ckv_chunk_attention(
        q.data_ptr(), k_sel.data_ptr(), v_sel.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        out.data_ptr(), mass.data_ptr(), work.data_ptr(), work.numel(), counters.data_ptr(),
        s, n_q, n_kv, nb, c, n_valid, d, B.dtype_code(q), B.stream_handle(q))
    B.check(rc, "chunk_attention")
    launches += 1
    launches_by_variant["gathered"] += 1
    return out, mass


@B.on_own_device
def chunk_attention_indexed(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                            chunk_idx: torch.Tensor, n_valid: torch.Tensor,
                            k_suf: torch.Tensor, v_suf: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-Prefill attention of b members in one launch, each over the chunks
    it names in one pool.

    q: (b, s, n_q, d) and k_suf/v_suf: (b, s, n_kv, d), all of one float
    dtype; k_pool/v_pool: (m, c, n_kv, d) float16; chunk_idx: (b, n_sel)
    int32, indices into the pool, of which member i reads the first
    n_valid[i]; n_valid: (b,) int32 (clamped to [0, n_sel]). Returns (out
    (b, s, n_q, d) float32, A_j (b, n_sel) float32), member i's results
    equal to :func:`chunk_attention` on ``pool[chunk_idx[i]]`` with n_valid[i]
    valid chunks, bit for bit on the card. The caller keeps the indices in
    [0, m): they are read on the card, where no check can raise."""
    global launches
    if B.on_cpu(q, k_pool, v_pool, chunk_idx, n_valid, k_suf, v_suf):
        return chunk_attention_indexed_ref(q, k_pool, v_pool, chunk_idx, n_valid, k_suf, v_suf)
    B.refuse_grad("chunk_attention_indexed", q, k_pool, v_pool, k_suf, v_suf)
    B.require(q, "q", 4, B.FLOAT_TYPES)
    for name, t in (("k_suf", k_suf), ("v_suf", v_suf)):
        B.require(t, name, 4, (q.dtype,))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        B.require(t, name, 4, (torch.float16,))
    B.require(chunk_idx, "chunk_idx", 2, (torch.int32,))
    B.require(n_valid, "n_valid", 1, (torch.int32,))
    b, s, n_q, d = q.shape
    _, c, n_kv, dk = k_pool.shape
    n_sel = chunk_idx.shape[1]
    shapes = (f"q {tuple(q.shape)} k_pool {tuple(k_pool.shape)} k_suf {tuple(k_suf.shape)} "
              f"chunk_idx {tuple(chunk_idx.shape)} n_valid {tuple(n_valid.shape)}")
    _check_geometry("chunk_attention_indexed", s, n_q, d, c, n_kv, dk, shapes)
    if (v_pool.shape != k_pool.shape or k_suf.shape != (b, s, n_kv, d)
            or v_suf.shape != k_suf.shape or chunk_idx.shape[0] != b
            or n_valid.shape != (b,) or n_sel < 1 or b * n_kv > 65535):
        raise ValueError(f"chunk_attention_indexed: unsupported shapes {shapes}")
    lib = B.library()
    n_work = lib.ckv_chunk_attention_indexed_work_floats(b, s, n_q, n_kv, c, n_sel, d)
    if n_work < 0:
        raise RuntimeError("chunk_attention_indexed: the kernel could not lay out its work")
    work, counters = B.workspace("chunk_attention", q, n_work, b)
    n_out = b * s * n_q * d
    res = torch.empty(n_out + b * n_sel, dtype=torch.float32, device=q.device)
    out, mass = res[:n_out].view(b, s, n_q, d), res[n_out:].view(b, n_sel)
    rc = lib.ckv_chunk_attention_indexed(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_suf.data_ptr(), v_suf.data_ptr(),
        chunk_idx.data_ptr(), n_valid.data_ptr(), out.data_ptr(), mass.data_ptr(),
        work.data_ptr(), work.numel(), counters.data_ptr(), b, s, n_q, n_kv, n_sel, c, d,
        B.dtype_code(q), B.stream_handle(q))
    B.check(rc, "chunk_attention_indexed")
    launches += 1
    launches_by_variant["indexed"] += 1
    return out, mass
