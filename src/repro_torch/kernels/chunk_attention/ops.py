"""Wrapper of the chunk_attention kernel (csrc/chunk_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take. One call is two device
kernels: the attention pass, a CTA per (64-row tile, kv head, split of the
key tiles), then the merge, a CTA per (16 rows, kv head), whose last CTA
sums A_j. The kernel's source chooses the splits and says how much scratch
they need; the scratch and counter are kept from call to call
(``build.workspace``), so a call allocates one buffer for its two outputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref

launches = 0  # kernel launches since the count was last set to 0


def chunk_attention(q: torch.Tensor, k_sel: torch.Tensor, v_sel: torch.Tensor,
                    n_valid: int, k_suf: torch.Tensor, v_suf: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-Prefill attention over [selected chunks ; causal suffix].

    q: (s, n_q, d) and k_suf/v_suf: (s, n_kv, d), all of one float dtype;
    k_sel/v_sel: (nb, c, n_kv, d) float16, of which the first ``n_valid``
    chunks are valid. Returns (out (s, n_q, d) float32, A_j (nb,) float32):
    A_j is the probability mass over [chunks ; suffix] landing on chunk j,
    summed over heads, queries and the chunk's tokens (0 for padding)."""
    global launches
    if B.on_cpu(q, k_sel, v_sel, k_suf, v_suf):
        return chunk_attention_ref(q, k_sel, v_sel, n_valid, k_suf, v_suf)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    for name, t in (("k_suf", k_suf), ("v_suf", v_suf)):
        B.require(t, name, 3, (q.dtype,))
    for name, t in (("k_sel", k_sel), ("v_sel", v_sel)):
        B.require(t, name, 4, (torch.float16,))
    s, n_q, d = q.shape
    nb, c, n_kv, dk = k_sel.shape
    n_valid = int(n_valid)
    if (dk != d or d > B.MAX_HEAD_DIM or d % 8 or n_q % n_kv
            or v_sel.shape != k_sel.shape or k_suf.shape != (s, n_kv, d)
            or v_suf.shape != k_suf.shape or not 0 <= n_valid <= nb
            or not 1 <= c <= 64 or s < 1):
        raise ValueError(
            f"chunk_attention: unsupported shapes q {tuple(q.shape)} "
            f"k_sel {tuple(k_sel.shape)} k_suf {tuple(k_suf.shape)} n_valid {n_valid}")
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
    return out, mass
