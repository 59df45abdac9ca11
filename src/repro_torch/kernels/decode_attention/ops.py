"""Wrapper of the decode_attention kernel (csrc/decode_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take. One call is one device
kernel: a CTA per (request, kv head, split of whole pages), the last CTA of
each (request, kv head) merging the splits. The kernel's source chooses the
splits and says how much scratch they need; the scratch and counters are
kept from call to call (``build.workspace``), so a call allocates only its
two outputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

launches = 0  # kernel launches since the count was last set to 0


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged decode attention.

    q: (b, n_q, d); k_pool/v_pool: (b, n_pages, page, n_kv, d), q's dtype;
    page_table: (b, n_active) int32, < 0 marks a pad slot; lengths: (b,)
    int32 valid tokens counted over the table's slots. Returns (out (b, n_q,
    d) in q's dtype, mass (b, n_q, n_active) float32): ``mass[b, h, j]`` is
    the share of head h's probability on slot j, exactly 0 on pad slots."""
    global launches
    if B.on_cpu(q, k_pool, v_pool, page_table, lengths):
        return decode_attention_ref(q, k_pool, v_pool, page_table, lengths)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        B.require(t, name, 5, (q.dtype,))
    B.require(page_table, "page_table", 2, (torch.int32,))
    B.require(lengths, "lengths", 1, (torch.int32,))
    b, n_q, d = q.shape
    _, n_pages, page, n_kv, dk = k_pool.shape
    n_active = page_table.shape[1]
    if (dk != d or d > B.MAX_HEAD_DIM or d % 8 or n_q % n_kv or n_q // n_kv > 32
            or k_pool.shape[0] != b or v_pool.shape != k_pool.shape
            or page_table.shape[0] != b or lengths.shape[0] != b
            or not 1 <= page <= 64 or n_active < 1):
        raise ValueError(
            f"decode_attention: unsupported shapes q {tuple(q.shape)} "
            f"pool {tuple(k_pool.shape)} table {tuple(page_table.shape)}")
    lib = B.library()
    work, counters = B.workspace(
        "decode_attention", q, lib.ckv_decode_attention_work_floats(b, n_q, n_active, page, d),
        b * n_kv)
    out = torch.empty_like(q)
    mass = torch.empty(b, n_q, n_active, dtype=torch.float32, device=q.device)
    rc = lib.ckv_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), mass.data_ptr(), work.data_ptr(), work.numel(),
        counters.data_ptr(), b, n_q, n_kv, n_pages, page, n_active, d,
        B.dtype_code(q), B.stream_handle(q))
    B.check(rc, "decode_attention")
    launches += 1
    return out, mass
