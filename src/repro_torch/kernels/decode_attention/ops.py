"""Wrapper of the decode_attention kernel (csrc/decode_attention.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel, or raises for what the kernel does not take. One call is one device
kernel: a CTA per (request, kv head, split of whole pages), the last CTA of
each (request, kv head) merging the splits. The kernel's source chooses the
splits and says how much scratch they need; the scratch and counters are
kept from call to call (``build.workspace``), so a call allocates only its
two outputs.

Two forms: :func:`decode_attention` over one stacked ``(b, n_pages, ...)``
pool, and :func:`decode_attention_pools` over b per-request pool buffers,
which the kernel reads through their base pointers, with no pad-and-stack
copy. Both count in ``launches``, and by form in ``launches_by_variant``:
``stacked``, ``pools``, and ``stacked_lse`` for a stacked call that also
writes each row's logsumexp (``return_lse=True``, the tensor-parallel
decode's per-shard partial).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.decode_attention.ref import (decode_attention_pools_ref,
                                                      decode_attention_ref)

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = {"stacked": 0, "pools": 0, "stacked_lse": 0}


def _check_geometry(q: torch.Tensor, n_kv: int, page: int, d: int, n_active: int, shapes):
    _, n_q, dq = q.shape
    if (dq != d or d > B.MAX_HEAD_DIM or d % 8 or n_q % n_kv or n_q // n_kv > 32
            or not 1 <= page <= 64 or n_active < 1):
        raise ValueError(f"decode_attention: unsupported shapes q {tuple(q.shape)} {shapes}")


def _launch(lib_fn, q, n_kv, page, n_active, d, pools_args, table, lengths, lse_args,
            *extra_ints):
    """Scratch, outputs and one launch of either form; ``lse_args`` is the
    stacked form's logsumexp pointer (0 for none), empty for the pools form."""
    lib = B.library()
    b, n_q, _ = q.shape
    work, counters = B.workspace(
        "decode_attention", q, lib.ckv_decode_attention_work_floats(b, n_q, n_active, page, d),
        b * n_kv)
    out = torch.empty_like(q)
    mass = torch.empty(b, n_q, n_active, dtype=torch.float32, device=q.device)
    return out, mass, lib_fn(
        q.data_ptr(), *pools_args, table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        mass.data_ptr(), *lse_args, work.data_ptr(), work.numel(), counters.data_ptr(), b, n_q,
        n_kv, *extra_ints, B.dtype_code(q), B.stream_handle(q))


@B.on_own_device
def decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor, return_lse: bool = False):
    """Paged decode attention.

    q: (b, n_q, d); k_pool/v_pool: (b, n_pages, page, n_kv, d), q's dtype;
    page_table: (b, n_active) int32, < 0 marks a pad slot; lengths: (b,)
    int32 valid tokens counted over the table's slots. Returns (out (b, n_q,
    d) in q's dtype, mass (b, n_q, n_active) float32): ``mass[b, h, j]`` is
    the share of head h's probability on slot j, exactly 0 on pad slots.
    With ``return_lse`` it also returns lse (b, n_q) float32, each row's
    natural-log logsumexp of its scaled, masked logits; the kernel gives a
    row with nothing to attend out 0, mass 0 and lse -inf, the plain version
    a finite lse near -1e30. out and mass are the same bits either way."""
    global launches
    if B.on_cpu(q, k_pool, v_pool, page_table, lengths):
        return decode_attention_ref(q, k_pool, v_pool, page_table, lengths, return_lse)
    B.refuse_grad("decode_attention", q, k_pool, v_pool)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        B.require(t, name, 5, (q.dtype,))
    B.require(page_table, "page_table", 2, (torch.int32,))
    B.require(lengths, "lengths", 1, (torch.int32,))
    b = q.shape[0]
    _, n_pages, page, n_kv, d = k_pool.shape
    n_active = page_table.shape[1]
    if (k_pool.shape[0] != b or v_pool.shape != k_pool.shape
            or page_table.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(f"decode_attention: batch of q {tuple(q.shape)} pool "
                         f"{tuple(k_pool.shape)} table {tuple(page_table.shape)}")
    _check_geometry(q, n_kv, page, d, n_active,
                    f"pool {tuple(k_pool.shape)} table {tuple(page_table.shape)}")
    lib = B.library()
    lse = torch.empty(b, q.shape[1], dtype=torch.float32, device=q.device) if return_lse else None
    out, mass, rc = _launch(lib.ckv_decode_attention, q, n_kv, page, n_active, d,
                            (k_pool.data_ptr(), v_pool.data_ptr()), page_table, lengths,
                            (0 if lse is None else lse.data_ptr(),), n_pages, page, n_active, d)
    B.check(rc, "decode_attention")
    launches += 1
    launches_by_variant["stacked_lse" if return_lse else "stacked"] += 1
    return (out, mass, lse) if return_lse else (out, mass)


def pool_pointers(ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]) -> np.ndarray:
    """(3, b) int64 as the pools form reads it: each pool's K base pointer,
    V base pointer and page count. Valid only while the buffers stay where
    they are: a swap or a new allocation moves them."""
    return np.array([[k.data_ptr() for k in ks], [v.data_ptr() for v in vs],
                     [k.shape[0] for k in ks]], dtype=np.int64)


@dataclasses.dataclass
class PoolPointers:
    """A :func:`pool_pointers` block (``host``) and its copy on the pools'
    device (``device``, (3, b) int64), so a caller can upload the blocks of
    many calls at once. The wrapper holds ``host`` against the buffers it is
    given and refuses a stale block."""

    host: np.ndarray
    device: torch.Tensor


@B.on_own_device
def decode_attention_pools(q: torch.Tensor, ks: Sequence[torch.Tensor],
                           vs: Sequence[torch.Tensor], page_table: torch.Tensor,
                           lengths: torch.Tensor, pointers: Optional[PoolPointers] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged decode attention over b per-request pool buffers.

    ks[i]/vs[i]: request i's (n_pages_i, page, n_kv, d) buffers in q's dtype,
    one page geometry for all, page counts free; page_table, lengths and the
    result as :func:`decode_attention`. The result equals
    :func:`decode_attention` on the zero-padded stack of the buffers, bit for
    bit on the card. ``pointers`` (optional) is the buffers' pointer block
    already on the card; without it the call uploads one."""
    global launches
    b = q.shape[0]
    if len(ks) != b or len(vs) != b:
        raise ValueError(f"decode_attention_pools: {len(ks)} K and {len(vs)} V pools "
                         f"for a batch of {b}")
    if q.device.type == "cuda":
        for i, t in enumerate(list(ks) + list(vs)):
            if t.device != q.device:
                raise ValueError(
                    f"decode_attention_pools: pool buffer {i % b} lies on {t.device}, not on "
                    f"{q.device} (a pool swapped out to the host must be swapped in first)")
    if B.on_cpu(q, *ks, *vs, page_table, lengths):
        return decode_attention_pools_ref(q, ks, vs, page_table, lengths)
    B.refuse_grad("decode_attention_pools", q, *ks, *vs)
    B.require(q, "q", 3, B.FLOAT_TYPES)
    for i, (k, v) in enumerate(zip(ks, vs)):
        B.require(k, f"ks[{i}]", 4, (q.dtype,))
        B.require(v, f"vs[{i}]", 4, (q.dtype,))
        if k.shape[1:] != ks[0].shape[1:] or v.shape != k.shape:
            raise ValueError(f"decode_attention_pools: pool {i} of shape {tuple(k.shape)} / "
                             f"{tuple(v.shape)}, pool 0 of {tuple(ks[0].shape)}: one page "
                             f"geometry for all")
    B.require(page_table, "page_table", 2, (torch.int32,))
    B.require(lengths, "lengths", 1, (torch.int32,))
    _, page, n_kv, d = ks[0].shape
    n_active = page_table.shape[1]
    if page_table.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(f"decode_attention_pools: table {tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)} for a batch of {b}")
    _check_geometry(q, n_kv, page, d, n_active,
                    f"pools of ({page}, {n_kv}, {d}) table {tuple(page_table.shape)}")
    host = pool_pointers(ks, vs)
    if pointers is None:
        pointers = PoolPointers(host, torch.from_numpy(host).to(q.device))
    elif not np.array_equal(pointers.host, host):
        raise ValueError("decode_attention_pools: the pointer block does not name these "
                         "buffers (they moved since it was made)")
    B.require(pointers.device, "pointers", 2, (torch.int64,))
    if pointers.device.shape != (3, b) or pointers.device.device != q.device:
        raise ValueError(f"decode_attention_pools: pointer block {tuple(pointers.device.shape)} "
                         f"on {pointers.device.device}")
    lib = B.library()
    out, mass, rc = _launch(lib.ckv_decode_attention_pools, q, n_kv, page, n_active, d,
                            (pointers.device.data_ptr(),), page_table, lengths, (),
                            page, n_active, d)
    B.check(rc, "decode_attention_pools")
    launches += 1
    launches_by_variant["pools"] += 1
    return out, mass
