"""Plain versions of the decode_attention kernel (paged decode attention),
over one stacked pool buffer and over per-request pool buffers."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (b, n_q, d) single-position queries
    k_pool: torch.Tensor,  # (b, n_pages, page, n_kv, d)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (b, n_active) int32 logical->physical; < 0 = pad
    lengths: torch.Tensor,  # (b,) valid token count
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (b, n_q, d) in q's dtype, mass (b, n_q, n_active) float32).

    The softmax and the product with V run in float32 and the output is
    rounded once, as the kernel does. Pad slots (``page_table < 0``) are
    masked entirely: their tokens never receive attention and their per-page
    mass is exactly zero.
    """
    b, n_q, d = q.shape
    _, n_pages, page, n_kv, _ = k_pool.shape
    n_active = page_table.shape[1]
    group = n_q // n_kv
    scale = d ** -0.5

    page_valid = page_table >= 0  # (b, n_active)
    tbl = page_table.clamp(min=0).long()
    rows = torch.arange(b, device=q.device)[:, None]
    k = k_pool[rows, tbl].reshape(b, n_active * page, n_kv, d).to(torch.float32)
    v = v_pool[rows, tbl].reshape(b, n_active * page, n_kv, d).to(torch.float32)

    qg = q.reshape(b, n_kv, group, d).to(torch.float32)
    logits = torch.einsum("bngd,btnd->bngt", qg, k) * scale
    pos = torch.arange(n_active * page, device=q.device)
    mask = pos[None, :] < lengths[:, None].to(pos.dtype)  # (b, T)
    mask = mask & page_valid.repeat_interleave(page, dim=1)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngt,btnd->bngd", p, v).to(q.dtype)
    mass = p.reshape(b, n_kv, group, n_active, page).sum(-1)
    return out.reshape(b, n_q, d), mass.reshape(b, n_q, n_active)


def stack_pool_buffers(ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad b per-request ``(n_pages_i, page, n_kv, d)`` pool buffers to
    the common page count and stack them: ``(b, n_pages, page, n_kv, d)``."""
    n_pages = max(k.shape[0] for k in ks)

    def stack(xs):
        out = xs[0].new_zeros((len(xs), n_pages) + tuple(xs[0].shape[1:]))
        for i, x in enumerate(xs):
            out[i, : x.shape[0]] = x
        return out

    return stack(ks), stack(vs)


def decode_attention_pools_ref(q, ks, vs, page_table, lengths):
    """Paged decode attention over b per-request pool buffers: the stacked
    plain version on their zero-padded stack."""
    return decode_attention_ref(q, *stack_pool_buffers(ks, vs), page_table, lengths)
