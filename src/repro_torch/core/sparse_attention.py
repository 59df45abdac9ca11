"""Chunk-gathered Re-Prefill attention, plain torch (batch=1 engine path).

The suffix attends to (a) the gathered selected prefix ContiguousChunks —
fully visible, no causal mask among prefix — and (b) itself, causally.
Returns the attention output plus the per-chunk attention mass A_j needed by
the attention-guided cache (Eq. 1). Selected-chunk counts are padded to a
bucket size; padding is masked.

These are the plain versions of the ``chunk_attention`` and ``chunk_score``
kernels' functions: the wrappers in ``repro_torch.kernels`` run them for
tensors on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def bucket_size(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def reprefill_attention(
    q: torch.Tensor,  # (s, n_q, d) suffix queries (rope'd at prefix offset)
    k_sel: torch.Tensor,  # (n_bucket, c, n_kv, d) gathered chunks (padded)
    v_sel: torch.Tensor,  # (n_bucket, c, n_kv, d)
    sel_valid: torch.Tensor,  # (n_bucket,) bool
    k_suf: torch.Tensor,  # (s, n_kv, d)
    v_suf: torch.Tensor,  # (s, n_kv, d)
    *,
    chunk_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (attn_out (s, n_q, d), chunk_mass (n_bucket,) float32).

    The chunks and the suffix are joined in their promoted dtype, as
    ``jnp.concatenate`` does: float16 chunks beside bfloat16 or float32 suffix
    KV give a float32 output."""
    s, n_q, d = q.shape
    nb, c, n_kv, _ = k_sel.shape
    group = n_q // n_kv
    scale = d ** -0.5

    dt = torch.promote_types(k_sel.dtype, k_suf.dtype)
    k_all = torch.cat([k_sel.reshape(nb * c, n_kv, d).to(dt), k_suf.to(dt)])
    v_all = torch.cat([v_sel.reshape(nb * c, n_kv, d).to(dt), v_suf.to(dt)])

    qg = q.reshape(s, n_kv, group, d).to(torch.float32)
    logits = torch.einsum("sngd,tnd->ngst", qg, k_all.to(torch.float32)) * scale

    # mask: prefix positions valid iff their chunk is valid; suffix causal
    prefix_ok = sel_valid.to(torch.bool).repeat_interleave(c)  # (nb*c,)
    pos = torch.arange(s, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    mask = torch.cat([prefix_ok[None, :].expand(s, nb * c), causal], dim=1)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)  # (n_kv, group, s, T)

    out = torch.einsum("ngst,tnd->sngd", probs.to(v_all.dtype), v_all)
    out = out.reshape(s, n_q, d)

    # A_j: total attention mass landing on each selected chunk
    mass_tok = probs[..., : nb * c].sum(dim=(0, 1, 2))  # (nb*c,)
    chunk_mass = mass_tok.reshape(nb, c).sum(dim=-1)
    return out, chunk_mass


def probe_token_scores(q: torch.Tensor, k_probe: torch.Tensor) -> torch.Tensor:
    """Token attention mass a_i over the prefix (float32, shape (n,)).

    q: (s, n_q, d) suffix queries; k_probe: (n, n_kv, d) prefix keys.
    Softmax is over prefix tokens only (identification happens before the
    suffix KV for this layer exists — faithful to Fig. 8's ordering).
    """
    s, n_q, d = q.shape
    n, n_kv, _ = k_probe.shape
    group = n_q // n_kv
    scale = d ** -0.5
    qg = q.reshape(s, n_kv, group, d).to(torch.float32)
    logits = torch.einsum("sngd,tnd->ngst", qg, k_probe.to(torch.float32)) * scale
    probs = torch.softmax(logits, dim=-1)
    return probs.sum(dim=(0, 1, 2))  # (n,)
