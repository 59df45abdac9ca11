"""Plain versions of the chunk_attention kernel: the engine's part-B attention.

``chunk_attention_ref`` is ``core/sparse_attention.py:reprefill_attention``
with the valid chunks given as a count (a prefix of the bucket), which is how
the engine pads them. ``chunk_attention_split_ref`` repeats the kernel's
arithmetic: every product as the sum of split-TF32 terms.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sparse_attention import NEG_INF, reprefill_attention


def chunk_attention_ref(q, k_sel, v_sel, n_valid: int, k_suf, v_suf
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (s, n_q, d) float32, chunk_mass (nb,) float32)."""
    valid = torch.arange(k_sel.shape[0], device=q.device) < n_valid
    return reprefill_attention(q, k_sel, v_sel, valid, k_suf, v_suf,
                               chunk_tokens=k_sel.shape[1])


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the pattern go."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32, with x - hi - lo below 2^-22 |x|; lo is 0 where x
    is exact in TF32 (every float16 and bfloat16 value)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(torch.float32) - hi)


def _split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum(a, b) as the kernel's tensor cores form it: a_lo b_hi + a_hi
    b_lo + a_hi b_hi, each term a float32 einsum of TF32 operands."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def chunk_attention_split_ref(q, k_sel, v_sel, n_valid: int, k_suf, v_suf
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chunk_attention_ref`` with QK^T and PV in split-TF32 terms (the
    softmax and A_j in float32, P unsplit for the mass). Returns (out (s,
    n_q, d) float32, chunk_mass (nb,) float32) for every input dtype."""
    s, n_q, d = q.shape
    nb, c, n_kv, _ = k_sel.shape
    group = n_q // n_kv
    k_all = torch.cat([k_sel.reshape(nb * c, n_kv, d).float(), k_suf.float()])
    v_all = torch.cat([v_sel.reshape(nb * c, n_kv, d).float(), v_suf.float()])
    qg = q.reshape(s, n_kv, group, d).float()
    logits = _split_einsum("sngd,tnd->ngst", qg, k_all) * d ** -0.5
    prefix_ok = (torch.arange(nb, device=q.device) < n_valid).repeat_interleave(c)
    pos = torch.arange(s, device=q.device)
    mask = torch.cat([prefix_ok[None, :].expand(s, nb * c), pos[:, None] >= pos[None, :]], 1)
    probs = torch.softmax(torch.where(mask[None, None], logits, NEG_INF), dim=-1)
    out = _split_einsum("ngst,tnd->sngd", probs, v_all).reshape(s, n_q, d)
    mass = probs[..., : nb * c].sum(dim=(0, 1, 2)).reshape(nb, c).sum(dim=-1)
    return out, mass
