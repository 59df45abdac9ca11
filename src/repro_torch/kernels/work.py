"""What a hand-written kernel's call costs, and where a wrapper reports it.

:func:`kernel_work` gives one call's products, bytes and exponentials from
its shapes; ``chip_smoke.py`` prints its bounds from it, and the step
analyzer (``launch/roofline.py``'s ``StepAnalyzer``) adds it up.

A :class:`Recorder` is a dispatch mode that takes the wrappers' reports: a
wrapper asks :func:`active` for the innermost one and, where there is one,
calls its ``add_kernel(name, variant, **shapes)`` for each CUDA launch and
each would-be launch of a meta route. :func:`active` answers None without
looking at the dispatch mode stack while no recorder is entered, so a
wrapper outside a count pays one integer test a call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

SCAN_OPS, SCAN_BWD_OPS = 6, 19  # float32 operations per (t, channel, state)
FLASH_BWD_PRODUCTS = 5  # the backward's products a key-query pair: S, dP, dV, dK, dQ

_entered = 0  # recorders entered and not yet left, on any thread


class Recorder(TorchDispatchMode):
    """A dispatch mode the kernel wrappers report their calls to. Subclasses
    define ``add_kernel(name, variant, **shapes)``."""

    def __enter__(self):
        global _entered
        out = super().__enter__()
        _entered += 1
        return out

    def __exit__(self, *exc):
        global _entered
        _entered -= 1
        return super().__exit__(*exc)

    def add_kernel(self, name: str, variant: str, **shapes) -> None:
        raise NotImplementedError


def active() -> Optional[Recorder]:
    """The innermost entered :class:`Recorder`, or None. Read from the
    dispatch mode stack, which autograd hands to the thread that runs a
    CUDA backward (a context variable stays behind on the caller's
    thread)."""
    if not _entered:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Recorder):
            return mode
    return None


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """One kernel call's work: multiply-adds counted as two products, the
    bytes it must move (each input read once, each output written once) and
    its exponentials."""

    products: float
    bytes: float
    exponentials: float


def visible_pairs(s_q: int, s_k: int, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> int:
    """Key-query pairs of one head: query i at position q_offset + i sees the
    keys at or before it (``causal``), the last ``window`` of them if
    window > 0."""
    if not causal:
        return s_q * s_k
    cap = min(s_k, window) if window > 0 else s_k
    lo, hi = q_offset + 1, q_offset + s_q  # each query sees min(position + 1, cap) keys
    full = max(0, min(hi, cap) - lo + 1)
    first = lo
    pairs = full * (first + first + full - 1) // 2
    return pairs + (s_q - full) * cap


def kernel_work(name: str, **shapes) -> KernelWork:
    """The work of one call of hand-written kernel ``name`` at ``shapes``:

    - ``flash_attention`` (b, n_q, n_kv, s_q, s_k, d, itemsize, causal,
      window, q_offset, lse_rows): q, k, v read and the output written; two
      products (QK^T, PV) of 2d operations and one exponential a visible
      key-query pair and head; the logsumexp's ``lse_rows`` float32 rows a
      head where it writes one (``lse_buffer``'s padded rows, else 0);
    - ``flash_attention_bwd`` (the same shapes): q, k, v, the output and its
      gradient read, dq, dk, dv written; the function's five products a
      pair and head, and one exponential;
    - ``selective_scan`` (b, s, d_in, n, itemsize, dt_itemsize, h0,
      chunks): x, dt, A, B, C (and h0) read, y and h written, and the
      carries of ``chunks`` chunks where it stores them (``carries_buffer``'s
      second dim, else 0); ~6 float32 operations and one exponential a
      (t, channel, state);
    - ``selective_scan_bwd`` (b, s, d_in, n, itemsize, dt_itemsize, h0,
      dh_final): x, dt, A, B, C, dy (h0, dh_final) read, the six gradients
      written; 19 float32 operations and one exponential a (t, channel,
      state);
    - ``decode_attention`` (b, n_q, n_kv, d, n_active, tokens, itemsize,
      lse): q, the table and the lengths read, each valid token's K and V
      read once, the output, the per-slot mass (and the logsumexp) written;
      two products and one exponential a token and head."""
    s = shapes
    if name in ("flash_attention", "flash_attention_bwd"):
        b, n_q, n_kv, d = s["b"], s["n_q"], s["n_kv"], s["d"]
        pairs = b * visible_pairs(s["s_q"], s["s_k"], causal=s.get("causal", True),
                                  window=s.get("window", 0), q_offset=s.get("q_offset", 0))
        q_elems, k_elems = b * n_q * s["s_q"] * d, b * n_kv * s["s_k"] * d
        if name == "flash_attention":
            moved = s["itemsize"] * (2 * q_elems + 2 * k_elems) + 4 * b * n_q * s.get("lse_rows", 0)
            return KernelWork(4.0 * n_q * d * pairs, moved, n_q * pairs)
        return KernelWork(FLASH_BWD_PRODUCTS * 2.0 * pairs * d * n_q,
                          s["itemsize"] * (4 * q_elems + 4 * k_elems), n_q * pairs)
    if name in ("selective_scan", "selective_scan_bwd"):
        b, t, d_in, n = s["b"], s["s"], s["d_in"], s["n"]
        isz, dt_isz = s["itemsize"], s["dt_itemsize"]
        elems = b * t * d_in * n
        inputs = isz * b * t * d_in + dt_isz * b * t + 4 * d_in * n + 2 * isz * b * t * n
        state = 4 * b * d_in * n
        if name == "selective_scan":
            moved = inputs + 4 * b * t * d_in + state + 4 * b * s.get("chunks", 0) * d_in * n
            moved += state if s.get("h0") else 0
            return KernelWork(SCAN_OPS * elems * 1.0, moved, elems)
        moved = 2 * inputs + 4 * b * t * d_in + state  # the gradients mirror the inputs
        moved += state * (bool(s.get("h0")) + bool(s.get("dh_final")))
        return KernelWork(SCAN_BWD_OPS * elems, moved, elems)
    if name == "decode_attention":
        b, n_q, d, n_active, tokens = s["b"], s["n_q"], s["d"], s["n_active"], s["tokens"]
        moved = (s["itemsize"] * 2 * b * n_q * d + 4 * b * n_q * n_active + 4 * b * n_active
                 + 4 * b + 2 * tokens * s["n_kv"] * d * s["itemsize"])
        if s.get("lse"):
            moved += 4 * b * n_q
        return KernelWork(4.0 * n_q * d * tokens, moved, n_q * tokens)
    raise ValueError(f"kernel_work: no kernel {name!r}")
