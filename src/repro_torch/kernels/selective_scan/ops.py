"""Wrapper of the selective_scan kernels (csrc/selective_scan.cu).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches a
kernel, or raises for what the kernels do not take. The kernel is chosen by
the sequence length, never because another one failed:

* ``chunked`` for s >= CHUNKED_MIN_S (every prefill): the sequence is
  scanned in parallel, CHUNK positions at a time, with h carried from chunk
  to chunk (two launches: B, C and dt packed per chunk into a scratch
  buffer, then the scan); ``ref.selective_scan_chunked_ref`` is its
  decomposition in plain torch. A scan resumed from its carried state is
  bit-identical to the whole scan where the cut is a multiple of CHUNK;
* ``sequential`` for shorter s (the decode step, s = 1): one launch of the
  step kernel, one thread per channel with the channel's states in
  registers, walking the positions in order.

``launches`` counts every launch, ``launches_by_variant`` each kernel's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

VARIANTS = {"sequential": 0, "chunked": 1}  # the C launcher's variant codes
CHUNKED_MIN_S = 16
CHUNK, RUN = 256, 16  # positions per chunk and per thread (SC_CHUNK, SC_RUN in the .cu)

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _row_strides(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch, position) strides in elements of a (b, s, m) tensor whose
    last dim is contiguous (a slice of a wider projection is taken as is)."""
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"{name}: expected (b, s, m) with a contiguous last dim, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0), t.stride(1)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 recurrence with a scalar dt per position.

    x: (b, s, d_in); dt: (b, s); A: (d_in, n) float32; B/C: (b, s, n) of x's
    dtype (float32, bfloat16 or float16), slices of a wider tensor allowed;
    h0: optional (b, d_in, n) initial state. Returns (y (b, s, d_in)
    float32, h_final (b, d_in, n) float32)."""
    global launches
    tensors = [x, dt, A, Bm, Cm] + ([] if h0 is None else [h0])
    if B.on_cpu(*tensors):
        return selective_scan_ref(x, dt, A, Bm, Cm, h0)
    # ssm and hybrid training on the card waits for a backward kernel
    B.refuse_grad("selective_scan", *tensors)
    B.require(x, "x", 3, B.FLOAT_TYPES)
    B.require(A, "A", 2, (torch.float32,))
    for name, t in (("B", Bm), ("C", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected x's {x.dtype}")
    b, s, d_in = x.shape
    n = A.shape[1]
    if (A.shape[0] != d_in or n not in (2, 4, 8, 16, 32) or dt.shape != (b, s)
            or Bm.shape != (b, s, n) or Cm.shape != (b, s, n) or b < 1 or s < 1):
        raise ValueError(
            f"selective_scan: unsupported shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if h0 is not None:
        B.require(h0, "h0", 3, (torch.float32,))
        if h0.shape != (b, d_in, n):
            raise ValueError(f"h0: shape {tuple(h0.shape)}, expected {(b, d_in, n)}")
    variant = "chunked" if s >= CHUNKED_MIN_S else "sequential"
    dt32 = dt.to(torch.float32).contiguous()  # bfloat16 -> float32 is exact
    b_sb, b_ss = _row_strides(Bm, "B")
    c_sb, c_ss = _row_strides(Cm, "C")
    y = torch.empty((b, s, d_in), dtype=torch.float32, device=x.device)
    h = torch.empty((b, d_in, n), dtype=torch.float32, device=x.device)
    lib = B.library()
    scratch = None  # the chunked kernel's per-chunk images of B, C and dt
    if variant == "chunked":
        scratch = torch.empty(lib.ckv_selective_scan_scratch(b, s, n, B.dtype_code(x)),
                              dtype=torch.uint8, device=x.device)
    rc = lib.ckv_selective_scan(
        x.data_ptr(), dt32.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        0 if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        b, s, d_in, n, b_sb, b_ss, c_sb, c_ss, B.dtype_code(x), VARIANTS[variant],
        B.stream_handle(x))
    B.check(rc, f"selective_scan {variant}")
    launches += 1
    launches_by_variant[variant] += 1
    return y, h
