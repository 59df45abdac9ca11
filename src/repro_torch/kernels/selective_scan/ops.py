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

The backward (``selective_scan_bwd``: a pack kernel of its own, then a
kernel that walks the chunks from last to first, a warp per two channels and
a lane per run of BWD_RUN positions, two CTAs an SM, then a reduction of its
per-CTA partials in a fixed order, no atomics) takes what the forward takes.
It reads h at the start of every chunk: the chunked forward stores it when
given ``carries=carries_buffer(x, n)``, in a kernel instance of its own, so
serving's launches keep their code. A sequence of one chunk needs none (its
carry is h0). ``ref.selective_scan_bwd_chunked_ref(..., run=BWD_RUN)`` is
its decomposition in plain torch; ``bwd_ctas_per_sm`` its occupancy. ``SelectiveScanFn`` puts the forward and
the backward under autograd; ``bwd_launches`` counts the backward's calls.
The forward wrapper itself refuses inputs that require grad under grad
mode: its output has no graph.

Meta tensors (the dry run, ``launch/dryrun.py``) take the CUDA route's
checks and get its outputs' shapes and dtypes, uninitialised. Such a call
launches nothing, counts in none of the counters here and runs no plain
version: it reports the variant the card would run and the kernel's work
(``kernels/work.py``) to the active recorder, as a CUDA launch does. The
scratch the library sizes (the chunk images, the backward's per-CTA
partials) is not allocated there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import work as W
from repro_torch.kernels.selective_scan.ref import selective_scan_bwd_ref, selective_scan_ref

VARIANTS = {"sequential": 0, "chunked": 1}  # the C launcher's variant codes
CHUNKED_MIN_S = 16
# positions per chunk and per thread (SC_CHUNK, SC_RUN in the .cu); the
# backward's positions per lane (SB_RUN)
CHUNK, RUN, BWD_RUN = 256, 16, 8

launches = 0  # kernel launches since the count was last set to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
bwd_launches = 0  # backward calls since the count was last set to 0


def _row_strides(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch, position) strides in elements of a (b, s, m) tensor whose
    last dim is contiguous (a slice of a wider projection is taken as is)."""
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"{name}: expected (b, s, m) with a contiguous last dim, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0), t.stride(1)


def _check(x, dt, A, Bm, Cm, h0, name: str) -> Tuple[int, int, int, int]:
    """(b, s, d_in, n) of a CUDA call; raises for what the kernels do not take."""
    B.require(x, "x", 3, B.FLOAT_TYPES)
    B.require(A, "A", 2, (torch.float32,))
    for arg, t in (("B", Bm), ("C", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{arg}: dtype {t.dtype}, expected x's {x.dtype}")
    b, s, d_in = x.shape
    n = A.shape[1]
    if (A.shape[0] != d_in or n not in (2, 4, 8, 16, 32) or dt.shape != (b, s)
            or Bm.shape != (b, s, n) or Cm.shape != (b, s, n) or b < 1 or s < 1):
        raise ValueError(
            f"{name}: unsupported shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
            f"A {tuple(A.shape)} B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    if h0 is not None:
        B.require(h0, "h0", 3, (torch.float32,))
        if h0.shape != (b, d_in, n):
            raise ValueError(f"h0: shape {tuple(h0.shape)}, expected {(b, d_in, n)}")
    return b, s, d_in, n


def variant_for(s: int) -> str:
    """The forward kernel that runs a CUDA call of s positions."""
    return "chunked" if s >= CHUNKED_MIN_S else "sequential"


def carries_buffer(x: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised float32 (b, ceil(s / CHUNK), d_in, n) buffer for h at
    the start of every chunk, which ``selective_scan(..., carries=...)``
    fills for the backward."""
    b, s, d_in = x.shape
    return torch.empty((b, -(-s // CHUNK), d_in, n), dtype=torch.float32, device=x.device)


def _check_carries(carries: torch.Tensor, x: torch.Tensor, n: int) -> None:
    b, s, d_in = x.shape
    want = (b, -(-s // CHUNK), d_in, n)
    if (carries.dtype != torch.float32 or carries.device != x.device
            or tuple(carries.shape) != want or not carries.is_contiguous()
            or carries.data_ptr() % 16):
        raise ValueError(f"carries: {tuple(carries.shape)} {carries.dtype} on {carries.device} "
                         f"is not a carries_buffer for x {tuple(x.shape)} and n {n}")


@B.on_own_device
def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                   carries: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 recurrence with a scalar dt per position.

    x: (b, s, d_in); dt: (b, s); A: (d_in, n) float32; B/C: (b, s, n) of x's
    dtype (float32, bfloat16 or float16), slices of a wider tensor allowed;
    h0: optional (b, d_in, n) initial state. Returns (y (b, s, d_in)
    float32, h_final (b, d_in, n) float32).

    ``carries`` (the chunked kernel only, CUDA): a ``carries_buffer(x, n)``
    that the kernel fills with h at the start of every chunk, for the
    backward; y and h_final are the same bits with or without it."""
    global launches
    tensors = [x, dt, A, Bm, Cm] + ([] if h0 is None else [h0])
    where = B.route(*tensors)
    if where == "cpu":
        if carries is not None:
            raise ValueError("selective_scan: carries are written by the CUDA chunked kernel only")
        return selective_scan_ref(x, dt, A, Bm, Cm, h0)
    B.refuse_grad("selective_scan (use SelectiveScanFn to train)", *tensors)
    b, s, d_in, n = _check(x, dt, A, Bm, Cm, h0, "selective_scan")
    variant = variant_for(s)
    if carries is not None:
        if variant != "chunked":
            raise ValueError(f"selective_scan: the {variant} kernel writes no carries")
        _check_carries(carries, x, n)
    dt32 = dt.to(torch.float32).contiguous()  # bfloat16 -> float32 is exact
    b_sb, b_ss = _row_strides(Bm, "B")
    c_sb, c_ss = _row_strides(Cm, "C")
    y = torch.empty((b, s, d_in), dtype=torch.float32, device=x.device)
    h = torch.empty((b, d_in, n), dtype=torch.float32, device=x.device)
    recorder = W.active()
    if recorder is not None:
        recorder.add_kernel("selective_scan", variant, b=b, s=s, d_in=d_in, n=n,
                            itemsize=x.element_size(), dt_itemsize=dt.element_size(),
                            h0=h0 is not None, chunks=0 if carries is None else carries.shape[1])
    if where == "meta":
        return y, h
    lib = B.library()
    scratch = None  # the chunked kernel's per-chunk images of B, C and dt
    if variant == "chunked":
        scratch = torch.empty(lib.ckv_selective_scan_scratch(b, s, n, B.dtype_code(x)),
                              dtype=torch.uint8, device=x.device)
    rc = lib.ckv_selective_scan(
        x.data_ptr(), dt32.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        0 if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        0 if carries is None else carries.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        b, s, d_in, n, b_sb, b_ss, c_sb, c_ss, B.dtype_code(x), VARIANTS[variant],
        B.stream_handle(x))
    B.check(rc, f"selective_scan {variant}")
    launches += 1
    launches_by_variant[variant] += 1
    return y, h


@B.on_own_device
def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dh_final: Optional[torch.Tensor] = None, *,
                       carries: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The gradients (dx, ddt, dA, dB, dC, dh0) of ``selective_scan(x, dt, A,
    Bm, Cm, h0)`` for the gradients dy of y (b, s, d_in) and dh_final of
    h_final (b, d_in, n, or None for zeros).

    Inputs as ``selective_scan`` takes them. dx, ddt, dB and dC have their
    inputs' dtypes (dB and dC contiguous), dA and dh0 are float32; dh0 is
    returned whether h0 was given or not. ``carries``: the buffer the
    chunked forward filled (``SelectiveScanFn`` passes the one it saved); a
    CUDA call of more than one chunk raises without it."""
    global bwd_launches
    tensors = [x, dt, A, Bm, Cm, dy] + [t for t in (h0, dh_final) if t is not None]
    where = B.route(*tensors)
    if where == "cpu":
        if carries is not None:
            raise ValueError("selective_scan_bwd: carries are read by the CUDA kernel only")
        return selective_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh_final)
    b, s, d_in, n = _check(x, dt, A, Bm, Cm, h0, "selective_scan_bwd")
    B.require(dy, "dy", 3, (torch.float32,))
    if dy.shape != (b, s, d_in):
        raise ValueError(f"dy: shape {tuple(dy.shape)}, expected {(b, s, d_in)}")
    if dh_final is not None:
        B.require(dh_final, "dh_final", 3, (torch.float32,))
        if dh_final.shape != (b, d_in, n):
            raise ValueError(f"dh_final: shape {tuple(dh_final.shape)}, expected {(b, d_in, n)}")
    if carries is None:
        if s > CHUNK:
            raise ValueError("selective_scan_bwd: a sequence of more than one chunk needs the "
                             "carries its forward wrote (selective_scan(..., carries=...))")
        carries = (torch.zeros((b, 1, d_in, n), dtype=torch.float32, device=x.device)
                   if h0 is None else h0[:, None])
    else:
        _check_carries(carries, x, n)
    dt32 = dt.to(torch.float32).contiguous()
    b_sb, b_ss = _row_strides(Bm, "B")
    c_sb, c_ss = _row_strides(Cm, "C")
    dev = x.device
    dx = torch.empty_like(x)
    dB = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s), dtype=torch.float32, device=dev)
    dA = torch.empty((d_in, n), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, d_in, n), dtype=torch.float32, device=dev)
    recorder = W.active()
    if recorder is not None:
        recorder.add_kernel("selective_scan_bwd", "chunked", b=b, s=s, d_in=d_in, n=n,
                            itemsize=x.element_size(), dt_itemsize=dt.element_size(),
                            h0=h0 is not None, dh_final=dh_final is not None)
    if where == "meta":
        return dx, ddt.to(dt.dtype), dA, dB, dC, dh0
    lib = B.library()
    scratch = torch.empty(lib.ckv_selective_scan_bwd_scratch(b, s, n, B.dtype_code(x)),
                          dtype=torch.uint8, device=dev)
    work = torch.empty(lib.ckv_selective_scan_bwd_work_floats(b, s, d_in, n),
                       dtype=torch.float32, device=dev)
    rc = lib.ckv_selective_scan_bwd(
        x.data_ptr(), dt32.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        carries.data_ptr(), dy.data_ptr(), 0 if dh_final is None else dh_final.data_ptr(),
        dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dh0.data_ptr(), scratch.data_ptr(), work.data_ptr(),
        b, s, d_in, n, b_sb, b_ss, c_sb, c_ss, B.dtype_code(x), B.stream_handle(x))
    B.check(rc, "selective_scan_bwd")
    bwd_launches += 1
    return dx, ddt.to(dt.dtype), dA, dB, dC, dh0


def bwd_ctas_per_sm(n: int, dtype: torch.dtype) -> int:
    """CTAs an SM of the backward kernel at state size n and x's dtype, as
    the CUDA occupancy calculator gives them on the current device."""
    got = B.library().ckv_selective_scan_bwd_occupancy(n, B.DTYPE_CODES[str(dtype).removeprefix(
        "torch.")])
    if got < 0:
        raise RuntimeError(f"selective_scan_bwd: no occupancy for n {n}, {dtype}")
    return got


class SelectiveScanFn(torch.autograd.Function):
    """``selective_scan`` under autograd: the forward kernel (the chunked
    one storing its carries where s >= CHUNKED_MIN_S), then the backward
    kernels (``selective_scan_bwd``) for the gradients of x, dt, A, B, C and
    h0; inputs that need none get None. Saves the inputs and the carries. On
    CPU tensors both are the plain versions; on meta tensors both take their
    meta routes. A CUDA call the backward does
    not take raises here, before the forward runs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0=None):
        ctx.set_materialize_grads(False)
        carries = None
        if B.route(*[t for t in (x, dt, A, Bm, Cm, h0) if t is not None]) != "cpu":
            _check(x, dt, A, Bm, Cm, h0, "SelectiveScanFn")
            if variant_for(x.shape[1]) == "chunked":
                carries = carries_buffer(x, A.shape[1])
        y, h = selective_scan(x, dt, A, Bm, Cm, h0, carries=carries)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0, carries)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, h0, carries = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = selective_scan_bwd(x, dt, A, Bm, Cm, h0, dy.contiguous(),
                                   None if dh is None else dh.contiguous(), carries=carries)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
