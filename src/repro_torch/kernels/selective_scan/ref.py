"""Plain versions of the selective_scan kernels (mamba-1 recurrence, dt_rank=1).

``selective_scan_ref`` is the recurrence step by step, which the wrapper runs
for CPU tensors; ``selective_scan_chunked_ref`` repeats the chunked kernel's
decomposition, for the tests of its carry arithmetic."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def selective_scan_ref(
    x: torch.Tensor,  # (b, s, d_in)
    dt: torch.Tensor,  # (b, s)   softplus'd, broadcast over channels
    A: torch.Tensor,  # (d_in, n) negative-definite diagonal
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    h0: Optional[torch.Tensor] = None,  # (b, d_in, n) initial recurrent state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[t] = C[t] . h[t],  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t].

    Sequential over s, in float32. ``h0`` seeds the recurrence (decode
    resumes mid-stream); None means zeros. Returns (y (b, s, d_in) float32,
    h_final (b, d_in, n) float32)."""
    b, s, d_in = x.shape
    n = A.shape[1]
    f32 = torch.float32
    h = (torch.zeros((b, d_in, n), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    xf, dtf, Bf, Cf, Af = x.to(f32), dt.to(f32), B.to(f32), C.to(f32), A.to(f32)
    ys = []
    for t in range(s):
        dt_t = dtf[:, t]  # (b,)
        dA = torch.exp(dt_t[:, None, None] * Af[None])  # (b, d_in, n)
        h = dA * h + (dt_t[:, None] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((b, 0, d_in), dtype=f32, device=x.device)
    return y, h


def selective_scan_chunked_ref(
    x: torch.Tensor,  # (b, s, d_in)
    dt: torch.Tensor,  # (b, s)
    A: torch.Tensor,  # (d_in, n)
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    h0: Optional[torch.Tensor] = None,  # (b, d_in, n)
    chunk: int = 256,
    run: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's decomposition of the same recurrence, in float32.

    The sequence goes ``chunk`` positions at a time; a chunk is cut into
    runs of ``run`` positions (one thread each on the card). Per run: the
    pairs (a_t, b_t) = (exp2(dt_t A log2 e), dt_t x_t B_t), folded from a
    zero state into the run's running product of a and its local h. Then an
    inclusive Hillis-Steele scan of the runs' (prod a, h) under
    (a2 a1, a2 b1 + b2), with offsets 1, 2, 4, ... (the kernel's shuffles),
    shifted by one run; seeded with the h carried into the chunk it gives
    h_t = prod_t h_start + local_t, and y_t sums C_tj h_tj over j in order.
    The carry is h at the chunk's last position (positions past s are
    (1, 0), which keep h as it is). Returns (y (b, s, d_in), h_final
    (b, d_in, n)), both float32."""
    b, s, d_in = x.shape
    n = A.shape[1]
    f32 = torch.float32
    n_runs = chunk // run
    a2 = A.to(f32) * math.log2(math.e)
    carry = (torch.zeros((b, d_in, n), dtype=f32, device=x.device) if h0 is None
             else h0.to(f32).clone())
    y = torch.empty((b, s, d_in), dtype=f32, device=x.device)
    for t0 in range(0, s, chunk):
        ts = min(chunk, s - t0)
        pad = chunk - ts

        def take(t: torch.Tensor) -> torch.Tensor:  # (b, ts, ...) -> (b, n_runs, run, ...)
            t = t[:, t0: t0 + ts].to(f32)
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
            return t.reshape((b, n_runs, run) + t.shape[2:])

        dtc, xc, bc, cc = take(dt), take(x), take(B), take(C)
        a = torch.exp2(dtc[..., None, None] * a2)  # (b, runs, run, d_in, n)
        bx = (dtc[..., None] * xc)[..., None] * bc[:, :, :, None, :]
        prod = torch.empty_like(a)
        local = torch.empty_like(a)
        pc = torch.ones_like(a[:, :, 0])
        h = torch.zeros_like(a[:, :, 0])
        for r in range(run):  # fold each run from a zero state
            h = a[:, :, r] * h + bx[:, :, r]
            pc = pc * a[:, :, r]
            prod[:, :, r], local[:, :, r] = pc, h
        ag, bg = pc, h  # (b, runs, d_in, n)
        o = 1
        while o < n_runs:  # inclusive scan over the runs
            au = torch.cat([torch.ones_like(ag[:, :o]), ag[:, :-o]], 1)
            bu = torch.cat([torch.zeros_like(bg[:, :o]), bg[:, :-o]], 1)
            ag, bg = ag * au, ag * bu + bg
            o *= 2
        ae = torch.cat([torch.ones_like(ag[:, :1]), ag[:, :-1]], 1)
        be = torch.cat([torch.zeros_like(bg[:, :1]), bg[:, :-1]], 1)
        h_start = ae * carry[:, None] + be  # (b, runs, d_in, n)
        hs = prod * h_start[:, :, None] + local  # (b, runs, run, d_in, n)
        yc = torch.zeros(hs.shape[:-1], dtype=f32, device=x.device)
        for j in range(n):
            yc = cc[:, :, :, None, j] * hs[..., j] + yc
        y[:, t0: t0 + ts] = yc.reshape(b, chunk, d_in)[:, :ts]
        carry = hs[:, -1, -1]
    return y, carry
