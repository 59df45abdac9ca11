"""Plain versions of the selective_scan kernels (mamba-1 recurrence, dt_rank=1).

``selective_scan_ref`` is the recurrence step by step, which the wrapper runs
for CPU tensors; ``selective_scan_chunked_ref`` repeats the chunked kernel's
decomposition, for the tests of its carry arithmetic. ``selective_scan_bwd_ref``
is the backward walked in reverse, which ``selective_scan_bwd`` runs for CPU
tensors; ``selective_scan_bwd_chunked_ref`` repeats the backward kernel's
decomposition. The step-by-step versions compute in float32, or in float64
for float64 inputs (``torch.autograd.gradcheck``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _compute_dtype(*tensors) -> torch.dtype:
    """float64 if any input is float64, else float32."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def selective_scan_ref(
    x: torch.Tensor,  # (b, s, d_in)
    dt: torch.Tensor,  # (b, s)   softplus'd, broadcast over channels
    A: torch.Tensor,  # (d_in, n) negative-definite diagonal
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    h0: Optional[torch.Tensor] = None,  # (b, d_in, n) initial recurrent state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y[t] = C[t] . h[t],  h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] x[t].

    Sequential over s, in float32 (float64 for float64 inputs). ``h0``
    seeds the recurrence (decode resumes mid-stream); None means zeros.
    Returns (y (b, s, d_in), h_final (b, d_in, n)) in that dtype."""
    b, s, d_in = x.shape
    n = A.shape[1]
    f = _compute_dtype(x, dt, A, B, C, h0)
    h = (torch.zeros((b, d_in, n), dtype=f, device=x.device) if h0 is None
         else h0.to(f))
    xf, dtf, Bf, Cf, Af = x.to(f), dt.to(f), B.to(f), C.to(f), A.to(f)
    ys = []
    for t in range(s):
        dt_t = dtf[:, t]  # (b,)
        dA = torch.exp(dt_t[:, None, None] * Af[None])  # (b, d_in, n)
        h = dA * h + (dt_t[:, None] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((b, 0, d_in), dtype=f, device=x.device)
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
    a2 = A.to(f32) * math.log2(math.e)
    carry = (torch.zeros((b, d_in, n), dtype=f32, device=x.device) if h0 is None
             else h0.to(f32).clone())
    y = torch.empty((b, s, d_in), dtype=f32, device=x.device)
    for t0 in range(0, s, chunk):
        ts = min(chunk, s - t0)
        take = _chunk_taker(b, t0, ts, chunk, run)
        dtc, xc, cc = take(dt), take(x), take(C)
        _, hs, _, _ = _chunk_h(dtc, xc, take(B), carry, a2)
        yc = torch.zeros(hs.shape[:-1], dtype=f32, device=x.device)
        for j in range(n):
            yc = cc[:, :, :, None, j] * hs[..., j] + yc
        y[:, t0: t0 + ts] = yc.reshape(b, chunk, d_in)[:, :ts]
        carry = hs[:, -1, -1]
    return y, carry


def _chunk_taker(b: int, t0: int, ts: int, chunk: int, run: int):
    """(b, s, ...) -> the chunk's positions t0 .. t0 + ts as float32
    (b, chunk // run, run, ...), zero past ts."""
    def take(t: torch.Tensor) -> torch.Tensor:
        t = t[:, t0: t0 + ts].to(torch.float32)
        t = torch.cat([t, t.new_zeros((b, chunk - ts) + t.shape[2:])], 1)
        return t.reshape((b, chunk // run, run) + t.shape[2:])
    return take


def _chunk_h(dtc, xc, bc, carry, a2, backward=False):
    """The chunked kernel's h over one chunk from the h ``carry`` (b, d_in, n)
    at its start: per run the pairs (a_t, b_t) folded from a zero state into
    the running product of a and the local h, an inclusive Hillis-Steele scan
    of the runs' (prod a, h) shifted by one run, h_t = prod_t h_start + local_t.
    With ``backward`` (the backward kernel's arithmetic) h_t = a_t h_{t-1} +
    b_t along each run from its h_start. Returns (a, h) (b, runs, run, d_in, n), each run's
    h_start (b, runs, d_in, n) and each run's product of a."""
    n_runs, run = dtc.shape[1], dtc.shape[2]
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
    if backward:
        h = h_start
        for r in range(run):
            h = a[:, :, r] * h + bx[:, :, r]
            local[:, :, r] = h
        return a, local, h_start, prod[:, :, -1]
    return a, prod * h_start[:, :, None] + local, h_start, prod[:, :, -1]


def selective_scan_bwd_ref(
    x: torch.Tensor,  # (b, s, d_in)
    dt: torch.Tensor,  # (b, s)
    A: torch.Tensor,  # (d_in, n)
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    h0: Optional[torch.Tensor],  # (b, d_in, n) or None for zeros
    dy: torch.Tensor,  # (b, s, d_in): the gradient of y
    dh_final: Optional[torch.Tensor] = None,  # (b, d_in, n): of h_final; None for zeros
) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``selective_scan_ref``'s (y, h_final), walked in
    reverse. With a_t = exp(dt_t A), u_t = dt_t x_t and g_t = dL/dh_t =
    dy_t C_t + a_{t+1} g_{t+1} (seeded by dh_final at t = s - 1):
    dC_t = sum_d dy_t h_t, dB_t = sum_d u_t g_t, dx_t = dt_t sum_n B_t g_t,
    ddt_t = sum_{d,n} (x_t B_t + A a_t h_{t-1}) g_t, dA = sum_{b,t} dt_t a_t
    h_{t-1} g_t and dh0 = a_0 g_0. A forward pass keeps every h_t first.
    Returns (dx, ddt, dA, dB, dC, dh0), each in its input's dtype (dh0 in
    the compute dtype)."""
    b, s, d_in = x.shape
    n = A.shape[1]
    f = _compute_dtype(x, dt, A, B, C, h0, dy, dh_final)
    xf, dtf, Bf, Cf, Af, dyf = (t.to(f) for t in (x, dt, B, C, A, dy))
    h = torch.zeros((b, d_in, n), dtype=f, device=x.device) if h0 is None else h0.to(f)
    hs = [h]  # hs[t] = h_{t-1}
    for t in range(s):
        a = torch.exp(dtf[:, t, None, None] * Af[None])
        h = a * h + (dtf[:, t, None] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs.append(h)
    q = (torch.zeros((b, d_in, n), dtype=f, device=x.device) if dh_final is None
         else dh_final.to(f))  # a_{t+1} g_{t+1}, then dh_final past the end
    dx = torch.empty((b, s, d_in), dtype=f, device=x.device)
    ddt = torch.empty((b, s), dtype=f, device=x.device)
    dB = torch.empty((b, s, n), dtype=f, device=x.device)
    dC = torch.empty((b, s, n), dtype=f, device=x.device)
    dA = torch.zeros((b, d_in, n), dtype=f, device=x.device)
    for t in reversed(range(s)):
        dt_t = dtf[:, t]
        a = torch.exp(dt_t[:, None, None] * Af[None])
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + q
        bg = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        w = a * hs[t] * g
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt_t[:, None] * xf[:, t])
        dx[:, t] = dt_t[:, None] * bg
        ddt[:, t] = (xf[:, t] * bg).sum(-1) + torch.einsum("bdn,dn->b", w, Af)
        dA += dt_t[:, None, None] * w
        q = a * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.sum(0).to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), q)


def selective_scan_bwd_chunked_ref(
    x: torch.Tensor,  # (b, s, d_in)
    dt: torch.Tensor,  # (b, s)
    A: torch.Tensor,  # (d_in, n)
    B: torch.Tensor,  # (b, s, n)
    C: torch.Tensor,  # (b, s, n)
    h0: Optional[torch.Tensor],  # (b, d_in, n) or None
    dy: torch.Tensor,  # (b, s, d_in)
    dh_final: Optional[torch.Tensor] = None,  # (b, d_in, n) or None
    chunk: int = 256,
    run: int = 8,
) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's decomposition of ``selective_scan_bwd_ref``, in
    float32. The forward's chunked form keeps h at the start of every chunk
    (the carries the forward kernel saves); the chunks are then walked from
    last to first, ``chunk`` positions cut into runs of ``run`` (one lane
    each on the card: 32 lanes of 8, a warp a channel). Per chunk, h is
    recomputed from its carry in the forward's decomposition (h_t = a_t
    h_{t-1} + b_t along each run from its start once the scan has given
    that start); with q_t = a_t g_t = a_t (dy_t C_t + q_{t+1}), each run
    folds its q at its first position backwards from a zero q after it (its
    product of a is the forward fold's), an inclusive Hillis-Steele scan
    over the runs from the last (offsets 1, 2, 4, ...: the kernel's shuffles
    down) shifted by one run and seeded with the q carried from the later
    chunk gives q after every run, and a walk back over each run gives every
    g_t = dy_t C_t + q_{t+1}. q at the chunk's first position is the next
    carry; dh0 is the last. Returns (dx, ddt, dA, dB, dC, dh0), each in its
    input's dtype (dh0 float32)."""
    b, s, d_in = x.shape
    n = A.shape[1]
    f32 = torch.float32
    n_runs = chunk // run
    a2 = A.to(f32) * math.log2(math.e)
    carry = (torch.zeros((b, d_in, n), dtype=f32, device=x.device) if h0 is None
             else h0.to(f32).clone())
    starts = list(range(0, s, chunk))
    carries = []  # h at the start of every chunk
    for t0 in starts:
        carries.append(carry)
        take = _chunk_taker(b, t0, min(chunk, s - t0), chunk, run)
        carry = _chunk_h(take(dt), take(x), take(B), carry, a2)[1][:, -1, -1]  # the forward's
    q = (torch.zeros((b, d_in, n), dtype=f32, device=x.device) if dh_final is None
         else dh_final.to(f32))
    dx = torch.empty((b, s, d_in), dtype=f32, device=x.device)
    ddt = torch.empty((b, s), dtype=f32, device=x.device)
    dB = torch.empty((b, s, n), dtype=f32, device=x.device)
    dC = torch.empty((b, s, n), dtype=f32, device=x.device)
    dA = torch.zeros((b, d_in, n), dtype=f32, device=x.device)
    for t0, h_carry in reversed(list(zip(starts, carries))):
        ts = min(chunk, s - t0)
        take = _chunk_taker(b, t0, ts, chunk, run)
        dtc, xc, bc, cc, dyc = take(dt), take(x), take(B), take(C), take(dy)
        a, hs, h_start, pq = _chunk_h(dtc, xc, bc, h_carry, a2, backward=True)
        c = dyc[..., None] * cc[:, :, :, None, :]  # (b, runs, run, d_in, n)
        ql = torch.zeros_like(a[:, :, 0])
        for r in reversed(range(run)):  # each run from a zero q after it
            ql = a[:, :, r] * (c[:, :, r] + ql)
        ag, bg = pq, ql  # (b, runs, d_in, n)
        o = 1
        while o < n_runs:  # inclusive scan over the runs, from the last
            ad = torch.cat([ag[:, o:], torch.ones_like(ag[:, :o])], 1)
            bd = torch.cat([bg[:, o:], torch.zeros_like(bg[:, :o])], 1)
            ag, bg = ag * ad, ag * bd + bg
            o *= 2
        ae = torch.cat([ag[:, 1:], torch.ones_like(ag[:, :1])], 1)
        be = torch.cat([bg[:, 1:], torch.zeros_like(bg[:, :1])], 1)
        qn = ae * q[:, None] + be  # q after each run
        g = torch.empty_like(a)
        for r in reversed(range(run)):
            g[:, :, r] = c[:, :, r] + qn
            qn = a[:, :, r] * g[:, :, r]
        q = qn[:, 0]  # q at the chunk's first position
        hp = torch.cat([h_start[:, :, None], hs[:, :, :-1]], 2)  # h_{t-1}
        w = a * hp * g
        bg_ = (bc[:, :, :, None, :] * g).sum(-1)  # (b, runs, run, d_in)

        def cut(t):  # (b, runs, run, ...) -> the chunk's ts positions
            return t.reshape((b, chunk) + t.shape[3:])[:, :ts]

        dx[:, t0: t0 + ts] = cut(dtc[..., None] * bg_)
        ddt[:, t0: t0 + ts] = cut((xc * bg_).sum(-1) + (w * A.to(f32)).sum((-2, -1)))
        dB[:, t0: t0 + ts] = cut(dtc[..., None] * (xc[..., None] * g).sum(-2))
        dC[:, t0: t0 + ts] = cut((dyc[..., None] * hs).sum(-2))
        dA += (dtc[..., None, None] * w).sum((1, 2))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.sum(0).to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), q)
