"""Plain version of the selective_scan kernel (mamba-1 recurrence, dt_rank=1)."""
from __future__ import annotations

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
