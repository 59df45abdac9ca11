"""Mixture-of-Experts FFN with capacity-based gather/scatter dispatch.

The JAX package's ``models/moe.py`` in plain torch: tokens are routed by a
float32 top-k, placed in per-expert queues of ``cap`` slots (an assignment
past its expert's capacity goes to an overflow bucket that is sliced away, so
that expert adds nothing to the token, which keeps its residual), run
through a batched per-expert SwiGLU with ``layers.swiglu``'s rounding
points, and combined with their router weights in float32.

The combine is deterministic. The reference scatter-adds the weighted
expert outputs into a (T + 1, d) float32 buffer; ``index_add_`` on a CUDA
tensor sums with atomics in an order that changes from run to run. Here each
token gathers its kept assignments and sums them one after another in
ascending expert order, the order of the reference's flattened (expert,
slot) gather table, so two runs give the same bits on the card.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.models.layers import matmul

# When a list, every moe_ffn call appends the number of (token, expert)
# assignments it dropped at capacity, as a device scalar (no host sync).
drop_log: Optional[List[torch.Tensor]] = None


def _router(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """x: (T, d) -> (top-k expert ids (T, k), weights (T, k) float32
    softmaxed over the top k). ``torch.topk`` sorts descending, as
    ``jax.lax.top_k``; how each breaks an exact tie is its own."""
    logits = torch.matmul(x.to(torch.float32), w_router.to(torch.float32))
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    return top_idx, torch.softmax(top_vals, dim=-1)


def capacity(T: int, n_experts: int, top_k: int, capacity_factor: float,
             dropless: bool) -> int:
    """Slots per expert for T tokens: ceil(T k cf / E) in [1, T], or T."""
    if dropless:
        return T
    cap = max(1, int(-(-T * top_k * capacity_factor // n_experts)))
    return min(cap, T)


def dispatch(top_idx: torch.Tensor, cap: int, n_experts: int):
    """The routing table of (T, k) top-k expert ids at ``cap`` slots an
    expert: (slot (T k,) of each flattened (token, slot) assignment, E cap
    where it overflowed; keep (T k,) bool; gather_idx (E, cap), the token in
    each expert slot or T where it is empty)."""
    T, k = top_idx.shape
    E, dev = n_experts, top_idx.device
    flat_expert = top_idx.reshape(-1)
    # each assignment's place in its expert's queue: the exclusive count of
    # earlier assignments to the same expert, token-major
    onehot = torch.nn.functional.one_hot(flat_expert, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, flat_expert * cap + pos, E * cap)  # E cap: the overflow bucket
    table = torch.full((E * cap + 1,), T, dtype=torch.long, device=dev)
    table[slot[keep]] = torch.arange(T, device=dev).repeat_interleave(k)[keep]
    return slot, keep, table[: E * cap].reshape(E, cap)


def moe_ffn(x: torch.Tensor, params: dict, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, dropless: bool = False) -> torch.Tensor:
    """x: (..., d_model). params: w_router (d, E), w_gate/w_up (E, d, f),
    w_down (E, f, d). ``dropless=True`` sets the capacity to T (decode,
    where dropping a token would corrupt generation)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    E, k = n_experts, top_k
    cap = capacity(T, E, k, capacity_factor, dropless)

    top_idx, top_w = _router(xt, params["w_router"], k)  # (T, k)
    slot, keep, gather_idx = dispatch(top_idx, cap, E)
    if drop_log is not None:
        drop_log.append((~keep).sum())

    xe = torch.cat([xt, xt.new_zeros(1, d)])[gather_idx]  # (E, cap, d); row T is zeros
    g = matmul(xe, params["w_gate"])
    u = matmul(xe, params["w_up"])
    h = torch.nn.functional.silu(g.to(torch.float32)).to(xe.dtype) * u
    ye = matmul(h, params["w_down"])  # (E, cap, d)

    w_table = torch.zeros(E * cap + 1, dtype=torch.float32, device=x.device)
    w_table[slot[keep]] = top_w.reshape(-1)[keep]
    contrib = ye.to(torch.float32).reshape(-1, d) * w_table[: E * cap, None]
    contrib = torch.cat([contrib, contrib.new_zeros(1, d)])  # row E cap: a dropped slot
    # combine: each token's slots in ascending expert order, summed in turn
    rows = slot.reshape(T, k).gather(1, torch.argsort(top_idx, dim=-1))
    out = contrib[rows[:, 0]]
    for j in range(1, k):
        out = out + contrib[rows[:, j]]
    return out.to(x.dtype).reshape(orig_shape)


def init_moe_params(cfg, generator: torch.Generator, dtype, device, layers: int) -> dict:
    """Random router and expert weights with the JAX package's shapes,
    scales and dtypes, stacked over ``layers``; each layer is drawn in
    float32 and cast into its slot."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def stacked(shape, std):
        out = torch.empty((layers,) + shape, dtype=dtype, device=device)
        for l in range(layers):
            out[l] = std * torch.randn(shape, generator=generator, device=device)
        return out

    return {
        "w_router": stacked((d, E), d ** -0.5),
        "w_gate": stacked((E, d, f), d ** -0.5),
        "w_up": stacked((E, d, f), d ** -0.5),
        "w_down": stacked((E, f, d), f ** -0.5),
    }
