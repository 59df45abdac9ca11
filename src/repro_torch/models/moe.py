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

A microbatch whose rows are split over data-parallel shards (the train
step over a mesh) keeps the microbatch's dispatch: each shard's call takes
a :class:`MoeRoute` with the microbatch's token count, which sizes the
capacity, and each expert's assignments in the shards before it, which
start that expert's queue. The shards then run in order and keep and drop
the assignments the whole microbatch would. Only integers cross shards, so
the backward is unchanged.

``moe_ffn`` is three parts, which a tensor-parallel layer
(``launch/tp_compute.py``) runs apart: :func:`route_tokens` once,
:func:`expert_ffn` on each shard's experts (or each expert's columns), and
:func:`combine` once over all the experts' outputs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.models.layers import matmul

# When a list, every moe_ffn call appends the number of (token, expert)
# assignments it dropped at capacity, as a device scalar (no host sync).
drop_log: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class MoeRoute:
    """One layer's part of a microbatch's dispatch: ``tokens``, the
    microbatch's token count; ``offset``, (E,) assignments each expert took
    in the rows before this part (None: none); ``counts``, this part's
    assignments an expert, set by ``moe_ffn``."""

    tokens: int
    offset: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None


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


def dispatch(top_idx: torch.Tensor, cap: int, n_experts: int,
             offset: Optional[torch.Tensor] = None):
    """The routing table of (T, k) top-k expert ids at ``cap`` slots an
    expert: (slot (T k,) of each flattened (token, slot) assignment, E cap
    where it overflowed; keep (T k,) bool; gather_idx (E, cap), the token in
    each expert slot or T where it is empty). ``offset`` (E,) starts each
    expert's queue that many places in."""
    T, k = top_idx.shape
    E, dev = n_experts, top_idx.device
    flat_expert = top_idx.reshape(-1)
    # each assignment's place in its expert's queue: the exclusive count of
    # earlier assignments to the same expert, token-major
    onehot = torch.nn.functional.one_hot(flat_expert, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    if offset is not None:
        pos = pos + offset[flat_expert]
    keep = pos < cap
    slot = torch.where(keep, flat_expert * cap + pos, E * cap)  # E cap: the overflow bucket
    # each assignment written at its slot, a dropped one as T into the
    # overflow entry that is sliced away: no shape that depends on the data,
    # so meta tensors (the dry run) take it too
    tokens = torch.arange(T, device=dev).repeat_interleave(k)
    table = torch.full((E * cap + 1,), T, dtype=torch.long, device=dev)
    table.index_put_((slot,), torch.where(keep, tokens, T))
    return slot, keep, table[: E * cap].reshape(E, cap)


@dataclasses.dataclass
class Dispatch:
    """One call's routing (:func:`route`): ``top_idx`` (T, k) expert ids and
    ``top_w`` (T, k) float32 weights; ``slot``, ``keep`` and ``gather_idx``
    as :func:`dispatch` gives them at ``cap`` slots an expert."""

    top_idx: torch.Tensor
    top_w: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gather_idx: torch.Tensor
    cap: int


def route_tokens(xt: torch.Tensor, w_router: torch.Tensor, *, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25, dropless: bool = False,
                 route: Optional[MoeRoute] = None) -> Dispatch:
    """The router and the dispatch of xt (T, d): ``moe_ffn``'s first part,
    which every expert shard of a tensor-parallel layer shares."""
    T = xt.shape[0]
    E, k = n_experts, top_k
    cap = capacity(T if route is None else route.tokens, E, k, capacity_factor, dropless)
    top_idx, top_w = _router(xt, w_router, k)  # (T, k)
    slot, keep, gather_idx = dispatch(top_idx, cap, E, None if route is None else route.offset)
    if route is not None:  # bincount, in a form a meta tensor takes
        flat = top_idx.reshape(-1)
        route.counts = torch.zeros(E, dtype=torch.long, device=xt.device).scatter_add_(
            0, flat, torch.ones_like(flat))
    if drop_log is not None:
        drop_log.append((~keep).sum())
    return Dispatch(top_idx, top_w, slot, keep, gather_idx, cap)


def expert_ffn(xt: torch.Tensor, gather_idx: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their queues: xt (T, d), gather_idx (E', cap)
    (T where a slot is empty), w_gate / w_up (E', d, f), w_down (E', f, d)
    -> (E', cap, d). E' may be a shard of the experts and f a shard of each
    expert's columns (the output is then a partial sum)."""
    d = xt.shape[-1]
    xe = torch.cat([xt, xt.new_zeros(1, d)])[gather_idx]  # (E', cap, d); row T is zeros
    g = matmul(xe, w_gate)
    u = matmul(xe, w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(xe.dtype) * u
    return matmul(h, w_down)


def combine(ye: torch.Tensor, disp: Dispatch, dtype: torch.dtype) -> torch.Tensor:
    """Each token's kept expert outputs (ye (E, cap, d)) weighted by its
    router weights and summed in float32 in ascending expert order: (T, d)
    in ``dtype``."""
    E, cap, d = ye.shape
    T, k = disp.top_idx.shape
    w_table = torch.zeros(E * cap + 1, dtype=torch.float32, device=ye.device)
    w_table.index_put_((disp.slot,), torch.where(disp.keep, disp.top_w.reshape(-1), 0.0))
    contrib = ye.to(torch.float32).reshape(-1, d) * w_table[: E * cap, None]
    contrib = torch.cat([contrib, contrib.new_zeros(1, d)])  # row E cap: a dropped slot
    # combine: each token's slots in ascending expert order, summed in turn
    rows = disp.slot.reshape(T, k).gather(1, torch.argsort(disp.top_idx, dim=-1))
    out = contrib[rows[:, 0]]
    for j in range(1, k):
        out = out + contrib[rows[:, j]]
    return out.to(dtype)


def moe_ffn(x: torch.Tensor, params: dict, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, dropless: bool = False,
            route: Optional[MoeRoute] = None) -> torch.Tensor:
    """x: (..., d_model). params: w_router (d, E), w_gate/w_up (E, d, f),
    w_down (E, f, d). ``dropless=True`` sets the capacity to T (decode,
    where dropping a token would corrupt generation). ``route``: x is a
    part of a larger microbatch (see the module docstring)."""
    orig_shape = x.shape
    xt = x.reshape(-1, orig_shape[-1])
    disp = route_tokens(xt, params["w_router"], n_experts=n_experts, top_k=top_k,
                        capacity_factor=capacity_factor, dropless=dropless, route=route)
    ye = expert_ffn(xt, disp.gather_idx, params["w_gate"], params["w_up"], params["w_down"])
    return combine(ye, disp, x.dtype).reshape(orig_shape)


def init_moe_params(cfg, make, dtype, layers: int) -> dict:
    """Random router and expert weights with the JAX package's shapes,
    scales and dtypes, stacked over ``layers``; each layer is drawn in
    float32 and cast into its slot. ``make``: the ``models.common.Leaves``
    that places them."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts

    def stacked(name, shape, std):
        return make.stacked(("layers", "moe", name), layers, shape, std, dtype)

    return {
        "w_router": stacked("w_router", (d, E), d ** -0.5),
        "w_gate": stacked("w_gate", (E, d, f), d ** -0.5),
        "w_up": stacked("w_up", (E, d, f), d ** -0.5),
        "w_down": stacked("w_down", (E, f, d), f ** -0.5),
    }
