"""Schedulable step plans: the engine/executor contract.

:meth:`_EngineBase.plan` returns a :class:`StepPlan` whose generator yields
one :class:`ComputeOp` or :class:`WaitOp` per blocking point; whoever drives
the generator decides *when* each op runs:

  drive_serial       — one plan at a time against the executor's own clock;
  serving.Scheduler  — many plans interleaved on the wall clock, their decode
                       steps coalesced into one batched pass through the
                       :class:`DecodeBatchCtx` each decode op carries, and
                       their same-layer final prefill chunks through the
                       :class:`PrefillChunkCtx` such an op carries.

Non-blocking work (I/O submissions, numpy scoring between ops) executes
inline inside the generator. Each plan carries a :class:`RequestClock`, the
request-local notion of "now".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Generator, Optional

from repro_torch.storage.timing import IOHandle


class RequestClock:
    """Request-local virtual time (sim) / last-observed wall time (real).

    Drivers update ``t`` after every op; the engine reads it for stage
    accounting. ``channel`` names the accelerator channel the request's
    compute ops occupy: the shared ``"compute"`` by default, a worker's
    (``"compute:p0"``, ``"compute:d1"``, ...) once a disaggregated scheduler
    routes the plan.
    """

    __slots__ = ("t", "channel")

    def __init__(self, t: float = 0.0, channel: str = "compute"):
        self.t = t
        self.channel = channel

    def __repr__(self):
        return f"RequestClock(t={self.t:.6f})"


@dataclasses.dataclass
class ComputeOp:
    """Occupy the accelerator; the generator receives ``fn()``'s value.

    ``flops``/``hbm_bytes`` price the op for a simulated executor (the real
    executor runs ``fn`` on the wall clock). ``phase`` distinguishes prefill
    ops from per-token decode steps, which a serving scheduler may coalesce
    across concurrent plans; ``weight_bytes`` is the slice of ``hbm_bytes``
    such a batch shares (streamed model weights) and ``tokens`` the op's
    share of a batch iteration's token budget (1 for a decode step, 0 for
    ops that run alone).

    ``weight_key`` names the weight stream ``weight_bytes`` refers to:
    ``"model@<cfg.name>"`` for a decode step (every layer and the LM head).
    Two ops share a weight read only if their streams match
    (:func:`weight_stream`), so a batch never mixes two models.

    ``batch_ctx`` (real mode) is the op's batching surface: a
    :class:`DecodeBatchCtx` on decode steps, which a scheduler coalesces into
    one ``backend.decode_step_batch`` pass, or a :class:`PrefillChunkCtx` on
    the final chunk of a chunked part-B layer, which it coalesces into one
    ``backend.part_b_batch`` pass. ``fn`` stays the standalone
    single-request path, so a driver that ignores it (``drive_serial``) runs
    the plan unchanged.
    """

    fn: Optional[Callable]
    flops: float = 0.0
    hbm_bytes: float = 0.0
    tag: str = "compute"
    phase: str = "prefill"
    weight_bytes: float = 0.0
    tokens: int = 0
    weight_key: str = ""
    batch_ctx: Optional[object] = None  # DecodeBatchCtx | PrefillChunkCtx


@dataclasses.dataclass
class DecodeBatchCtx:
    """Batchable-op metadata for one real-mode decode ComputeOp.

    ``backend`` is the :class:`repro_torch.core.backends.RealCompute` the
    step runs on (two ops batch only if they share one; a disaggregated
    scheduler restamps it at the prefill-to-decode handoff); ``token`` and
    ``pos`` are this step's greedy-fed input token and absolute position;
    ``pools`` maps layer -> the request's paged KV pool, which the batched
    pass appends to and attends over. ``pools`` is also the preemption
    surface: the scheduler swaps them out to host memory when it evicts the
    plan and back in before the held op resumes.
    """

    backend: object
    token: int
    pos: int
    pools: dict


@dataclasses.dataclass
class PrefillChunkCtx:
    """Batchable-op metadata for a real-mode prefill-chunk ComputeOp.

    Carried by the final chunk op of a chunked part-B layer (the one whose
    ``fn`` runs the attention; earlier chunks only occupy the device). Two
    ops coalesce into one ``backend.part_b_batch`` call only when they share
    a backend, the layer and identical shapes and dtypes (``shape_key``):
    the batched pass runs each member's part B at its own shape, so ragged
    members cannot mix.
    """

    backend: object
    layer: int
    h: object  # (1, s, d_model) residual stream entering part B
    q: object  # (1, s, n_q, d_head) rotated queries
    k_suf: object  # (1, s, n_kv, d_head) suffix keys
    v_suf: object  # (1, s, n_kv, d_head) suffix values
    k_sel: object  # (nb, c, n_kv, d_head) gathered selected-chunk keys (numpy)
    v_sel: object  # (nb, c, n_kv, d_head) gathered selected-chunk values (numpy)
    valid: object  # (nb,) bucket-validity mask (numpy)
    chunk_tokens: int

    def shape_key(self):
        """(layer, chunk tokens, shape and dtype of h, q, k_suf, k_sel and
        valid). A dtype is named as numpy and jax name it ("float32"), for
        torch tensors and numpy arrays alike."""
        def sig(x):
            shp = getattr(x, "shape", None)
            dt = getattr(x, "dtype", None)
            return (tuple(shp) if shp is not None else None,
                    str(dt).removeprefix("torch."))

        return (self.layer, int(self.chunk_tokens), sig(self.h), sig(self.q),
                sig(self.k_suf), sig(self.k_sel), sig(self.valid))


@dataclasses.dataclass
class WaitOp:
    """Suspend until ``handle`` completes; receives the handle's result."""

    handle: IOHandle
    tag: str = ""


def weight_stream(weight_key: str) -> str:
    """The model namespace of a ``weight_key``: the part after the last
    ``"@"``, or ``""`` for an un-namespaced key. Ops whose streams differ
    belong to different models and never share a weight read."""
    _, sep, stream = weight_key.rpartition("@")
    return stream if sep else ""


@dataclasses.dataclass
class StepPlan:
    """A resumable per-request execution: generator + clock + live trace."""

    request_id: int
    gen: Generator
    clock: RequestClock
    trace: object  # ReprefillTrace (avoid circular import)

    def resume_time(self, op) -> float:
        """Earliest time the pending op can run."""
        if isinstance(op, WaitOp):
            return max(self.clock.t, op.handle.ready_at)
        return self.clock.t


def resolve_handle(handle: IOHandle):
    """Materialize a completed handle's payload (real mode joins the future)."""
    if handle.future is not None:
        return handle.done_result()
    return handle.result


def drive_serial(executor, plan: StepPlan):
    """Run one plan to completion on a single-control-point executor, every
    op issued at the executor's own ``now()`` in program order. Returns the
    generator's return value (the logits)."""
    clock = plan.clock
    clock.t = executor.now()
    gen = plan.gen
    send = None
    try:
        while True:
            op = gen.send(send)
            if isinstance(op, ComputeOp):
                send = executor.compute(op.fn, flops=op.flops,
                                        hbm_bytes=op.hbm_bytes, tag=op.tag)
            elif isinstance(op, WaitOp):
                executor.wait(op.handle)
                send = resolve_handle(op.handle)
            else:
                raise TypeError(f"plan yielded {op!r}, expected ComputeOp/WaitOp")
            clock.t = executor.now()
    except StopIteration as stop:
        return stop.value
