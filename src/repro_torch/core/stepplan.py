"""Schedulable step plans: the engine/executor contract.

:meth:`_EngineBase.plan` returns a :class:`StepPlan` whose generator yields
one :class:`ComputeOp` or :class:`WaitOp` per blocking point; whoever drives
the generator decides *when* each op runs. :func:`drive_serial` runs one plan
at a time against the executor's own clock; the serving scheduler, which
interleaves many plans, comes with a later slice of the port.

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
    accounting.
    """

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = t

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
    """

    fn: Optional[Callable]
    flops: float = 0.0
    hbm_bytes: float = 0.0
    tag: str = "compute"
    phase: str = "prefill"
    weight_bytes: float = 0.0
    tokens: int = 0


@dataclasses.dataclass
class WaitOp:
    """Suspend until ``handle`` completes; receives the handle's result."""

    handle: IOHandle
    tag: str = ""


@dataclasses.dataclass
class StepPlan:
    """A resumable per-request execution: generator + clock + live trace."""

    request_id: int
    gen: Generator
    clock: RequestClock
    trace: object  # ReprefillTrace (avoid circular import)


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
