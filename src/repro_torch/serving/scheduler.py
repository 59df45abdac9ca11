"""Serving scheduler: interleave step plans over shared channels.

Each request is a resumable :class:`repro_torch.core.stepplan.StepPlan`; the
scheduler admits up to ``max_concurrency`` plans. Two drivers share the
admission logic:

  sim  — discrete-event over a ``ChannelSim``: at every step the plan whose
         next op can run earliest advances, so while one request waits on
         the SSD channel another's compute op occupies the accelerator;
         arrival times are respected and queueing delay is part of TTFT.
         Runnable batchable ComputeOps (``op.tokens > 0``: decode tokens
         and, with ``prefill_chunk_tokens``, chunk-granular prefill ops) of
         all active plans coalesce into one batched occupation per
         iteration (FLOPs and per-request KV traffic sum, the weight stream
         is paid once), capped at ``max_batch_tokens``. Its timelines equal
         the JAX package's to the last bit.
  real — the wall clock over a ``RealExecutor``, below.

The real driver multiplexes the plans cooperatively over one executor: a
plan blocked on a pending I/O future yields the driver to the others, so
one request's chunk reads overlap another's compute. Arrival offsets are
wall-clock-faithful: a request is
admitted only once ``now - t0 >= arrival`` (the driver sleeps through idle
gaps). Each driver pass is an iteration: the runnable decode-phase
ComputeOps of plans sharing one backend coalesce into one batched pass
(``backend.decode_step_batch`` over the requests' pools, ragged page tables
padded to a common width), and with chunked prefill
(``prefill_chunk_tokens``) the runnable final chunks of plans at the same
layer and shapes coalesce into one batched part B
(``backend.part_b_batch``), while the other prefill and I/O ops keep the
cooperative round-robin; ``batch_decode=False`` turns the coalescing off,
and a lone decode step or final chunk always runs the standalone path,
which keeps concurrency 1 bit for bit equal to ``drive_serial``. A
compute-or-load recompute op (tag ``recompute``) carries no batching
context, so it always runs alone.

Admission policies:
  fcfs        — strict arrival order;
  cache_aware — prefer the queued request whose tenant has the most resident
                units in the shared cache;
  slo_aware   — earliest-deadline-first over per-request TTFT targets.

SLO-driven preemption (``preempt=True``): when the earliest-deadline queued
request projects a TTFT miss (now plus an EWMA of prefill service times
overruns its deadline), the scheduler preempts an active decode-phase plan at
its step boundary and admits the urgent request into the freed slot. With
``swap_on_preempt`` the victim's state is swapped out and back on resume: in
sim its cache-resident units are priced over the PCIe channel; in real mode
its device-resident pools are moved to host memory and back (real
transfers, bytes counted on both legs), and the resumed decode is
bit-identical to an uninterrupted run. Preempted plans resume first, as
soon as a slot frees.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import wait as futures_wait
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core.cache import DEVICE, HOST
from repro_torch.core.stepplan import (ComputeOp, DecodeBatchCtx, PrefillChunkCtx, StepPlan,
                                       WaitOp, resolve_handle, weight_stream)
from repro_torch.serving.disagg import INTERCONNECT, DisaggTopology
from repro_torch.serving.replicas import ReplicaSet
from repro_torch.storage.timing import ChannelSim, IOHandle


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    request_id: int
    suffix: np.ndarray
    arrival: float = 0.0
    tenant: int = 0
    decode_tokens: int = 0  # tokens to generate past the first (decode phase)
    ttft_target: Optional[float] = None  # per-request TTFT SLO, seconds


@dataclasses.dataclass
class CompletedRequest:
    request: Request
    trace: object  # ReprefillTrace
    result: object  # the last token's logits (real mode) / None (sim)
    admitted: float
    finish: float
    preemptions: int = 0  # times this plan was preempted under SLO pressure
    swaps: int = 0  # swap-out/swap-in round trips of its pools or units

    @property
    def ttft(self) -> float:
        """Arrival to first token: queueing delay + prefill service time.
        (With a decode phase, ``finish`` covers the whole lifecycle, so the
        first-token time comes from the trace.)"""
        if getattr(self.trace, "ttft", 0.0):
            return self.queue_delay + self.trace.ttft
        return self.finish - self.request.arrival

    @property
    def e2e_latency(self) -> float:
        """Arrival to last emitted token (== ttft when decode_tokens=0)."""
        return self.finish - self.request.arrival

    @property
    def queue_delay(self) -> float:
        return self.admitted - self.request.arrival

    @property
    def service_time(self) -> float:
        return self.finish - self.admitted

    @property
    def slo_met(self) -> Optional[bool]:
        if self.request.ttft_target is None:
            return None
        return self.ttft <= self.request.ttft_target


# ---------------------------------------------------------------------------
# admission policies
# ---------------------------------------------------------------------------
class FCFSPolicy:
    name = "fcfs"

    def select(self, queued: Sequence[Request], engines) -> Request:
        return min(queued, key=lambda r: (r.arrival, r.request_id))


class CacheAffinityPolicy:
    """Prefer the tenant with the most cache-resident units (device counts
    double: a device hit avoids both the SSD and the PCIe leg)."""

    name = "cache_aware"

    def select(self, queued: Sequence[Request], engines) -> Request:
        def affinity(r: Request) -> float:
            eng = engines[r.tenant]
            cache = eng.cache
            if cache is None:  # cache-less families (StateSpaceEngine)
                return 0.0
            return (2 * cache.resident_units(eng.tenant, DEVICE)
                    + cache.resident_units(eng.tenant, HOST))

        # ties fall back to FCFS order
        return max(queued, key=lambda r: (affinity(r), -r.arrival, -r.request_id))


def _deadline(r: Request) -> float:
    """Absolute TTFT deadline; +inf for best-effort requests."""
    if r.ttft_target is None:
        return float("inf")
    return r.arrival + r.ttft_target


class SLOAwarePolicy:
    """Earliest-deadline-first over per-request TTFT targets: the deadline
    of a request is ``arrival + ttft_target``; requests without a target
    sort last and fall back to FCFS among themselves."""

    name = "slo_aware"

    def select(self, queued: Sequence[Request], engines) -> Request:
        return min(queued, key=lambda r: (_deadline(r), r.arrival, r.request_id))


POLICIES = {"fcfs": FCFSPolicy, "cache_aware": CacheAffinityPolicy,
            "slo_aware": SLOAwarePolicy}


class _Active:
    __slots__ = ("request", "plan", "op", "resume", "admitted", "preempt_count",
                 "swap_count", "swapped_bytes", "ttft_seen", "batch_stamp", "held_op",
                 "handed_off", "worker_backend", "replica")

    def __init__(self, request: Request, plan: StepPlan, admitted: float):
        self.request = request
        self.plan = plan
        self.op = None
        self.resume = admitted  # sim: earliest time the pending op can run
        self.admitted = admitted
        self.preempt_count = 0
        self.swap_count = 0
        self.swapped_bytes = 0  # bytes swapped out, moved back on resume
        self.ttft_seen = False  # first token already fed the prefill EWMA
        self.batch_stamp = -1  # last iteration this plan batched in
        self.held_op = None  # sim: op parked behind a kv_handoff WaitOp
        self.handed_off = False  # prefill->decode handoff already done
        self.worker_backend = None  # decode worker's backend after the handoff
        self.replica = 0  # owning replica index under a ReplicaSet


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------
class Scheduler:
    """Drives concurrent request streams over one shared executor.

    ``engines`` maps tenant id -> engine; all engines must share the same
    executor (and, for multi-tenant cache competition, the same cache
    instance). A single engine is accepted for the one-tenant case. The
    executor decides the driver (a ``ChannelSim`` runs the discrete-event
    one); in real mode the engines' backends decide the device: the card
    unless they were built for the CPU.
    """

    def __init__(self, engines, *, policy: Union[str, object] = "fcfs",
                 max_concurrency: int = 4, batch_decode: bool = True,
                 max_batch_tokens: Optional[int] = None,
                 preempt: bool = False, swap_on_preempt: bool = False,
                 prefill_estimate: Optional[float] = None,
                 topology: Optional[DisaggTopology] = None,
                 replicas: Optional[ReplicaSet] = None):
        if not isinstance(engines, dict):
            engines = {getattr(engines, "tenant", 0): engines}
        if not engines:
            raise ValueError("need at least one engine")
        if max_concurrency < 1:
            raise ValueError(f"max_concurrency {max_concurrency} < 1")
        if max_batch_tokens is not None and max_batch_tokens < 1:
            raise ValueError(f"max_batch_tokens {max_batch_tokens} < 1")
        if len({id(e.ex) for e in engines.values()}) != 1:
            raise ValueError("all engines must share one executor")
        self.engines = engines
        self.ex = next(iter(engines.values())).ex
        self.policy = POLICIES[policy]() if isinstance(policy, str) else policy
        self.max_concurrency = max_concurrency
        # iteration-level batching of runnable batchable ops (sim: decode
        # tokens and chunk-granular prefill priced through compute_batch_at;
        # real: decode steps and same-layer final chunks in one pass), capped
        # at max_batch_tokens batch tokens (None = uncapped)
        self.batch_decode = batch_decode
        self.max_batch_tokens = max_batch_tokens
        # SLO-driven preemption of decode plans
        self.preempt = preempt
        self.swap_on_preempt = swap_on_preempt
        self.preemptions = 0
        self.swaps = 0
        self.swap_bytes = 0
        # TTFT-miss projection: an EWMA of prefill service times observed at
        # each plan's first token, floored by the operator's seed
        self._prefill_seed = prefill_estimate
        self._prefill_ewma: Optional[float] = None
        # per-iteration batch token counts
        self.batch_log: List[int] = []
        # per-batch member digest [(request_id, phase, weight_key), ...] of
        # the real driver and of the sim driver
        self.real_batch_log: List[List[tuple]] = []
        self.sim_batch_log: List[List[tuple]] = []
        # prefill/decode disaggregation (None = colocated). Sim: per-worker
        # compute channels and the interconnect FIFO on the shared
        # ChannelSim; real: decode_backends carries one backend per decode
        # worker, and the handoff reuses the pools' swap_out/swap_in
        self.topology = topology
        # data-parallel replicas (None = one colocated deployment); a
        # topology passed beside them is per replica
        self.replicas = replicas
        if replicas is not None and topology is not None:
            if replicas.topology is None:
                replicas.topology = topology
            elif replicas.topology is not topology:
                raise ValueError(
                    "pass the per-replica topology either on the ReplicaSet "
                    "or as topology=, not two different ones")
        if isinstance(self.ex, ChannelSim):
            if replicas is not None:
                replicas.attach_sim(self.ex)
            elif topology is not None:
                topology.attach_sim(self.ex)
        self.replica_admits = ([0] * replicas.n_replicas
                               if replicas is not None else [])
        self.handoffs = 0
        self.handoff_bytes = 0  # bytes moved by the handoffs
        self.handoff_recomputes = 0  # sim handoffs the planner turned into
        self.handoff_bytes_avoided = 0  # ... decode-worker recomputes
        self._rr_decode = 0  # round-robin decode-worker pick

    def run(self, requests: Sequence[Request]) -> List[CompletedRequest]:
        requests = list(requests)
        # each run starts the engines' compute-or-load planners afresh (one
        # planner may be shared by a fleet's engines): their reservations are
        # points on this run's clock, and a sim rerun restarts at t = 0; the
        # real-mode IO calibration survives, as wall-clock IO does not restart
        for hp in {id(hp): hp for hp in (getattr(e, "hybrid", None)
                                         for e in self.engines.values())
                   if hp is not None}.values():
            hp.reset()
        if isinstance(self.ex, ChannelSim):
            return self._run_sim(requests)
        if self.replicas is not None and self.replicas.backends is None:
            raise ValueError("real-mode replicas need ReplicaSet.backends "
                             "(one worker-backend list per replica)")
        if (self.replicas is None and self.topology is not None
                and not self.topology.decode_backends):
            raise ValueError("real-mode disaggregation needs "
                             "DisaggTopology.decode_backends")
        return self._run_real(requests)

    @property
    def _prefill_est(self) -> float:
        """Projected prefill service time: EWMA floored by the seed."""
        return max(self._prefill_seed or 0.0, self._prefill_ewma or 0.0)

    def _observe_ttft(self, a: _Active):
        """Feed the prefill EWMA as soon as a plan emits its first token."""
        if a.ttft_seen:
            return
        ttft = getattr(a.plan.trace, "ttft", 0.0)
        if ttft:
            a.ttft_seen = True
            self._prefill_ewma = (ttft if self._prefill_ewma is None
                                  else 0.5 * self._prefill_ewma + 0.5 * ttft)

    def _select_preemption(self, pending, active, now, *, arrived_only):
        """The preemption policy of both drivers: the earliest-deadline queued
        request with a TTFT target (``arrived_only``: among those already
        arrived at ``now``, the next scheduling event in sim, the wall clock
        relative to the run's start in real mode), if it projects a miss
        (``now + prefill_estimate > deadline``), and the decode-phase victim
        with the farthest, strictly later deadline. Returns (urgent, victim)
        or None; the drivers own the mechanics."""
        urgent_pool = [r for r in pending if r.ttft_target is not None
                       and (not arrived_only or r.arrival <= now)]
        if not urgent_pool:
            return None
        urgent = min(urgent_pool,
                     key=lambda r: (_deadline(r), r.arrival, r.request_id))
        if max(urgent.arrival, now) + self._prefill_est <= _deadline(urgent):
            return None  # no projected miss
        victims = [a for a in active
                   if isinstance(a.op, ComputeOp) and a.op.phase == "decode"
                   and _deadline(a.request) > _deadline(urgent)]
        if not victims:
            return None
        v = max(victims, key=lambda a: (_deadline(a.request), a.admitted,
                                        a.request.request_id))
        return urgent, v

    def _run_sim(self, requests: List[Request]) -> List[CompletedRequest]:
        pending = sorted(requests, key=lambda r: (r.arrival, r.request_id))
        # free-time of each serving slot: a heap models "slot frees when the
        # plan occupying it finishes" without tracking identity
        slots = [0.0] * self.max_concurrency
        heapq.heapify(slots)
        active: List[_Active] = []
        preempted: List[_Active] = []
        done: List[CompletedRequest] = []
        while pending or active or preempted:
            self._resume_sim(preempted, active, slots)
            self._admit_sim(pending, active, slots, done)
            self._preempt_sim(pending, active, preempted, slots, done)
            if not active:
                continue
            a = min(active, key=lambda x: x.resume)
            batch = self._mixed_batch(a, active, slots, done)
            if batch is not None:
                self._step_sim_batch(batch, active, slots, done)
            else:
                self._step_sim(a, active, slots, done)
        done.sort(key=lambda c: c.request.request_id)
        return done

    def _finish_sim(self, a: _Active, t: float, slots, done, value):
        """Release `a`'s slot at time `t` and record the completion."""
        heapq.heappush(slots, t)
        self._observe_ttft(a)
        done.append(CompletedRequest(a.request, a.plan.trace, value,
                                     a.admitted, t,
                                     preemptions=a.preempt_count,
                                     swaps=a.swap_count))

    def _mixed_batch(self, a: _Active, active, slots, done) -> Optional[List[_Active]]:
        """Assemble one token-level batch iteration around plan `a`, or None.

        When the earliest runnable op is batchable (``op.tokens > 0``: a
        decode token or a chunk-granular prefill op), the iteration window
        is the op's own duration past the accelerator-free gate.  Peers
        blocked on I/O that completes inside the window are advanced first
        (their wait times are fixed by the handle, so resolving them early
        is time-faithful), then batchable ComputeOps runnable inside the
        window join in resume order, while the iteration stays within
        ``max_batch_tokens`` batch tokens.  The earliest plan always runs
        (even if alone it exceeds the budget — ops cannot split here).

        Join rule (asymmetric on purpose): a decode-led iteration streams
        the *whole model's* weights, so prefill chunks of any layer ride it
        for free (their layer's weight slice is a subset) — this is the
        token-level prefill/decode mixing.  A chunk-led iteration streams
        one layer's weights, so it only absorbs chunks with the *same*
        ``weight_key`` (concurrent prefills on the same layer); letting a
        decode token join would stretch the chunk from one layer's weight
        time to the full model's and wreck the leader's TTFT.

        Heterogeneous fleets: decode peers must share the leader's exact
        ``weight_key`` (two models never stream one weight read — a
        same-family decode key is ``"model@<name>"``), and prefill riders
        must at least share the leader's :func:`weight_stream` (same model)
        — the subset argument above only holds within one model's weights."""
        if not (self.batch_decode and isinstance(a.op, ComputeOp)
                and a.op.tokens > 0):
            return None
        chan = a.plan.clock.channel
        gate = max(a.resume, self.ex.free_at[chan])
        window = gate + self.ex.model.compute_time(a.op.flops, a.op.hbm_bytes)
        while True:
            waiting = [b for b in active
                       if b is not a and isinstance(b.op, WaitOp)
                       and b.resume <= window]
            if not waiting:
                break
            b = min(waiting, key=lambda x: x.resume)
            if b.held_op is not None and b.op.tag == "kv_handoff":
                self._release_handoff(b)
                continue
            b.plan.clock.t = b.resume
            send = resolve_handle(b.op.handle)
            try:
                b.op = b.plan.gen.send(send)
                b.resume = b.plan.resume_time(b.op)
                self._observe_ttft(b)
                self._maybe_handoff_sim(b)
            except StopIteration as stop:
                active.remove(b)
                self._finish_sim(b, b.plan.clock.t, slots, done, stop.value)
        def trim(cands, members, total):
            """Greedy token-budget selection in (leader, resume, id) order."""
            for b in cands:
                if (members and self.max_batch_tokens is not None
                        and total + b.op.tokens > self.max_batch_tokens):
                    continue  # a later, smaller op may still fit
                members.append(b)
                total += b.op.tokens
            return members, total

        # an iteration is one occupation of ONE worker's accelerator: under
        # a disaggregated topology only plans routed to the same channel may
        # coalesce (a colocated fleet has a single shared channel, so the
        # filter is vacuous there)
        same = lambda b: b.plan.clock.channel == chan
        order = lambda b: (b is not a, b.resume, b.request.request_id)
        if a.op.phase == "decode":
            decode_cands = sorted(
                (b for b in active
                 if isinstance(b.op, ComputeOp) and b.op.tokens > 0
                 and b.op.phase == "decode" and b.resume <= window
                 and b.op.weight_key == a.op.weight_key and same(b)),
                key=order)
            members, total = trim(decode_cands, [], 0)
            # prefill chunks ride only if already runnable at the iteration's
            # start (computed after the budget trim) — a rider must never
            # delay the decode iteration
            start = max(b.resume for b in members)
            riders = sorted(
                (b for b in active
                 if isinstance(b.op, ComputeOp) and b.op.tokens > 0
                 and b.op.phase == "prefill" and b.resume <= start
                 and weight_stream(b.op.weight_key)
                 == weight_stream(a.op.weight_key) and same(b)),
                key=order)
            members, _ = trim(riders, members, total)
            return members
        cands = sorted(
            (b for b in active
             if isinstance(b.op, ComputeOp) and b.op.tokens > 0
             and b.op.weight_key == a.op.weight_key and b.resume <= window
             and same(b)),
            key=order)
        members, _ = trim(cands, [], 0)
        return members

    def _step_sim_batch(self, members: List[_Active], active, slots, done):
        start = max(b.resume for b in members)
        phases = {b.op.phase for b in members}
        total = sum(b.op.tokens for b in members)
        items = []
        for b in members:
            op = b.op
            if (op.phase == "prefill" and op.fn is None
                    and op.weight_key.startswith("layer:")):
                # (weight_key-guarded: a sim hybrid *recompute* op also has
                # phase="prefill" and fn=None, but is a complete step in
                # itself — only layer-chunk streams drain.)
                # drain: pull the plan's consecutive chunks of this layer
                # into the same iteration while the token budget allows.
                # Non-final chunks carry fn=None (pure occupancy), so their
                # results are known and the generator can be advanced at
                # batch-formation time; the layer's final chunk (fn set)
                # stops the drain.  Merged pricing: FLOPs and KV re-reads
                # sum, the layer's weight stream is paid once.
                flops = op.flops
                kv = op.hbm_bytes - op.weight_bytes
                while (op.fn is None
                       and (self.max_batch_tokens is None
                            or total + op.tokens <= self.max_batch_tokens)):
                    nxt = b.plan.gen.send(None)
                    assert (isinstance(nxt, ComputeOp) and nxt.tokens > 0
                            and nxt.weight_key == op.weight_key), (
                        "an fn-less prefill chunk must be followed by its "
                        "layer's next chunk")
                    op = b.op = nxt
                    flops += op.flops
                    kv += op.hbm_bytes - op.weight_bytes
                    total += op.tokens
                items.append((op.fn, flops, op.weight_bytes + kv,
                              op.weight_bytes))
            else:
                items.append((op.fn, op.flops, op.hbm_bytes, op.weight_bytes))
        tag = members[0].op.tag if len(phases) == 1 else "mixed"
        self.batch_log.append(total)
        self.sim_batch_log.append(
            [(b.request.request_id, b.op.phase, b.op.weight_key)
             for b in members])
        outs, end = self.ex.compute_batch_at(
            items, tag=tag, at=start,
            channel=members[0].plan.clock.channel)
        for b, send in zip(members, outs):
            b.plan.clock.t = end
            try:
                b.op = b.plan.gen.send(send)
                b.resume = b.plan.resume_time(b.op)
                self._observe_ttft(b)
                self._maybe_handoff_sim(b)
            except StopIteration as stop:
                active.remove(b)
                self._finish_sim(b, end, slots, done, stop.value)

    def _start_plan(self, req: Request, start: float, active, slots, done):
        """Build and admit one plan starting at `start` (slot already held)."""
        eng = self.engines[req.tenant]
        plan = eng.plan(req.suffix, req.request_id, arrival=start,
                        decode_tokens=req.decode_tokens)
        replica = 0
        if self.replicas is not None:
            # least-backlogged admission across the whole fleet: pick the
            # (replica, prefill channel) pair with the fewest in-flight
            # plans, breaking ties by which channel frees earliest.  The
            # in-flight count matters for simultaneous arrivals — a plan
            # admitted at t spends its first legs on ssd/pcie, so free_at
            # alone would keep sending cohort-mates to the same replica
            load = {}
            for other in active:
                c = other.plan.clock.channel
                load[c] = load.get(c, 0) + 1
            replica, chan = min(
                ((r, c) for r in range(self.replicas.n_replicas)
                 for c in self.replicas.prefill_channels(r)),
                key=lambda rc: (load.get(rc[1], 0),
                                self.ex.free_at[rc[1]], rc[1]))
            plan.clock.channel = chan
            self.replica_admits[replica] += 1
        elif self.topology is not None:
            # route the prefill phase to the least-backlogged prefill
            # worker; the channel must be pinned before the generator's
            # first resume, which already prices ops against it
            plan.clock.channel = min(
                self.topology.prefill_channels,
                key=lambda c: (self.ex.free_at[c], c))
        a = _Active(req, plan, start)
        a.replica = replica
        try:
            a.op = plan.gen.send(None)
        except StopIteration as stop:  # degenerate plan with no ops
            self._finish_sim(a, start, slots, done, stop.value)
            return
        a.resume = plan.resume_time(a.op)
        self._maybe_handoff_sim(a)
        active.append(a)

    def _handoff_payload(self, a: _Active):
        """(bytes, tokens) of one prefill->decode KV handoff: the resident
        prefix units every decode step attends over, plus the suffix (and
        first-token) KV tail — i.e. everything the decode worker needs that
        only exists on the prefill worker.  `tokens` is the causal extent a
        decode-worker recompute would have to cover to rebuild the same KV."""
        eng = self.engines[a.request.tenant]
        if hasattr(eng, "handoff_payload"):
            # family-specific pricing (StateSpaceEngine: the recurrent state
            # + any hybrid attention KV, not prefix-store units)
            return eng.handoff_payload(a)
        layout = eng.session.store.layout
        sel = a.plan.trace.selected_per_layer
        max_unit = max((int(u) for us in sel.values() for u in us),
                       default=-1)
        prefix_tokens = min((max_unit + 1) * layout.unit_tokens,
                            eng.session.prefix_len)
        suffix_tokens = len(a.request.suffix)
        nbytes = (self._resident_bytes(a)
                  + suffix_tokens * layout.geom.token_bytes * layout.n_layers)
        return int(nbytes), int(prefix_tokens + suffix_tokens)

    def _maybe_handoff_sim(self, a: _Active):
        """Emit the ``kv_handoff`` WaitOp at the prefill->decode boundary.

        Fires once per plan, at the first op yielded after the generator
        stamped ``trace.ttft`` (prefill done, decode pending).  The pending
        op is parked on ``a.held_op`` behind a WaitOp whose handle is the
        transfer's completion on the interconnect FIFO — or, when the
        fleet's HybridPlanner prices a decode-worker recompute cheaper than
        pulling the bytes, an occupation of the decode worker's own compute
        channel.  Either way the plan's clock is re-routed to the chosen
        decode worker, so every decode-phase op runs there.

        Under a ReplicaSet the handoff stays *within* the owning replica
        (its topology is per-replica: the candidate decode channels are
        replica ``a.replica``'s own) — replicas without a per-replica
        topology never hand off, because each replica colocates both
        phases on its one channel.
        """
        topo = (self.replicas.topology if self.replicas is not None
                else self.topology)
        if (topo is None or a.handed_off
                or not getattr(a.plan.trace, "ttft", 0.0)):
            return
        a.handed_off = True
        self.handoffs += 1
        eng = self.engines[a.request.tenant]
        clock = a.plan.clock
        dst_channels = (self.replicas.decode_channels(a.replica)
                        if self.replicas is not None
                        else topo.decode_channels)
        dst = min(dst_channels,
                  key=lambda c: (self.ex.free_at[c], c))
        nbytes, tokens = self._handoff_payload(a)
        hp = getattr(eng, "hybrid", None)
        choice = "pull"
        if hp is not None and hp.mode != "off" and nbytes and tokens:
            choice, _, t_rec = hp.price_handoff(
                cfg=eng.cfg, nbytes=nbytes, tokens=tokens, executor=self.ex,
                dst_channel=dst, clock_t=clock.t)
        if choice == "recompute":
            cost = CM.chunk_recompute_cost(eng.cfg, tokens, 0)
            _, end = self.ex.compute_at(
                None, flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                tag="handoff_recompute", at=clock.t, channel=dst)
            handle = IOHandle(ready_at=end)
            self.handoff_recomputes += 1
            self.handoff_bytes_avoided += nbytes
        else:
            handle = self.ex.submit_io_at(
                None, nbytes=nbytes, n_requests=1, channel=INTERCONNECT,
                at=clock.t)
            self.handoff_bytes += nbytes
        a.held_op = a.op
        a.op = WaitOp(handle, tag="kv_handoff")
        clock.channel = dst
        a.resume = a.plan.resume_time(a.op)

    def _release_handoff(self, a: _Active):
        """The kv_handoff WaitOp completed: un-park the held decode op."""
        a.plan.clock.t = a.resume
        a.op = a.held_op
        a.held_op = None
        a.resume = a.plan.resume_time(a.op)

    def _admit_sim(self, pending, active, slots, done):
        while pending and len(active) < self.max_concurrency:
            slot_t = slots[0]
            horizon = min((a.resume for a in active), default=None)
            if horizon is None:
                # idle system: jump virtual time to the earliest start
                t0 = max(pending[0].arrival, slot_t)
                queued = [r for r in pending if r.arrival <= t0]
            else:
                # admit only what can start before the next scheduled event
                queued = [r for r in pending if max(r.arrival, slot_t) <= horizon]
                if not queued:
                    return
            req = self.policy.select(queued, self.engines)
            pending.remove(req)
            start = max(req.arrival, heapq.heappop(slots))
            self._start_plan(req, start, active, slots, done)

    def _preempt_sim(self, pending, active, preempted, slots, done):
        """SLO-driven preemption: evict a decode plan at its step boundary.

        Triggered when every slot is busy and the earliest-deadline queued
        request (among those already arrived) projects a TTFT miss:
        ``t_next + prefill_estimate > deadline``, where ``t_next`` is the
        next scheduling event and the estimate is the EWMA of completed
        prefill service times.  The victim is the decode-phase plan with
        the farthest deadline (strictly later than the urgent one); with
        ``swap_on_preempt`` its cache-resident units are swapped out over
        the PCIe channel and re-fetched on resume."""
        if not (self.preempt and pending and active
                and len(active) >= self.max_concurrency):
            return
        t_next = min(a.resume for a in active)
        sel = self._select_preemption(pending, active, t_next,
                                      arrived_only=True)
        if sel is None:
            return
        urgent, v = sel
        active.remove(v)
        v.preempt_count += 1
        self.preemptions += 1
        if self.swap_on_preempt:
            nbytes = self._resident_bytes(v)
            if nbytes:
                # swap-out occupies the PCIe channel from the victim's step
                # boundary; the compute slot itself frees immediately
                self.ex.submit_io_at(None, nbytes=nbytes, n_requests=1,
                                     channel="pcie", at=v.plan.clock.t)
                v.swapped_bytes = nbytes
                v.swap_count += 1
                self.swaps += 1
                self.swap_bytes += nbytes
        preempted.append(v)
        # the urgent request takes the victim's slot from the victim's step
        # boundary — no earlier, or the victim's just-finished op and the
        # urgent plan would transiently coexist in the same slot (the victim
        # holds no heap entry while preempted; it pops one on resume)
        pending.remove(urgent)
        self._start_plan(urgent, max(urgent.arrival, v.plan.clock.t), active,
                         slots, done)

    def _resume_sim(self, preempted, active, slots):
        """Resume preempted plans (FIFO) whenever a slot frees; swapped-out
        units are re-fetched over PCIe before the plan's next op can run."""
        while preempted and len(active) < self.max_concurrency:
            v = preempted.pop(0)
            slot_t = heapq.heappop(slots)
            t_r = max(v.plan.clock.t, slot_t)
            if v.swapped_bytes:
                h = self.ex.submit_io_at(None, nbytes=v.swapped_bytes,
                                         n_requests=1, channel="pcie", at=t_r)
                t_r = max(t_r, h.ready_at)
                self.swap_bytes += v.swapped_bytes
                v.swapped_bytes = 0
            v.plan.clock.t = t_r
            v.resume = v.plan.resume_time(v.op)
            active.append(v)

    def _resident_bytes(self, a: _Active) -> int:
        """Bytes of the plan's currently-selected units (the swap payload)."""
        eng = self.engines[a.request.tenant]
        if hasattr(eng, "swap_bytes_of"):
            return eng.swap_bytes_of(a)
        layout = eng.session.store.layout
        sel = a.plan.trace.selected_per_layer
        if a.plan.trace.decode_selected:
            per_layer = len(a.plan.trace.decode_selected[-1])
            n_units = per_layer * max(len(sel), 1)
        else:
            n_units = sum(len(u) for u in sel.values())
        return int(n_units) * int(layout.unit_bytes)

    def _step_sim(self, a: _Active, active, slots, done):
        clock = a.plan.clock
        op = a.op
        if isinstance(op, ComputeOp):
            out, end = self.ex.compute_at(op.fn, flops=op.flops,
                                          hbm_bytes=op.hbm_bytes, tag=op.tag,
                                          at=a.resume, channel=clock.channel)
            clock.t = end
            send = out
        else:
            if a.held_op is not None and op.tag == "kv_handoff":
                # scheduler-emitted wait: the generator never yielded it,
                # so un-park the held decode op instead of resuming the gen
                self._release_handoff(a)
                return
            clock.t = a.resume  # = max(clock, handle.ready_at)
            send = resolve_handle(op.handle)
        try:
            a.op = a.plan.gen.send(send)
            a.resume = a.plan.resume_time(a.op)
            self._observe_ttft(a)
            self._maybe_handoff_sim(a)
        except StopIteration as stop:
            active.remove(a)
            self._finish_sim(a, clock.t, slots, done, stop.value)

    # -- wall-clock driver ------------------------------------------------------
    def _finish_real(self, a: _Active, done, value):
        """Record one wall-clock completion."""
        self._observe_ttft(a)
        done.append(CompletedRequest(a.request, a.plan.trace, value,
                                     a.admitted, self.ex.now(),
                                     preemptions=a.preempt_count,
                                     swaps=a.swap_count))

    def _start_real(self, req: Request, active, done):
        """Build one plan and admit it into the wall-clock driver."""
        ex = self.ex
        eng = self.engines[req.tenant]
        plan = eng.plan(req.suffix, req.request_id,
                        decode_tokens=req.decode_tokens)
        plan.clock.t = ex.now()
        a = _Active(req, plan, plan.clock.t)
        if self.replicas is not None:
            # least-backlogged replica by active plan count
            load = [0] * self.replicas.n_replicas
            for b in active:
                load[b.replica] += 1
            a.replica = min(range(len(load)), key=lambda r: (load[r], r))
            self.replica_admits[a.replica] += 1
        try:
            a.op = plan.gen.send(None)
            self._maybe_handoff_real(a)
            active.append(a)
        except StopIteration as stop:
            self._finish_real(a, done, stop.value)

    def _maybe_handoff_real(self, a: _Active):
        """Prefill->decode handoff and decode-worker stamping.

        Fires at the plan's first decode op (the one carrying a
        :class:`DecodeBatchCtx`): its per-layer pools are moved to host
        memory and back (``swap_out`` / ``swap_in``: the two legs of a
        cross-worker transfer) and the plan is given a decode worker's
        backend, round-robin. Every later decode op's ``batch_ctx.backend``
        is restamped to it, so the batched pass and the standalone ``op.fn``
        path both run there, and the batch former groups plans by worker.
        Under a ReplicaSet the candidates are the owning replica's workers.
        """
        if self.replicas is not None and self.replicas.backends is not None:
            backends = self.replicas.backends[a.replica]
        elif (self.topology is not None
                and self.topology.decode_backends is not None):
            backends = self.topology.decode_backends
        else:
            return
        if (not isinstance(a.op, ComputeOp)
                or not isinstance(a.op.batch_ctx, DecodeBatchCtx)):
            return
        ctx = a.op.batch_ctx
        if not a.handed_off:
            a.handed_off = True
            self.handoffs += 1
            a.worker_backend = backends[self._rr_decode % len(backends)]
            self._rr_decode += 1
            out_bytes = sum(p.swap_out() for p in ctx.pools.values())
            in_bytes = sum(p.swap_in() for p in ctx.pools.values())
            self.handoff_bytes += out_bytes + in_bytes
        ctx.backend = a.worker_backend

    def _preempt_real(self, pending, active, preempted, t0: float, done):
        """SLO-driven preemption: when every slot is busy and the
        earliest-deadline queued request projects a TTFT miss, the
        decode-phase plan with the farthest deadline is preempted at its
        step boundary (its pending op is held: decode plans resume by
        construction). With ``swap_on_preempt`` its pools go to host memory
        (``pool.swap_out()``), freeing their device memory, and come back
        bit for bit on resume; both legs' bytes are counted."""
        if not (self.preempt and pending and active
                and len(active) >= self.max_concurrency):
            return
        sel = self._select_preemption(pending, active, self.ex.now() - t0,
                                      arrived_only=True)
        if sel is None:
            return
        urgent, v = sel
        active.remove(v)
        v.preempt_count += 1
        self.preemptions += 1
        if self.swap_on_preempt and v.op.batch_ctx is not None:
            nbytes = sum(pool.swap_out()
                         for pool in v.op.batch_ctx.pools.values())
            if nbytes:
                v.swapped_bytes = nbytes
                v.swap_count += 1
                self.swaps += 1
                self.swap_bytes += nbytes
        preempted.append(v)
        # the urgent request takes the freed slot at once
        pending.remove(urgent)
        self._start_real(urgent, active, done)

    def _resume_real(self, preempted, active):
        """Resume preempted plans (FIFO) whenever a slot frees; swapped-out
        pools return to device memory before the plan's next op runs."""
        while preempted and len(active) < self.max_concurrency:
            v = preempted.pop(0)
            if v.swapped_bytes:
                self.swap_bytes += sum(
                    pool.swap_in() for pool in v.op.batch_ctx.pools.values())
                v.swapped_bytes = 0
            active.append(v)

    def _form_batch(self, cands: List[_Active], key) -> Optional[List[_Active]]:
        """One batch out of ``cands``, or None. Candidates are grouped by
        ``key(a)`` and aged by the last iteration they batched in
        (``batch_stamp``), oldest first, when choosing among groups and when
        trimming to ``max_batch_tokens``, so a plan left out now joins next
        time. Fewer than two members return None: a lone op runs the
        standalone ``op.fn`` path, which keeps concurrency 1 bit-identical to
        ``drive_serial``."""
        if not self.batch_decode or len(cands) < 2:
            return None
        cands.sort(key=lambda a: (a.batch_stamp, a.request.request_id))
        groups: Dict[tuple, List[_Active]] = {}
        for a in cands:
            groups.setdefault(key(a), []).append(a)
        # the group holding the longest-waiting candidate wins; size breaks ties
        members = min(groups.values(),
                      key=lambda g: (g[0].batch_stamp, -len(g),
                                     g[0].request.request_id))
        if self.max_batch_tokens is not None:
            budget, trimmed = 0, []
            for a in members:
                if budget + a.op.tokens > self.max_batch_tokens:
                    break
                trimmed.append(a)
                budget += a.op.tokens
            members = trimmed
        return members if len(members) >= 2 else None

    def _real_decode_batch(self, active: List[_Active]) -> Optional[List[_Active]]:
        """Assemble one batched decode iteration, or None.

        Candidates are active plans whose pending op is a decode-phase
        ComputeOp with a :class:`DecodeBatchCtx` (real decode steps are
        always runnable). Members share one backend, one pool residency and
        one weight stream (one model's weights stream once for the whole
        batch)."""
        cands = [a for a in active
                 if isinstance(a.op, ComputeOp) and a.op.phase == "decode"
                 and a.op.batch_ctx is not None]
        return self._form_batch(cands, lambda a: (
            id(a.op.batch_ctx.backend), bool(a.op.batch_ctx.pools[0].is_device),
            a.op.weight_key))

    def _real_chunk_batch(self, active: List[_Active]) -> Optional[List[_Active]]:
        """Assemble one batched prefill-chunk pass, or None: runnable final
        chunk ops of chunked part-B layers (those carrying a
        :class:`PrefillChunkCtx`) of different plans, sharing a backend, the
        layer and identical shapes (``shape_key()``), since the batched pass
        runs each member's part B at its own shape; one ``part_b_batch``
        call streams the layer's weights once for all of them."""
        cands = [a for a in active
                 if isinstance(a.op, ComputeOp) and a.op.phase == "prefill"
                 and isinstance(a.op.batch_ctx, PrefillChunkCtx)]
        return self._form_batch(cands, lambda a: (id(a.op.batch_ctx.backend),
                                                  a.op.batch_ctx.shape_key()))

    def _step_real_batch(self, members: List[_Active], active, done):
        """One batched pass for ``members`` (one backend): a decode step
        (``decode_step_batch``) or same-layer final prefill chunks
        (``part_b_batch``), by the kind of their ops' ``batch_ctx``."""
        ex = self.ex
        ctxs = [a.op.batch_ctx for a in members]
        be = ctxs[0].backend
        if isinstance(ctxs[0], PrefillChunkCtx):
            run, tag = be.part_b_batch, f"prefill_chunk[x{len(members)}]"
        else:
            run, tag = be.decode_step_batch, f"decode[x{len(members)}]"
        flops = sum(a.op.flops for a in members)
        weight = max(a.op.weight_bytes for a in members)
        hbm = weight + sum(a.op.hbm_bytes - a.op.weight_bytes for a in members)
        outs = ex.compute(lambda: run(ctxs), flops=flops, hbm_bytes=hbm, tag=tag)
        stamp = len(self.real_batch_log)
        for a in members:
            a.batch_stamp = stamp
        self.batch_log.append(sum(a.op.tokens for a in members))
        self.real_batch_log.append(
            [(a.request.request_id, a.op.phase, a.op.weight_key)
             for a in members])
        for a, send in zip(members, outs):
            a.plan.clock.t = ex.now()
            try:
                a.op = a.plan.gen.send(send)
                self._observe_ttft(a)
                self._maybe_handoff_real(a)
            except StopIteration as stop:
                active.remove(a)
                self._finish_real(a, done, stop.value)

    def _run_real(self, requests: List[Request]) -> List[CompletedRequest]:
        ex = self.ex
        pending = sorted(requests, key=lambda r: (r.arrival, r.request_id))
        active: List[_Active] = []
        preempted: List[_Active] = []
        done: List[CompletedRequest] = []
        t0 = ex.now()
        while pending or active or preempted:
            self._resume_real(preempted, active)
            # arrival-aware admission: only requests whose offset has passed
            # on the wall clock enter
            while pending and len(active) < self.max_concurrency:
                arrived = [r for r in pending
                           if r.arrival <= ex.now() - t0]
                if not arrived:
                    break
                req = self.policy.select(arrived, self.engines)
                pending.remove(req)
                self._start_real(req, active, done)
            self._preempt_real(pending, active, preempted, t0, done)
            progressed = False
            # iteration-level batching: coalesce runnable decode steps into
            # one pass; prefill and IO ops keep the round-robin below.
            # Candidates left out of this iteration's batch stay runnable and
            # are skipped this pass, so no plan advances twice an iteration.
            members = self._real_decode_batch(active)
            skip = set()
            if members is not None:
                self._step_real_batch(members, active, done)
                progressed = True
                skip = {id(a) for a in active
                        if isinstance(a.op, ComputeOp)
                        and a.op.phase == "decode"
                        and a.op.batch_ctx is not None}
            # same-layer final prefill chunks (disjoint from the decode
            # batch: another phase, so no plan is in both)
            chunk_members = self._real_chunk_batch(active)
            if chunk_members is not None:
                self._step_real_batch(chunk_members, active, done)
                progressed = True
                skip |= {id(a) for a in active
                         if isinstance(a.op, ComputeOp)
                         and a.op.phase == "prefill"
                         and isinstance(a.op.batch_ctx, PrefillChunkCtx)}
            for a in list(active):
                if id(a) in skip:
                    continue
                op = a.op
                if isinstance(op, WaitOp):
                    f = op.handle.future
                    if f is not None and not f.done():
                        continue  # not ready: let another plan use the window
                    send = resolve_handle(op.handle)
                else:
                    send = ex.compute(op.fn, flops=op.flops,
                                      hbm_bytes=op.hbm_bytes, tag=op.tag)
                a.plan.clock.t = ex.now()
                progressed = True
                try:
                    a.op = a.plan.gen.send(send)
                    self._observe_ttft(a)
                    self._maybe_handoff_real(a)
                except StopIteration as stop:
                    active.remove(a)
                    self._finish_real(a, done, stop.value)
            if not progressed and active:
                # every plan is blocked on a pending future: sleep on the I/O
                futs = [a.op.handle.future for a in active
                        if isinstance(a.op, WaitOp) and a.op.handle.future is not None]
                futures_wait(futs, return_when=FIRST_COMPLETED)
            elif not progressed and pending:
                # idle, all remaining traffic in the future: sleep through the gap
                gap = min(r.arrival for r in pending) - (ex.now() - t0)
                if gap > 0:
                    time.sleep(gap)
        done.sort(key=lambda c: c.request.request_id)
        return done


# ---------------------------------------------------------------------------
# summary helpers
# ---------------------------------------------------------------------------
def summarize(completed: Sequence[CompletedRequest]) -> Dict[str, float]:
    """Latency/goodput digest of one serving run.

    Decode-phase metrics (mean TPOT, P50/P95 inter-token latency, decode
    token throughput) appear whenever any completed request generated
    tokens past the first."""
    if not completed:
        return {"n": 0}
    ttfts = np.array([c.ttft for c in completed])
    arrivals = np.array([c.request.arrival for c in completed])
    finishes = np.array([c.finish for c in completed])
    makespan = float(finishes.max() - arrivals.min())
    out = {
        "n": len(completed),
        "p50_ttft": float(np.percentile(ttfts, 50)),
        "p95_ttft": float(np.percentile(ttfts, 95)),
        "mean_ttft": float(ttfts.mean()),
        "max_ttft": float(ttfts.max()),
        "makespan": makespan,
        "goodput_rps": len(completed) / max(makespan, 1e-12),
        "mean_queue_delay": float(np.mean([c.queue_delay for c in completed])),
    }
    itls = [c.trace.inter_token_latencies() for c in completed
            if getattr(c.trace, "decode_times", None)]
    if itls:
        all_itl = np.concatenate(itls)
        tpots = [c.trace.tpot for c in completed if c.trace.decode_times]
        n_tokens = int(sum(len(x) for x in itls))
        out.update({
            "decode_tokens": n_tokens,
            "mean_tpot": float(np.mean(tpots)),
            "p50_itl": float(np.percentile(all_itl, 50)),
            "p95_itl": float(np.percentile(all_itl, 95)),
            "decode_tok_rate": n_tokens / max(makespan, 1e-12),
        })
    slo = [c.slo_met for c in completed if c.slo_met is not None]
    if slo:
        out["slo_attainment"] = float(np.mean(slo))
    out["preemptions"] = int(sum(getattr(c, "preemptions", 0) for c in completed))
    out["swaps"] = int(sum(getattr(c, "swaps", 0) for c in completed))
    return out
