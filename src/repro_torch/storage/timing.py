"""Clock + executor abstraction: one engine, two backends.

The Re-Prefill engine issues the *same* sequence of I/O submissions, waits and
compute calls in both modes:

  RealExecutor — thread-pool async I/O over a file-backed store, wall clock,
                 compute = actually calling the function.
  SimExecutor  — discrete-event timeline with separate resources (SSD channel,
                 PCIe channel, accelerator), virtual clock; compute advances
                 the accelerator timeline by a cost-model duration.

This is how a CPU-only container reproduces the paper's latency experiments:
the engine's real decision sequence (what to load, when, what overlaps) drives
the simulator; only durations come from a calibrated device model.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class DeviceModel:
    """Calibrated constants. Defaults = the paper's testbed (§5.1)."""

    ssd_bandwidth: float = 7.45e9  # B/s sequential read
    ssd_latency: float = 80e-6  # submit-batch latency (one async queue dispatch)
    ssd_iops: float = 600e3  # sustained 4K random-read IOPS at high queue depth
    ssd_page: int = 4096  # minimum read granularity
    pcie_bandwidth: float = 32e9 / 2  # B/s one direction (32 GB/s bidirectional)
    pcie_latency: float = 10e-6
    compute_flops: float = 197e12  # bf16 peak (TPU v5e) — or 312e12 for A800
    compute_efficiency: float = 0.45  # sustained fraction for attention-ish work
    hbm_bandwidth: float = 819e9  # B/s
    # prefill->decode KV-transfer link of a disaggregated fleet (NVLink /
    # ICI class, markedly faster than the host PCIe path but not free)
    interconnect_bandwidth: float = 64e9  # B/s one direction
    interconnect_latency: float = 10e-6

    def ssd_read_time(self, nbytes: int, n_requests: int = 1) -> float:
        """Time to read `nbytes` issued as `n_requests` discrete IO requests.

        Async-I/O model: requests pipeline, so a batch costs ONE dispatch
        latency (`ssd_latency`, paid once per call regardless of
        `n_requests`) plus max(bandwidth-bound, IOPS-bound) service time.
        Serialized per-request latency would contradict how IMPRESS/FlexGen
        issue I/O (io_uring-style queues) and the paper's Challenge-1
        framing.

        Semantics callers rely on (pinned by tests/test_storage.py):

        - `nbytes` rounds UP to whole `ssd_page` pages (a partial page
          reads the full page — read amplification lives here);
        - `n_requests` enters only the IOPS term `n_requests / ssd_iops`:
          splitting the same bytes into more requests never reads faster,
          and once `n_requests > pages * ssd_page * iops / bandwidth` the
          transfer flips from bandwidth-bound to IOPS-bound (the scattered
          small-read regime granularity alignment exists to avoid);
        - one coalesced call is therefore never slower than two calls over
          a split of the same requests, since the fixed latency is paid
          per *batch*, not per request.
        """
        pages = max(1, -(-nbytes // self.ssd_page))
        service = max(pages * self.ssd_page / self.ssd_bandwidth,
                      n_requests / self.ssd_iops)
        return self.ssd_latency + service

    def pcie_time(self, nbytes: int) -> float:
        return self.pcie_latency + nbytes / self.pcie_bandwidth

    def interconnect_time(self, nbytes: int) -> float:
        """One KV-handoff transfer over the worker-to-worker link."""
        return self.interconnect_latency + nbytes / self.interconnect_bandwidth

    def compute_time(self, flops: float, hbm_bytes: float = 0.0) -> float:
        t_flops = flops / (self.compute_flops * self.compute_efficiency)
        t_mem = hbm_bytes / self.hbm_bandwidth
        return max(t_flops, t_mem)

    @classmethod
    def h100_sxm5(cls) -> "DeviceModel":
        """The H100 SXM5 80GB card of this port's chip runs, in data-sheet
        values: none of them is measured or calibrated on the card yet.

        The default stays the paper's testbed with the JAX package's TPU v5e
        compute and HBM constants, so sim timelines keep equal to the JAX
        package's; this preset is for pricing the card (``ChannelSim(
        DeviceModel.h100_sxm5())``). Sources, all NVIDIA data sheets:

        - ``compute_flops`` 989e12: H100 SXM5 dense bfloat16 tensor-core peak
          (1979 TFLOP/s with 2:4 sparsity); ``compute_efficiency`` keeps the
          default's 0.45, a modelling assumption, not a card figure;
        - ``hbm_bandwidth`` 3.35e12 B/s: H100 SXM5 80GB HBM3;
        - ``pcie_bandwidth`` 64e9 B/s: the host link, PCIe Gen5 x16, nominal
          per direction (128 GB/s both ways); latency as the default;
        - ``interconnect_bandwidth`` 450e9 B/s: fourth-generation NVLink,
          900 GB/s both ways, nominal per direction; latency as the default.

        The SSD constants are the default's (the paper's testbed) and are
        not measured on the card's machine."""
        return cls(compute_flops=989e12, hbm_bandwidth=3.35e12, pcie_bandwidth=64e9,
                   interconnect_bandwidth=450e9)


class IOHandle:
    """Completion handle; `.ready_at` (sim) or `.future` (real)."""

    def __init__(self, ready_at: float = 0.0, future: Optional[Future] = None):
        self.ready_at = ready_at
        self.future = future
        self.result = None

    def done_result(self):
        if self.future is not None:
            self.result = self.future.result()
        return self.result


class BaseExecutor:
    def now(self) -> float:
        raise NotImplementedError

    def submit_io(self, fn: Callable, *, nbytes: int, n_requests: int,
                  channel: str) -> IOHandle:
        raise NotImplementedError

    def wait(self, handle: IOHandle):
        raise NotImplementedError

    def compute(self, fn: Optional[Callable], *, flops: float = 0.0,
                hbm_bytes: float = 0.0, tag: str = ""):
        raise NotImplementedError


class RealExecutor(BaseExecutor):
    """Wall-clock execution with a thread pool for async I/O."""

    def __init__(self, n_io_threads: int = 4):
        self.pool = ThreadPoolExecutor(max_workers=n_io_threads)
        self._t0 = time.perf_counter()
        self.compute_busy = 0.0
        self.stage_times: Dict[str, float] = {}

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def submit_io(self, fn, *, nbytes, n_requests, channel) -> IOHandle:
        return IOHandle(future=self.pool.submit(fn))

    def wait(self, handle: IOHandle):
        handle.done_result()

    def compute(self, fn, *, flops=0.0, hbm_bytes=0.0, tag=""):
        t0 = time.perf_counter()
        out = fn() if fn is not None else None
        dt = time.perf_counter() - t0
        self.compute_busy += dt
        self.stage_times[tag] = self.stage_times.get(tag, 0.0) + dt
        return out

    def shutdown(self):
        self.pool.shutdown(wait=True)


class ChannelSim(BaseExecutor):
    """Multi-request discrete-event core: shared FIFO channels, no global clock.

    Channels: "ssd" (SSD->host), "pcie" (host->device), "compute" (the
    accelerator). Each is a serialized FIFO resource shared by every in-flight
    request. There is deliberately *no* ``t_now`` here — each request carries
    its own clock (``repro_torch.core.stepplan.RequestClock``) and passes it as the
    earliest-start time (``at=``) of every occupancy, so concurrent requests
    queue behind each other on the channels instead of behind a single
    control point. A scheduler that always advances the request with the
    smallest clock gets near-global FIFO ordering.

    The legacy single-request API (``submit_io``/``wait``/``compute`` driven
    by one implicit clock) lives in the :class:`SimExecutor` subclass below.
    """

    def __init__(self, model: DeviceModel):
        self.model = model
        self.free_at: Dict[str, float] = {"ssd": 0.0, "pcie": 0.0, "compute": 0.0}
        self.busy: Dict[str, float] = {"ssd": 0.0, "pcie": 0.0, "compute": 0.0}
        self.stage_times: Dict[str, float] = {}
        self.events: List[tuple] = []  # (start, end, resource, tag)

    def add_channel(self, name: str):
        """Register one more FIFO resource (idempotent).

        A disaggregated topology adds per-worker compute channels
        ("compute:p0", "compute:d1", ...) plus one "interconnect" channel
        for prefill->decode KV handoffs; the base trio stays untouched so
        colocated timelines are bit-identical with or without extra
        channels registered.
        """
        self.free_at.setdefault(name, 0.0)
        self.busy.setdefault(name, 0.0)

    def _occupy(self, resource: str, duration: float, tag: str,
                earliest: float) -> float:
        start = max(self.free_at[resource], earliest)
        end = start + duration
        self.free_at[resource] = end
        self.busy[resource] += duration
        self.events.append((start, end, resource, tag))
        return end

    def io_duration(self, nbytes: int, n_requests: int, channel: str) -> float:
        if channel == "ssd":
            return self.model.ssd_read_time(nbytes, n_requests)
        if channel == "interconnect":
            return self.model.interconnect_time(nbytes)
        return self.model.pcie_time(nbytes)

    def submit_io_at(self, fn, *, nbytes, n_requests, channel, at: float,
                     after: Optional[IOHandle] = None) -> IOHandle:
        """Enqueue a transfer on `channel` no earlier than `at`.

        `after` chains legs of a staged transfer (SSD leg -> PCIe leg): the
        downstream channel is occupied no earlier than the upstream leg's
        completion (bytes cannot cross PCIe before they exist in host
        memory), so a chained leg queues later requests on its channel
        behind the *real* transfer window, and carries the upstream payload
        through.
        """
        dur = self.io_duration(nbytes, n_requests, channel)
        if after is not None:
            at = max(at, after.ready_at)
        end = self._occupy(channel, dur, f"io:{channel}", at)
        h = IOHandle(ready_at=end)
        if after is not None:
            h.result = after.result
        if fn is not None:
            h.result = fn()  # execute side-effect immediately (bookkeeping only)
        return h

    def compute_at(self, fn, *, flops=0.0, hbm_bytes=0.0, tag="",
                   at: float = 0.0, channel: str = "compute"):
        """Occupy one accelerator channel from `at`; returns (result, end).

        `channel` selects which accelerator — the shared "compute" channel
        by default, a per-worker channel under a disaggregated topology.
        """
        dur = self.model.compute_time(flops, hbm_bytes)
        end = self._occupy(channel, dur, f"compute:{tag}", at)
        self.stage_times[tag] = self.stage_times.get(tag, 0.0) + dur
        return (fn() if fn is not None else None), end

    def compute_batch_at(self, items, *, tag="decode", at: float = 0.0,
                         channel: str = "compute"):
        """One batched accelerator occupation for several requests' ops.

        `items` is a list of (fn, flops, hbm_bytes, weight_bytes) — vLLM-style
        token batching: FLOPs and per-request memory traffic add up, but the
        weight stream (`weight_bytes`, included in each op's `hbm_bytes`) is
        paid once for the whole batch.  A single-item batch is priced exactly
        like `compute_at`, so batching degenerates to the serial timeline at
        concurrency 1.  Returns ([result, ...], end_time).

        Per-item residuals clamp at zero: an op whose ``hbm_bytes`` excludes
        part of the shared weight stream must not *discount* other members'
        traffic below what they would pay alone.
        """
        flops = sum(it[1] for it in items)
        weight = max((it[3] for it in items), default=0.0)
        hbm = weight + sum(max(0.0, it[2] - it[3]) for it in items)
        dur = self.model.compute_time(flops, hbm)
        label = f"compute:{tag}" + (f"[x{len(items)}]" if len(items) > 1 else "")
        end = self._occupy(channel, dur, label, at)
        self.stage_times[tag] = self.stage_times.get(tag, 0.0) + dur
        return [(it[0]() if it[0] is not None else None) for it in items], end


class SimExecutor(ChannelSim):
    """Single-request wrapper over :class:`ChannelSim` (legacy serial API).

    ``t_now`` tracks the one request's control point exactly as before the
    multi-request refactor; all timings are bit-identical to the historical
    SimExecutor, so existing benchmarks reproduce.
    """

    def __init__(self, model: DeviceModel):
        super().__init__(model)
        self.t_now = 0.0

    def now(self) -> float:
        return self.t_now

    def submit_io(self, fn, *, nbytes, n_requests, channel) -> IOHandle:
        return self.submit_io_at(fn, nbytes=nbytes, n_requests=n_requests,
                                 channel=channel, at=self.t_now)

    def wait(self, handle: IOHandle):
        self.t_now = max(self.t_now, handle.ready_at)

    def compute(self, fn, *, flops=0.0, hbm_bytes=0.0, tag=""):
        out, end = self.compute_at(fn, flops=flops, hbm_bytes=hbm_bytes,
                                   tag=tag, at=self.t_now)
        self.t_now = end
        return out
