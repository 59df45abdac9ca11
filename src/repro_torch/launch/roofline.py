"""Roofline analyzer of a step as it runs: the port's counterpart of the JAX
package's analyzer over compiled SPMD HLO (``src/repro/launch/roofline.py``).

The port has no HLO. :class:`StepAnalyzer` is a ``TorchDispatchMode`` that
sees every aten op a step runs, forward and backward, on meta or CUDA
tensors, and fills a :class:`Metrics` with the reference's fields:

  - ``flops``: the products of the aten ops, by the formulas of
    ``torch.utils.flop_counter`` (mm, bmm, addmm, baddbmm, convolution and
    the rest it knows), plus the hand-written kernels' products
    (``kernels/work.py``'s ``kernel_work``, which the wrappers report to
    the active analyzer, a :class:`~repro_torch.kernels.work.Recorder`);
  - ``hbm_bytes``: every op's tensor operands plus its outputs (the
    reference's "every top-level instruction" proxy); views move nothing
    and count nothing;
  - ``hbm_bytes_min``: the same for the aten counterparts of the
    reference's ``_ESSENTIAL_OPS`` alone (products, reductions, gather and
    index, scatter, cat, copy, sort, pad), the gathering ops counting only
    what they output, as ``_OUTPUT_ONLY_OPS`` does; a kernel's bytes count
    in both;
  - collective wire bytes per device with the reference's names and ring
    factors, split by group size. A process that drives every device of a
    mesh copies shards with plain tensor ops, so the mesh operations declare
    their collectives from the shardings (:func:`collective`): the weight
    gathers as all-gathers and their backward as reduce-scatters, the
    row-parallel sums as all-reduces (``launch/tp_compute.py``), the
    sharded sparse decode step's combine as an all-reduce
    (``launch/sharded_sparse.py``). A gather's copies count as the ops they
    are; a join's own sums run under :func:`uncounted` (they are its
    collective's work) and add only the declared wire bytes;
  - the peak of the live bytes the step allocated (``peak_bytes``), op by
    op, from the storages' lifetimes.

Repeat counts: the reference multiplies a ``while`` body by its trip count.
The port's layers are eager Python loops and are counted as they run. The
mesh steps' loops over data-parallel parts and microbatches and over tensor
shards, and AdamW's over mesh positions, run through :func:`loop`: under an
analyzer that samples loops (the default) only the first item runs, counted
as many times as there are items; without sampling every item runs. The two
counts agree where the items do the same work, and sampling keeps a
256-position production cell countable in seconds. The backward of an op a
loop item ran is counted at that item's scale: the analyzer keeps the range
of autograd sequence numbers each item's forward created and looks the
running backward node up in it; a layer recomputed under remat
(:func:`recomputed`) counts at the scale of the loops it runs through
again.

Per device: ``metrics`` holds one device's share, ``whole`` the whole step
as the process runs it. An op outside a loop is one device's work (the
process runs it on the step's home device); an item of a loop over parts
spread on n devices is 1/n of a device's work each. A collective's wire
bytes are per device by the ring model, and ``whole`` counts them on every
device that takes part.

:class:`Hardware` prices it all at the H100 SXM's published peaks.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, Iterable, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.work import Recorder, active, kernel_work

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

aten = torch.ops.aten
# the autograd node running a backward on this thread (None in a forward),
# and the sequence number the next node made on this thread will take
_current_node = getattr(torch._C, "_current_autograd_node", None)
_next_seq_nr = getattr(torch._C._autograd, "_get_sequence_nr", None)


def in_backward() -> bool:
    return _current_node is not None and _current_node() is not None


def _packets(*names):
    """The aten op packets of ``names`` this torch has."""
    return frozenset(getattr(aten, n) for n in names if hasattr(aten, n))


# the aten counterparts of the reference's _ESSENTIAL_OPS: traffic that
# survives perfect fusion (products, reductions, data movement)
_ESSENTIAL_OPS = _packets(*(
    # dot, convolution
    "mm", "addmm", "bmm", "baddbmm", "_scaled_mm", "convolution", "_convolution",
    "convolution_backward",
    # reduce, reduce-window
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "var",
    "var_mean", "std", "linalg_vector_norm", "logsumexp", "cumsum", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "nll_loss_forward", "nll_loss_backward",
    # gather, dynamic-slice
    "gather", "index", "index_select", "embedding", "take",
    # scatter, dynamic-update-slice
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "index_put",
    "index_put_", "_index_put_impl_", "index_add", "index_add_", "index_copy",
    "index_copy_", "embedding_dense_backward", "select_backward", "slice_backward",
    # sort, copy, concatenate, pad
    "sort", "topk", "copy", "copy_", "clone", "cat", "constant_pad_nd",
))
# ops that only read what they output (gathers): counting their whole
# operand would charge a gather from a table with the table
_OUTPUT_ONLY_OPS = _packets("gather", "index", "index_select", "embedding", "take")
# ops that allocate without writing, or move nothing
_NO_TRAFFIC_OPS = _packets("empty", "empty_like", "empty_strided", "new_empty",
                           "new_empty_strided", "detach", "alias", "lift_fresh")


@dataclasses.dataclass
class Metrics:
    flops: float = 0.0
    hbm_bytes: float = 0.0  # upper bound: every op's I/O
    hbm_bytes_min: float = 0.0  # perfect-fusion bound: products, reductions, data movement
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_group: Dict[int, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Metrics", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.hbm_bytes_min += other.hbm_bytes_min * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_by_group.items():
            self.coll_by_group[k] = self.coll_by_group.get(k, 0.0) + v * mult

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


# --------------------------------------------------------------------------
# the analyzer
# --------------------------------------------------------------------------
def _tensors(x):
    """The tensors of an op's arguments or outputs (nested lists, tuples
    and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepAnalyzer(Recorder):
    """Counts what a step runs (see the module docstring).

    ``metrics``: one device's :class:`Metrics`; ``whole``: the whole step's;
    ``aten_flops``: the aten products alone (per device); ``kernels``:
    {kernel: {"calls", "products", "bytes", "exponentials"}} per device;
    ``launches``: {(kernel, variant): calls} as the process made them,
    unscaled; ``peak_bytes``: the most bytes the step's own allocations held
    at once; ``item_peak_bytes``: the most one item of a :func:`loop` added
    over what was live when it began. ``sample_loops`` as :func:`loop`
    reads it."""

    def __init__(self, *, sample_loops: bool = True):
        super().__init__()
        self.sample_loops = sample_loops
        self.metrics, self.whole = Metrics(), Metrics()
        self.aten_flops = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.launches: Dict[Tuple[str, str], int] = {}
        self.live_bytes = self.peak_bytes = self.item_peak_bytes = 0
        self._mult = (1.0, 1.0)  # (device, whole)
        self._items = []  # [live bytes at the item's start, its peak], innermost last
        # closed forward scales: their first sequence numbers (sorted) and
        # (start, end, (device, whole)) a scale, in the same order
        self._span_starts, self._spans = [], []
        self._quiet = 0  # open uncounted() blocks
        self._replay = 0  # open recomputed() blocks inside a backward
        self._storages: Dict[int, weakref.ref] = {}
        # a CUDA backward runs on autograd's device thread, and a storage's
        # last reference may drop on either thread
        self._lock = threading.RLock()

    @contextlib.contextmanager
    def scaled(self, device: float, whole: float):
        """Work inside counts ``device`` times on a device and ``whole``
        times in the whole step (nested scales multiply)."""
        saved = self._mult
        self._mult = (saved[0] * device, saved[1] * whole)
        self._items.append([self.live_bytes, 0])
        start = None if _next_seq_nr is None or in_backward() else _next_seq_nr()
        try:
            yield
        finally:
            if start is not None:
                i = bisect.bisect_right(self._span_starts, start)
                self._span_starts.insert(i, start)
                self._spans.insert(i, (start, _next_seq_nr(), self._mult))
            self._mult = saved
            self.item_peak_bytes = max(self.item_peak_bytes, self._items.pop()[1])

    def _scale(self):
        """(device, whole) multipliers of the op running now: in a backward
        (outside a recomputed layer) those of the innermost scale whose
        forward made the running node, else the open scales'."""
        if self._replay or not self._spans or not in_backward():
            return self._mult
        seq = _current_node()._sequence_nr()
        i = bisect.bisect_right(self._span_starts, seq)
        while i:  # the innermost containing span starts last among those that do
            i -= 1
            start, end, mult = self._spans[i]
            if seq < end:
                return mult
        return self._mult

    # -- recording -----------------------------------------------------------
    def _add(self, flops: float, nbytes: float, min_bytes: float):
        if self._quiet:
            return
        dev, whole = self._scale()
        with self._lock:
            for m, k in ((self.metrics, dev), (self.whole, whole)):
                m.flops += flops * k
                m.hbm_bytes += nbytes * k
                m.hbm_bytes_min += min_bytes * k

    def add_kernel(self, name: str, variant: str, **shapes):
        """One call of hand-written kernel ``name`` (a CUDA launch or a meta
        route's would-be launch) at ``shapes`` (:func:`kernel_work`),
        recorded in ``launches`` under its variant: the wrappers' own
        counters count only what launched."""
        work = kernel_work(name, **shapes)
        self._add(work.products, work.bytes, work.bytes)
        k = self._scale()[0]
        with self._lock:
            row = self.kernels.setdefault(name, dict(calls=0.0, products=0.0, bytes=0.0,
                                                     exponentials=0.0))
            row["calls"] += k
            row["products"] += work.products * k
            row["bytes"] += work.bytes * k
            row["exponentials"] += work.exponentials * k
            self.launches[name, variant] = self.launches.get((name, variant), 0) + 1

    def add_collective(self, op: str, size: float, group: int, devices: int = 1):
        """One collective on each of ``devices`` devices, of ``size`` bytes
        as the reference's HLO types it (an all-gather's output, a
        reduce-scatter's shard after the scatter, an all-reduce's buffer),
        over groups of ``group`` devices: wire bytes by the ring model."""
        if op not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective {op!r}")
        g = group
        if op == "all-gather":
            wire = size * (g - 1) / max(g, 1)
        elif op == "all-reduce":
            wire = 2.0 * size * (g - 1) / max(g, 1)
        elif op == "reduce-scatter":
            wire = size * (g - 1)
        elif op == "all-to-all":
            wire = size * (g - 1) / max(g, 1)
        else:  # collective-permute
            wire, g = size, 2
        if wire <= 0:
            return
        dev, whole = self._scale()
        with self._lock:
            for m, k in ((self.metrics, dev), (self.whole, whole * devices)):
                m.coll_bytes[op] = m.coll_bytes.get(op, 0.0) + wire * k
                m.coll_by_group[g] = m.coll_by_group.get(g, 0.0) + wire * k

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            with self._lock:
                if key in self._storages:
                    continue
                n = st.nbytes()
                self._storages[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                for item in self._items:
                    item[1] = max(item[1], self.live_bytes - item[0])

    def _free(self, key: int, n: int):
        with self._lock:
            if self._storages.pop(key, None) is not None:
                self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry and not self._quiet:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            with self._lock:
                self.aten_flops += flops * self._scale()[0]
        mutates = func._schema.is_mutable
        if func.is_view or packet in _NO_TRAFFIC_OPS:
            nbytes = 0
        elif packet in _OUTPUT_ONLY_OPS:
            nbytes = 2 * sum(_nbytes(t) for t in _tensors(out))
        else:  # an op writing in place counts its target once
            nbytes = (sum(_nbytes(t) for t in _tensors(args))
                      + sum(_nbytes(t) for t in _tensors(kwargs))
                      + (0 if mutates else sum(_nbytes(t) for t in _tensors(out))))
        self._add(flops, nbytes, nbytes if packet in _ESSENTIAL_OPS else 0)
        if not (func.is_view or mutates):  # a new allocation
            self._track(out)
        return out


# --------------------------------------------------------------------------
# what the mesh code calls
# --------------------------------------------------------------------------
def loop(items: Iterable, *, per_device: float = 1.0):
    """The items of a step's repeated loop, each run under the active
    analyzer's scale: without an analyzer every item, as it is; under one
    that samples loops only the first, whose work counts ``len(items) *
    per_device`` times on a device and ``len(items)`` times in the whole
    step; under one that does not, every item, each ``per_device`` times on
    a device and once in the whole step. ``per_device`` is the share of the
    loop one device runs (1 / n where the items are spread on n devices)."""
    items = list(items)
    analyzer = active()
    if analyzer is None:
        yield from items
        return
    if analyzer.sample_loops:
        if items:
            with analyzer.scaled(len(items) * per_device, len(items)):
                yield items[0]
        return
    for item in items:
        with analyzer.scaled(per_device, 1.0):
            yield item


def collective(op: str, size: float, group: int, devices: int = 1) -> None:
    """Declare a collective to the active analyzer, if any
    (:meth:`StepAnalyzer.add_collective`)."""
    analyzer = active()
    if analyzer is not None and group > 1:
        analyzer.add_collective(op, size, group, devices)


@contextlib.contextmanager
def uncounted():
    """Ops inside add no FLOPs or bytes to the active analyzer (their
    allocations still count towards the live bytes): a join's sums and
    copies, which stand for its declared collective."""
    analyzer = active()
    if analyzer is None:
        yield
        return
    analyzer._quiet += 1
    try:
        yield
    finally:
        analyzer._quiet -= 1


@contextlib.contextmanager
def recomputed():
    """Wraps a layer body that remat runs again in the backward: there its
    ops count at the scale of the loops they run through, as in the
    forward, not at the scale of the backward node that asked for them."""
    analyzer = active()
    if analyzer is None or not in_backward():
        yield
        return
    analyzer._replay += 1
    try:
        yield
    finally:
        analyzer._replay -= 1


# --------------------------------------------------------------------------
# roofline terms
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Hardware:
    """One NVIDIA H100 SXM5 80 GB, by NVIDIA's H100 Tensor Core GPU data
    sheet. A collective over a group of at most ``nvlink_domain`` devices
    (one 8-GPU HGX board's NVLink domain) runs at ``nvlink_bw``; a larger
    group, or one in ``cross_pod_groups``, crosses nodes at ``ib_bw``."""

    peak_flops: float = 989e12  # bf16 / fp16 dense tensor-core FLOP/s (data sheet, SXM)
    hbm_bw: float = 3.35e12  # B/s, HBM3 (data sheet, SXM)
    nvlink_bw: float = 450e9  # B/s a direction: the data sheet's 900 GB/s is both ways
    ib_bw: float = 50e9  # B/s a GPU: one 400 Gb/s NDR InfiniBand port
    hbm_per_chip: float = 80e9  # bytes (data sheet, SXM)
    nvlink_domain: int = 8  # GPUs a node joins by NVLink


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops: float
    hbm_bytes: float  # fused traffic bound — primary
    hbm_bytes_upper: float  # every-op bound
    coll_bytes: Dict[str, float]
    coll_by_group: Dict[int, float]
    t_compute: float
    t_memory: float  # from the fused bound
    t_memory_upper: float
    t_collective: float
    dominant: str
    model_flops: float
    useful_ratio: float
    bytes_per_device: float
    note: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(
    metrics: Metrics,
    *,
    arch: str,
    shape: str,
    mesh: str,
    model_flops_per_device: float,
    bytes_per_device: float = 0.0,
    hw: Hardware = Hardware(),
    cross_pod_groups: Tuple[int, ...] = (2,),
    note: str = "",
) -> RooflineReport:
    """The reference's terms: compute, memory (from ``hbm_bytes_min``; the
    every-op bound beside it) and the collectives summed per group size;
    ``dominant`` the largest, ``useful_ratio`` model FLOPs over counted
    FLOPs. A group in ``cross_pod_groups`` or larger than one NVLink
    domain is priced at ``ib_bw``, any other at ``nvlink_bw``."""
    t_c = metrics.flops / hw.peak_flops
    t_m = metrics.hbm_bytes_min / hw.hbm_bw
    t_m_up = metrics.hbm_bytes / hw.hbm_bw
    t_x = 0.0
    for g, b in metrics.coll_by_group.items():
        cross = g in cross_pod_groups or g > hw.nvlink_domain
        t_x += b / (hw.ib_bw if cross else hw.nvlink_bw)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh,
        flops=metrics.flops, hbm_bytes=metrics.hbm_bytes_min,
        hbm_bytes_upper=metrics.hbm_bytes,
        coll_bytes=dict(metrics.coll_bytes),
        coll_by_group={int(k): v for k, v in metrics.coll_by_group.items()},
        t_compute=t_c, t_memory=t_m, t_memory_upper=t_m_up, t_collective=t_x,
        dominant=dominant,
        model_flops=model_flops_per_device,
        useful_ratio=(model_flops_per_device / metrics.flops) if metrics.flops else 0.0,
        bytes_per_device=bytes_per_device,
        note=note,
    )



