"""Re-Prefill engines: ContiguousKV (§4) and the three baselines (§5.1).

One orchestration skeleton runs in two modes:
  real — a real model on the card (or the CPU, if the backend was built
         there) with real unit reads on the wall clock (``RealExecutor``);
  sim  — paper-scale configs on a discrete-event timeline (``ChannelSim`` /
         ``SimExecutor``): no tensors, selections from a workload model
         (``backends.SimCompute``), every IO leg and op priced by the device
         model. Its timelines equal the JAX package's to the last bit.

  ContiguousKVEngine — chunk granularity, period-reused identification,
      intra- and inter-period prefetch, attention-guided cache.
      Identification runs the chunk_score kernel through
      ``backend.chunk_scores``, so only the (m,) chunk scores reach the host.
      ``prefetch=False`` (and ``inter_period=False``) turn the prefetch off
      for the paper's w/o-P ablation.
  ASLRUEngine        — AttentionStore: the whole prefix KV in 64-token
      blocks, every layer submitted up front, LRU cache.
  ASH2OEngine        — AS + per-layer H2O token selection, block loads, LFU.
  IMPRESSEngine      — partial-key probing, token selection, block loads,
      score-based cache, next-layer probe prefetch.

The baselines run on a coarse-block session
(``build_real_session(coarse_blocks=True)``). Their token scores run the
chunk_score kernel at one token a chunk (``backend.token_scores``), part B
the chunk_attention kernel at one token a chunk (AS-LRU: a block a chunk),
and decode the decode_attention kernel over the resident blocks as pages.

StateSpaceEngine serves the state-space families (hybrid hymba,
attention-free falcon-mamba), which keep no prefix KV to identify and load:
prefill is one scan over the whole prompt and decode advances a fixed-size
recurrent state (``backends.StateCompute``).

The engines are *step-plan factories*: ``plan()`` returns a resumable
generator of ComputeOp/WaitOp steps (repro_torch.core.stepplan) and
``reprefill()`` drives one plan to completion; ``serving.Scheduler``
interleaves many. Each decode op carries a ``DecodeBatchCtx`` (token,
position, the request's pools, the backend) through which the scheduler
batches concurrent requests' decode steps, swaps a preempted request's pools
out and back, and moves its decode to another worker's backend. With
``prefill_chunk_tokens`` each layer's part B is split into chunk-granular
ops, of which only the last runs it and carries a ``PrefillChunkCtx``,
through which the scheduler batches concurrent requests' same-layer part B
(``_part_b_ops``); a backend shared by concurrent plans is bound to each
request's compute (``_bound``). Keys are namespaced by the session's tenant,
or content-addressed by the prefix's digest when the cache is a
content-addressed ``TieredPrefixStore`` (its SSD tier's hits read the
store's log), and every op's weight stream by the model's name. With a
``HybridPlanner`` (``hybrid``) the four KV engines decide once per request,
at the first selection, which missing head of the prefix to recompute by one
truncated causal forward (``RealCompute.recompute_prefix_kv``) instead of
loading it (``_hybrid_reprefill``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core.backends import DeviceTailPool, TailPool
from repro_torch.core.cache import (
    DEVICE,
    HOST,
    SSD,
    AttentionGuidedCache,
    CachePolicy,
    ImpressScoreCache,
    LFUCache,
    LRUCache,
)
from repro_torch.core.chunking import ChunkMeta
from repro_torch.core.hybrid import TOKEN_BYTES, HybridPlanner
from repro_torch.core.importance import select_topk_chunks, select_topk_tokens
from repro_torch.core.periods import PeriodSchedule
from repro_torch.core.sparse_attention import bucket_size
from repro_torch.core.stepplan import (ComputeOp, DecodeBatchCtx, PrefillChunkCtx,
                                       RequestClock, StepPlan, WaitOp, drive_serial)
from repro_torch.storage.timing import BaseExecutor, ChannelSim, IOHandle


# ---------------------------------------------------------------------------
# session + trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PrefixSession:
    cfg: object
    prefix_len: int
    meta: ChunkMeta
    store: object  # ChunkStore, or PlanStore in sim mode
    probe: Optional[np.ndarray] = None  # (L, n, n_kv, d) fp16 prefix keys
    tenant: int = 0  # namespace for shared-cache keys (0 = single-tenant)
    # prefix token ids: what the compute-or-load planner recomputes KV from;
    # None disables the recompute in real mode
    tokens: Optional[np.ndarray] = None
    # content address of the prefix (sha256 of its token ids): engines over a
    # content-addressed store key units (digest, layer, unit), so identical
    # prompts across tenants dedupe to one entry; None keeps tenant keys
    digest: Optional[str] = None


@dataclasses.dataclass
class ReprefillTrace:
    system: str = ""
    ttft: float = 0.0
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    ssd_bytes: int = 0  # all KV bytes read from SSD (demand + speculative)
    ssd_bytes_demand: int = 0
    ssd_bytes_spec: int = 0
    ssd_bytes_probe: int = 0
    ssd_requests: int = 0
    pcie_bytes: int = 0
    needed_bytes: int = 0  # bytes of data actually required among demand misses
    tokens_loaded: int = 0
    hits_device: int = 0
    hits_host: int = 0
    hits_ssd: int = 0  # resident in the tier store's SSD log (not a miss)
    misses: int = 0
    selected_per_period: List[np.ndarray] = dataclasses.field(default_factory=list)
    selected_per_layer: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # decode phase (request lifecycle past the first token)
    first_token_at: float = 0.0  # absolute clock time of the first token
    decode_times: List[float] = dataclasses.field(default_factory=list)
    decode_selected: List[np.ndarray] = dataclasses.field(default_factory=list)  # layer 0's, per step
    decode_tokens_out: List[int] = dataclasses.field(default_factory=list)  # greedy token ids
    # compute-or-load re-prefill: the planner's outcome for the request
    recompute_units: int = 0  # units recomputed instead of loaded
    recompute_tokens: int = 0  # the recompute's causal frontier: it covers [0, end)
    ssd_bytes_avoided: int = 0  # SSD bytes (all layers) the recompute saved
    hybrid_decision: object = None  # core.hybrid.HybridDecision, or None

    @property
    def read_amplification(self) -> float:
        """Demand-fetch amplification (Fig. 4): bytes read / bytes required.
        Speculative prefetch traffic is tracked separately (ssd_bytes_spec)."""
        return self.ssd_bytes_demand / max(self.needed_bytes, 1)

    @property
    def n_decoded(self) -> int:
        return len(self.decode_times)

    @property
    def tpot(self) -> float:
        """Mean time per output token over the decode phase."""
        if not self.decode_times:
            return 0.0
        return (self.decode_times[-1] - self.first_token_at) / len(self.decode_times)

    def inter_token_latencies(self) -> np.ndarray:
        """Gaps between consecutive emitted tokens (first token excluded)."""
        if not self.decode_times:
            return np.empty(0)
        return np.diff(np.array([self.first_token_at] + self.decode_times))

    def add_stage(self, tag: str, dt: float):
        self.stages[tag] = self.stages.get(tag, 0.0) + dt


class PlanStore:
    """Timing-only store for sim mode: layout math without a backing file."""

    def __init__(self, layout):
        self.layout = layout

    def run_plan(self, layer: int, units) -> Tuple[int, int]:
        runs = self.layout.coalesce(layer, units)
        return sum(r.nbytes for r in runs), len(runs)

    def read_units(self, layer, units):
        return {int(u): None for u in units}


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------
class _EngineBase:
    name = "base"

    def __init__(
        self,
        session: PrefixSession,
        backend,
        executor: BaseExecutor,
        cache: CachePolicy,
        *,
        budget: float = 0.25,
        device_tail_pool: bool = True,
        prefill_chunk_tokens: Optional[int] = None,
        hybrid: Optional[HybridPlanner] = None,
    ):
        self.session = session
        self.backend = backend
        self.ex = executor
        self.cache = cache
        self.budget = budget
        # decode-phase KV pools live in device memory (one upload at decode
        # start, in-place writes per token) unless the host-resident pool is
        # forced for comparison
        self.device_tail_pool = device_tail_pool
        # part B in chunk-granular ops of this many suffix tokens (None: one op)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # the compute-or-load planner; None or mode "off" keeps the load-only
        # plan op for op
        self.hybrid = hybrid
        self.cfg = session.cfg
        self.sim = isinstance(executor, ChannelSim)
        self.tenant = session.tenant
        # the model's weight stream: decode ops' weight_key is "model@<stream>"
        self.stream = self.cfg.name
        # content-addressed keys only when both ends opt in: the session has
        # a prefix digest and the cache dedupes across tenants (a flat cache
        # keeps tenant-namespaced keys)
        self._digest = (session.digest if session.digest is not None
                        and getattr(cache, "content_addressed", False) else None)
        self._data: Dict[Tuple, np.ndarray] = {}

    # -- plan entry points ----------------------------------------------------
    def plan(self, suffix_tokens, request_id: int = 0, arrival: float = 0.0,
             decode_tokens: int = 0) -> StepPlan:
        """Build a resumable step plan for one request (does not run it).

        With ``decode_tokens=N`` the plan continues past the first token with
        one decode step (phase="decode") per token. ``arrival`` starts the
        request's clock (the sim scheduler's admission time).
        """
        clock = RequestClock(arrival)
        trace = ReprefillTrace(system=self.name)
        gen = self._steps(np.asarray(suffix_tokens), request_id, clock, trace,
                          decode_tokens=decode_tokens)
        return StepPlan(request_id=request_id, gen=gen, clock=clock, trace=trace)

    def reprefill(self, suffix_tokens, request_id: int = 0,
                  decode_tokens: int = 0):
        """Run one request's plan to completion: (logits, trace)."""
        p = self.plan(suffix_tokens, request_id, decode_tokens=decode_tokens)
        logits = drive_serial(self.ex, p)
        return logits, p.trace

    def _steps(self, suffix_tokens, request_id, clock, trace, decode_tokens=0):
        raise NotImplementedError

    def _key(self, layer: int, unit: int) -> Tuple:
        """Cache/data key: content-addressed (digest-keyed) when the store
        dedupes across tenants, tenant-namespaced when tenants share a flat
        cache."""
        if self._digest is not None:
            return (self._digest, layer, int(unit))
        if self.tenant:
            return (self.tenant, layer, int(unit))
        return (layer, int(unit))

    def _bound(self, request_id: int, fn):
        """Pin a shared backend to this request while ``fn`` runs (concurrent
        plans interleave over one backend; ``SimCompute``'s workload is keyed
        by the current request id); a backend that keeps no per-request state
        (``RealCompute``) takes ``fn`` as it is."""
        be = self.backend
        if not hasattr(be, "new_request"):
            return fn

        def rebind():
            be.new_request(request_id)
            return fn()

        return rebind

    # -- I/O helpers ---------------------------------------------------------
    def _io(self, clock: RequestClock, fn, *, nbytes: int, n_requests: int,
            channel: str, after: Optional[IOHandle] = None) -> IOHandle:
        """Submit a transfer: in sim mode no earlier than the request's own
        clock (and after ``after``), in real mode now."""
        if self.sim:
            return self.ex.submit_io_at(fn, nbytes=nbytes, n_requests=n_requests,
                                        channel=channel, at=clock.t, after=after)
        return self.ex.submit_io(fn, nbytes=nbytes, n_requests=n_requests, channel=channel)

    def _submit_units(self, layer: int, units: List[int], trace: ReprefillTrace,
                      handles: Dict, clock: RequestClock, *, speculative: bool = False,
                      needed_bytes_per_unit: Optional[Dict[int, int]] = None) -> None:
        """Load `units` of `layer` honoring cache tiers; records handles.

        `needed_bytes_per_unit` maps unit -> bytes actually required from it
        (token-granularity baselines need only the selected tokens out of a
        block). Defaults to the whole unit (chunk granularity: aligned).
        In sim mode every SSD leg is followed by its PCIe leg up, and a
        layer's tier-store hits and prefix-store misses share one submission.
        """
        store = self.session.store
        missing, host_hits, ssd_hits = [], [], []
        for u in units:
            key = self._key(layer, u)
            if key in handles:
                continue
            tier = self.cache.lookup(key, tenant=self.tenant)
            if tier == DEVICE:
                trace.hits_device += 1
                handles[key] = IOHandle(ready_at=clock.t)
                handles[key].result = self._data.get(key)
            elif tier == HOST:
                trace.hits_host += 1
                host_hits.append(u)
            elif tier == SSD:
                trace.hits_ssd += 1
                ssd_hits.append(u)
            else:
                trace.misses += 1
                missing.append(u)
        unit_bytes = store.layout.unit_bytes
        ssd_keys = tuple(self._key(layer, u) for u in ssd_hits)
        if ssd_hits:
            # sim mode books the log read into the store's stats here: it
            # has no ssd_fetch to do it
            ssd_nb, ssd_nr, ssd_live = self.cache.ssd_plan(ssd_keys, charge=self.sim)
        if missing:
            miss_nb, miss_nr = store.run_plan(layer, missing)
            if needed_bytes_per_unit is None:
                miss_needed = len(missing) * unit_bytes
            else:
                miss_needed = sum(needed_bytes_per_unit.get(int(u), unit_bytes)
                                  for u in missing)

        def account_ssd_leg(nbytes, nreq, needed):
            trace.ssd_bytes += nbytes
            if speculative:
                trace.ssd_bytes_spec += nbytes
            else:
                trace.ssd_bytes_demand += nbytes
                trace.needed_bytes += needed
            trace.ssd_requests += nreq
            trace.pcie_bytes += nbytes

        def ssd_then_pcie(fetch, nbytes, nreq):
            h = self._io(clock, fetch, nbytes=nbytes, n_requests=nreq, channel="ssd")
            if self.sim:
                h = self._io(clock, None, nbytes=nbytes, n_requests=1, channel="pcie",
                             after=h)
            return h

        combined = self.sim and bool(ssd_hits) and bool(missing)
        if combined:
            # the tier store's log and the prefix store share one physical
            # SSD, so a layer's two read sets ride one submission batch (one
            # fixed latency) and one PCIe leg up
            h = ssd_then_pcie(None, ssd_nb + miss_nb, ssd_nr + miss_nr)
            for key in ssd_keys:
                handles[key] = h
            for u in missing:
                handles[self._key(layer, u)] = h
            account_ssd_leg(ssd_nb, ssd_nr, ssd_live)
            account_ssd_leg(miss_nb, miss_nr, miss_needed)
            trace.tokens_loaded += len(missing) * store.layout.unit_tokens
        elif ssd_hits:
            # resident in the tier store's SSD log: read its gap-merged runs;
            # the insert after the wait promotes the units back to the device
            # tier
            fetch = None
            if not self.sim:
                # the IO thread reads them later, while inserts here may drop
                # or compact them: their slots stay until the fetch has read
                # them
                self.cache.ssd_pin(ssd_keys)
                fetch = lambda ks=ssd_keys: self._fetch_cache_ssd(ks)  # noqa: E731
            h = ssd_then_pcie(fetch, ssd_nb, ssd_nr)
            account_ssd_leg(ssd_nb, ssd_nr, ssd_live)
            for key in ssd_keys:
                handles[key] = h
        if host_hits:
            nbytes = len(host_hits) * unit_bytes
            h = self._io(clock, self._mk_fetch(layer, host_hits, from_host=True),
                         nbytes=nbytes, n_requests=1, channel="pcie")
            trace.pcie_bytes += nbytes
            for u in host_hits:
                handles[self._key(layer, u)] = h
        if missing and not combined:
            fetch = self._mk_fetch(layer, missing, from_host=False)
            if fetch is not None and self.hybrid is not None:
                # the planner's EWMA of measured against modelled IO time
                fetch = self.hybrid.timed_fetch(fetch, miss_nb, miss_nr)
            h = ssd_then_pcie(fetch, miss_nb, miss_nr)
            account_ssd_leg(miss_nb, miss_nr, miss_needed)
            trace.tokens_loaded += len(missing) * store.layout.unit_tokens
            for u in missing:
                handles[self._key(layer, u)] = h

    def _mk_fetch(self, layer: int, units: List[int], from_host: bool):
        """The real-mode read of `units`; None in sim mode (nothing to read)."""
        if self.sim:
            return None
        store = self.session.store

        def fetch():
            if from_host:
                return {int(u): self._unit_data(layer, int(u)) for u in units}
            got = store.read_units(layer, units)
            for u, arr in got.items():
                self._data[self._key(layer, u)] = arr
            return got

        return fetch

    def _wait_keys(self, layer: int, units, handles, trace: ReprefillTrace,
                   tag: str, clock: RequestClock):
        """Generator: one WaitOp per outstanding unit handle."""
        t0 = clock.t
        for u in units:
            h = handles.get(self._key(layer, u))
            if h is not None:
                yield WaitOp(h, tag=tag)
        trace.add_stage(tag, clock.t - t0)

    def _fetch_cache_ssd(self, keys):
        """Pull SSD-tier payloads out of the tier store's log."""
        got = self.cache.ssd_fetch(keys)
        for k, arr in got.items():
            self._data[k] = np.asarray(arr)
        return got

    def _insert_cache(self, layer: int, units):
        for u in units:
            key = self._key(layer, u)
            self.cache.insert(key, DEVICE, tenant=self.tenant, payload=self._data.get(key))

    def _sweep_data(self):
        live = self.cache.tiers[DEVICE] | self.cache.tiers[HOST]
        for key in list(self._data.keys()):
            if key not in live:
                del self._data[key]

    def _unit_data(self, layer: int, unit: int) -> np.ndarray:
        """KV payload of one unit; falls back to the tier store's canonical
        copy (content-addressed dedup), then to a store re-read if the sweep
        at the end of an earlier request dropped it."""
        key = self._key(layer, unit)
        rec = self._data.get(key)
        if rec is None and hasattr(self.cache, "payload_of"):
            rec = self.cache.payload_of(key)
        if rec is None:
            rec = self.session.store.read_units(layer, [int(unit)])[int(unit)]
        self._data[key] = rec
        return rec

    # -- compute-or-load re-prefill -------------------------------------------
    def _hybrid_reprefill(self, request_id: int, selected, trace: ReprefillTrace, handles,
                          clock: RequestClock, suffix_len: int = 0, attended: int = 0,
                          extra_overlap_flops: float = 0.0):
        """Generator: the recompute-or-load split over the first selection.

        Consulted once per request, where the important units are first
        known (period 0, layer 0). The planner prices a cut over the units
        the cache misses; the head ``[0, end)`` of the prefix is then
        recomputed by one truncated causal forward over every layer, which
        reproduces the ingested float16 KV, and its units become device-tier
        residents with ready handles, so every later ``_submit_units`` finds
        hits instead of SSD reads. The tail stays on the load path. With no
        planner, mode "off", or no cut (force-load) this yields nothing, so
        the plan is the load-only plan op for op. In sim mode the planner
        prices both legs against the channels' backlog, and the recompute is
        an op that only occupies the device.
        """
        hp = self.hybrid
        if hp is None or hp.mode == "off":
            return
        if not self.sim and self.session.tokens is None:
            return  # no prefix tokens kept: nothing to recompute from
        # `contains`, not `lookup`: a planning probe leaves hit counts and
        # recency untouched, so a declined decision (force-load) stays bit
        # for bit the run without a planner
        missing = sorted(int(u) for u in selected
                         if self._key(0, int(u)) not in handles
                         and self.cache.contains(self._key(0, int(u))) is None)
        if not missing:
            return
        # sim form: priced against the channels' backlog at the request's
        # clock; real form: no executor, so the IO leg is scaled by the
        # planner's measured EWMA and neither clock nor channel enters the price
        d = hp.decide(cfg=self.cfg, store=self.session.store, missing_units=missing,
                      prefix_len=self.session.prefix_len, clock_t=clock.t,
                      executor=self.ex if self.sim else None,
                      suffix_len=suffix_len, attended_tokens=attended,
                      extra_overlap_flops=extra_overlap_flops,
                      compute_channel=clock.channel)
        trace.hybrid_decision = d
        if not d.recompute_units:
            return
        t0 = clock.t
        end = int(d.recompute_tokens)
        layout = self.session.store.layout
        cfg = self.cfg
        # the prefix tokens are host-resident (the prompt): an upload only,
        # never the SSD queue the recompute avoids
        h_tok = self._io(clock, None if self.sim else (lambda: None),
                         nbytes=TOKEN_BYTES * end, n_requests=1, channel="pcie")
        yield WaitOp(h_tok, tag="recompute_io")
        cost = CM.chunk_recompute_cost(cfg, end, 0)
        units = [int(u) for u in d.recompute_units]

        def fn():
            k_all, v_all = self.backend.recompute_prefix_kv(
                self.session.tokens, end, block_q=min(512, max(16, self.session.prefix_len)))
            ut, g = layout.unit_tokens, layout.geom
            for u in units:
                lo, hi = u * ut, min((u + 1) * ut, end)
                for l in range(cfg.n_layers):
                    rec = np.zeros((ut, 2, g.n_kv_heads, g.d_head), np.float16)
                    rec[: hi - lo, 0] = k_all[l, lo:hi]
                    rec[: hi - lo, 1] = v_all[l, lo:hi]
                    self._data[self._key(l, u)] = rec

        yield ComputeOp(None if self.sim else self._bound(request_id, fn),
                        flops=cost.flops,
                        hbm_bytes=cost.hbm_bytes, tag="recompute", phase="prefill",
                        tokens=end, weight_bytes=float(cfg.n_layers * CM.layer_weight_bytes(cfg)),
                        weight_key=f"model@{self.stream}")
        # recomputed KV takes the pages loaded KV would: ready handles and
        # device-tier entries for every layer's head units
        for u in units:
            for l in range(cfg.n_layers):
                key = self._key(l, u)
                handles[key] = IOHandle(ready_at=clock.t)
                self.cache.insert(key, DEVICE, tenant=self.tenant, payload=self._data.get(key))
        trace.recompute_units += len(units)
        trace.recompute_tokens += end
        trace.ssd_bytes_avoided += d.ssd_bytes_avoided
        trace.add_stage("recompute", clock.t - t0)

    # -- probe ----------------------------------------------------------------
    def _submit_probe(self, layer: int, trace: ReprefillTrace, clock: RequestClock,
                      ratio: float = 1.0) -> IOHandle:
        """Load `layer`'s probe keys; ``ratio`` < 1 loads only the first
        max(1, int(d * ratio)) dims of each key (IMPRESS's partial keys)."""
        nbytes = CM.probe_bytes(self.cfg, self.session.prefix_len, ratio)
        probe = self.session.probe

        def fetch():
            if probe is None:
                return None
            k = probe[layer]
            if ratio < 1.0:
                k = k[..., : max(1, int(k.shape[-1] * ratio))]
            return k

        h = self._io(clock, fetch, nbytes=nbytes, n_requests=1, channel="ssd")
        if self.sim:  # the PCIe leg up, after the SSD leg
            h = self._io(clock, None, nbytes=nbytes, n_requests=1, channel="pcie", after=h)
        trace.ssd_bytes_probe += nbytes
        trace.pcie_bytes += nbytes
        return h

    # -- compute helpers --------------------------------------------------------
    def _cost_part_a(self, suffix_len: int) -> float:
        c = self.cfg
        return float(2 * suffix_len * c.d_model * (c.attn_dim + 2 * c.kv_dim))

    def _cost_identify(self, suffix_len: int) -> float:
        return CM.identification_cost(self.cfg, suffix_len, self.session.prefix_len).flops

    def _cost_part_b(self, suffix_len: int, attended: int) -> Tuple[float, float]:
        lc = CM.suffix_layer_cost(self.cfg, suffix_len, attended)
        a = self._cost_part_a(suffix_len)
        return lc.flops - a, lc.hbm_bytes

    def _part_b_ops(self, fn, suffix_len: int, attended: int, layer: int,
                    ctx: Optional[PrefillChunkCtx] = None):
        """Yield one layer's part B, chunk-granular on demand; returns the
        value of the op that runs ``fn``.

        With ``prefill_chunk_tokens`` unset or >= the suffix length this is
        the one ComputeOp of an unchunked plan. Otherwise the suffix splits
        into ceil(s / c) ops, each priced by
        :func:`costmodel.prefill_chunk_cost` and stamped with ``tokens``,
        ``weight_bytes`` and the layer's ``weight_key``; only the final one
        runs ``fn`` (earlier ones only occupy the device, so the results do
        not change) and carries ``ctx``, through which a scheduler batches it
        with other plans' same-layer final chunks (``part_b_batch``)."""
        c = self.prefill_chunk_tokens
        if not c or c >= suffix_len:
            fl, hb = self._cost_part_b(suffix_len, attended)
            out = yield ComputeOp(fn, flops=fl, hbm_bytes=hb, tag="compute")
            return out
        wb = float(CM.layer_weight_bytes(self.cfg))
        out = None
        done = 0
        while done < suffix_len:
            n_tok = min(c, suffix_len - done)
            done += n_tok
            final = done >= suffix_len
            cost = CM.prefill_chunk_cost(self.cfg, n_tok, attended)
            out = yield ComputeOp(fn if final else None, flops=cost.flops,
                                  hbm_bytes=cost.hbm_bytes, tag="compute", phase="prefill",
                                  tokens=n_tok, weight_bytes=wb,
                                  weight_key=f"layer:{layer}@{self.stream}",
                                  batch_ctx=ctx if final else None)
        return out

    def _chunk_ctx(self, layer, h, q, k_suf, v_suf, k_sel, v_sel, valid,
                   chunk_tokens) -> Optional[PrefillChunkCtx]:
        """The batching surface of this layer's final prefill chunk (None
        unless chunking is on in real mode)."""
        if self.sim or not self.prefill_chunk_tokens:
            return None
        return PrefillChunkCtx(backend=self.backend, layer=int(layer), h=h, q=q, k_suf=k_suf,
                               v_suf=v_suf, k_sel=k_sel, v_sel=v_sel, valid=valid,
                               chunk_tokens=int(chunk_tokens))

    # -- gather ----------------------------------------------------------------
    def _unit_pages(self, layer: int, units, n_pages: int):
        """Units' KV as (n_pages, c, n_kv, d) float16 pages, zero past the units."""
        layout = self.session.store.layout
        g = layout.geom
        k = np.zeros((n_pages, layout.unit_tokens, g.n_kv_heads, g.d_head), np.float16)
        v = np.zeros_like(k)
        for i, u in enumerate(units):
            rec = self._unit_data(layer, int(u))  # (c, 2, n_kv, d)
            k[i] = rec[:, 0]
            v[i] = rec[:, 1]
        return k, v

    def _gather_chunks(self, layer: int, units: np.ndarray):
        """-> (k_sel, v_sel, valid), padded to the bucket size; sim mode
        gathers nothing (Nones)."""
        nb = bucket_size(max(len(units), 1))
        valid = np.zeros((nb,), bool)
        valid[: len(units)] = True
        if self.sim:
            return None, None, valid
        k_sel, v_sel = self._unit_pages(layer, units, nb)
        return k_sel, v_sel, valid

    # -- decode phase ----------------------------------------------------------
    def _decode_phase(self, decode_tokens, request_id, clock, trace, logits, suffix_len,
                      resident, handles, kv_suffix):
        """Per-token decode steps after the first token (phase="decode").

        Sim mode: :meth:`_sim_decode_phase`. Real mode: sparse decode
        attention (the decode_attention kernel) over a preallocated
        per-layer pool built once at decode start: the resident unit pages
        and the suffix KV are paged in, and each decoded token's KV is
        written into its page slot in place; greedy next-token feedback.
        By default the pool is a :class:`DeviceTailPool` (pages in device
        memory, no pool bytes over H2D after the start);
        ``device_tail_pool=False`` forces the host-resident
        :class:`TailPool`, re-uploaded per step. The resident units are the
        ones loaded and waited for during prefill, so decode issues no IO.
        The attention-guided cache keeps accumulating A_j (Eq. 2) from the
        decode-time page mass. Each decode op carries a
        :class:`DecodeBatchCtx`, through which a scheduler batches it with
        other requests' steps or swaps the pools out and in.
        """
        if decode_tokens <= 0:
            return logits
        trace.first_token_at = clock.t
        if self.sim:
            return (yield from self._sim_decode_phase(decode_tokens, request_id, clock, trace,
                                                      suffix_len, handles))
        be, cfg = self.backend, self.cfg
        unit_tokens = self.session.store.layout.unit_tokens
        weight_bytes = CM.decode_weight_bytes(cfg)
        tok = int(np.argmax(logits[0, -1]))
        per_layer = {l: np.asarray(resident.get(l, []), dtype=int)
                     for l in range(cfg.n_layers)}
        # model compute dtype, so a layer without suffix KV never falls back
        # to the fp16 storage dtype for its decoded tail
        compute_dtype = next((kv[0].dtype for kv in kv_suffix.values()), None)
        pool_cls = DeviceTailPool if self.device_tail_pool else TailPool
        pools: Dict[int, TailPool] = {}
        for l, units in per_layer.items():
            k_res, v_res = self._unit_pages(l, units, len(units))
            pools[l] = pool_cls(k_res, v_res, kv_suffix.get(l), unit_tokens,
                                decode_tokens, dtype=compute_dtype, device=be.device)
        for step in range(decode_tokens):
            trace.decode_selected.append(per_layer[0])
            attended = [len(per_layer[l]) * unit_tokens + suffix_len + step + 1
                        for l in range(cfg.n_layers)]
            cost = CM.decode_step_cost(cfg, attended)
            pos = self.session.prefix_len + suffix_len + step
            ctx = DecodeBatchCtx(backend=be, token=tok, pos=pos, pools=pools)

            def fn(tok_now=tok, pos=pos, ctx=ctx):
                # the backend comes off the ctx: a disaggregated scheduler
                # restamps it at the handoff, and this standalone path must
                # follow the plan to the decode worker as the batched one does
                bk = ctx.backend
                h = bk.embed(np.array([tok_now]))
                masses = {}
                for l in range(cfg.n_layers):
                    _, q, k_cur, v_cur = bk.part_a_at(l, h, [[pos]])
                    pools[l].append(k_cur, v_cur)
                    h, masses[l] = bk.decode_attend(l, h, q, pools[l])
                return bk.logits(h), masses

            logits, masses = yield ComputeOp(fn, flops=cost.flops,
                                             hbm_bytes=cost.hbm_bytes, tag="decode",
                                             phase="decode", weight_bytes=weight_bytes,
                                             tokens=1, weight_key=f"model@{self.stream}",
                                             batch_ctx=ctx)
            tok = int(np.argmax(logits[0, -1]))
            trace.decode_tokens_out.append(tok)
            for l, units in per_layer.items():
                if isinstance(self.cache, AttentionGuidedCache):
                    for i, u in enumerate(units):
                        self.cache.update_importance(self._key(l, u), float(masses[l][i]))
                self._insert_cache(l, units)
            trace.decode_times.append(clock.t)
        return logits

    def _sim_decode_phase(self, decode_tokens, request_id, clock, trace, suffix_len, handles):
        """Sim mode's decode steps: each token's selection drifts (the
        workload's decode score field at the engine's own unit granularity,
        the same for every layer), its cache misses become demand fetches
        (WaitOps), and the token is one costmodel-priced ComputeOp a
        scheduler may batch with other requests' steps. The
        attention-guided cache keeps accumulating the workload's mass."""
        be, cfg = self.backend, self.cfg
        layout = self.session.store.layout
        unit_tokens = layout.unit_tokens
        span = layout.n_units * unit_tokens
        weight_bytes = CM.decode_weight_bytes(cfg)
        for step in range(decode_tokens):
            scores = be.decode_scores(request_id, step)
            cs = np.add.reduceat(np.pad(scores, (0, span - len(scores))),
                                 np.arange(0, span, unit_tokens))
            selected = select_topk_chunks(cs, self.budget)
            per_layer = {l: selected for l in range(cfg.n_layers)}
            trace.decode_selected.append(selected)
            for l, units in per_layer.items():
                self._submit_units(l, list(units), trace, handles, clock)
            # wait on the transfers still in flight, each handle once
            t0 = clock.t
            waited = set()
            for l, units in per_layer.items():
                for u in units:
                    h = handles.get(self._key(l, u))
                    if h is None or id(h) in waited:
                        continue
                    if h.ready_at > clock.t:
                        waited.add(id(h))
                        yield WaitOp(h, tag="decode_io")
            trace.add_stage("decode_io", clock.t - t0)
            attended = [len(per_layer[l]) * unit_tokens + suffix_len + step + 1
                        for l in range(cfg.n_layers)]
            cost = CM.decode_step_cost(cfg, attended)
            yield ComputeOp(None, flops=cost.flops, hbm_bytes=cost.hbm_bytes, tag="decode",
                            phase="decode", weight_bytes=weight_bytes, tokens=1,
                            weight_key=f"model@{self.stream}")
            for l, units in per_layer.items():
                if isinstance(self.cache, AttentionGuidedCache) and len(units):
                    m = be.decode_mass(request_id, l, len(units))
                    for i, u in enumerate(units):
                        self.cache.update_importance(self._key(l, u), float(m[i]))
                self._insert_cache(l, units)
            trace.decode_times.append(clock.t)
        return None


# ---------------------------------------------------------------------------
# ContiguousKV
# ---------------------------------------------------------------------------
class ContiguousKVEngine(_EngineBase):
    name = "contiguous_kv"

    def __init__(self, session, backend, executor, cache=None, *, budget=0.25,
                 period: int = 8, subperiod: int = 4, prefetch: bool = True,
                 inter_period: bool = True, device_cap: int = 0,
                 host_cap: int = 0, device_tail_pool: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 hybrid: Optional[HybridPlanner] = None):
        """``prefetch=False`` (w/o P) submits each layer's chunks on demand,
        just before its wait; ``inter_period=False`` loads each period's probe
        lazily, with no speculative warm-up of the next period. Neither
        changes what is computed."""
        cache = cache if cache is not None else AttentionGuidedCache(device_cap, host_cap)
        super().__init__(session, backend, executor, cache, budget=budget,
                         device_tail_pool=device_tail_pool,
                         prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)
        self.schedule = PeriodSchedule(self.cfg.n_layers, period, subperiod)
        self.prefetch = prefetch
        self.inter_period = inter_period and prefetch
        self.chunk_tokens = session.meta.chunk_tokens

    def _steps(self, suffix_tokens, request_id, clock, trace, decode_tokens=0):
        be, cfg = self.backend, self.cfg
        if hasattr(be, "new_request"):
            be.new_request(request_id)
        c = self.chunk_tokens
        prefix_len = self.session.prefix_len
        s = len(suffix_tokens)
        t_start = clock.t
        kv_suffix: Dict[int, Tuple] = {}
        keep_suffix_kv = decode_tokens > 0 and not self.sim

        h = yield ComputeOp(lambda: be.embed(suffix_tokens),
                            flops=2.0 * s * cfg.d_model, tag="compute")
        handles: Dict = {}
        probe_handles: Dict[int, IOHandle] = {0: self._submit_probe(0, trace, clock)}

        for period in self.schedule:
            head = period.head
            x, q, k_suf, v_suf = yield ComputeOp(
                lambda hh=h, l=head: be.part_a(l, hh, prefix_len),
                flops=self._cost_part_a(s), tag="compute")

            if period.index not in probe_handles:  # lazy (no inter-period)
                probe_handles[period.index] = self._submit_probe(head, trace, clock)
            t0 = clock.t
            probe_data = yield WaitOp(probe_handles[period.index], tag="probe_io")
            trace.add_stage("probe_io", clock.t - t0)

            # (m,) chunk scores straight from the chunk_score kernel: the
            # token scores never leave the device
            cs = yield ComputeOp(
                self._bound(request_id,
                            lambda qq=q, pd=probe_data, l=head: be.chunk_scores(qq, pd, l, c)),
                flops=self._cost_identify(s), tag="identify")
            selected = select_topk_chunks(cs, self.budget)
            trace.selected_per_period.append(selected)
            for l in period.layers:
                trace.selected_per_layer[l] = selected
            if period.index == 0:
                yield from self._hybrid_reprefill(
                    request_id, selected, trace, handles, clock, suffix_len=s,
                    attended=len(selected) * c + s,
                    extra_overlap_flops=len(self.schedule) * self._cost_identify(s))

            # intra-period prefetch of this period's layers; inter-period:
            # the next period's probe, and its layers warmed up with the
            # current set
            if self.prefetch:
                for l in period.layers:
                    self._submit_units(l, list(selected), trace, handles, clock)
                if self.inter_period and period.index + 1 < len(self.schedule):
                    nxt = self.schedule.periods[period.index + 1]
                    probe_handles[nxt.index] = self._submit_probe(nxt.head, trace, clock)
                    for l in nxt.layers:
                        self._submit_units(l, list(selected), trace, handles, clock,
                                           speculative=True)
                for l in self.schedule.gate_layers(period):
                    yield from self._wait_keys(l, selected, handles, trace, "kv_io", clock)
            elif period.index + 1 < len(self.schedule):
                # w/o P: the next period's probe is still loaded, on demand
                nxt = self.schedule.periods[period.index + 1]
                probe_handles[nxt.index] = self._submit_probe(nxt.head, trace, clock)

            n_attended = len(selected) * c + s
            for l in period.layers:
                if l != head:
                    x, q, k_suf, v_suf = yield ComputeOp(
                        lambda hh=h, ll=l: be.part_a(ll, hh, prefix_len),
                        flops=self._cost_part_a(s), tag="compute")
                if not self.prefetch:
                    self._submit_units(l, list(selected), trace, handles, clock)
                yield from self._wait_keys(l, selected, handles, trace, "kv_io", clock)
                k_sel, v_sel, valid = self._gather_chunks(l, selected)
                if keep_suffix_kv:
                    kv_suffix[l] = (k_suf, v_suf)
                h, mass = yield from self._part_b_ops(
                    self._bound(request_id,
                                lambda hh=h, ll=l, qq=q, ks=k_suf, vs=v_suf, k1=k_sel,
                                       v1=v_sel, vd=valid: be.part_b(ll, hh, qq, ks, vs, k1,
                                                                     v1, vd, c)),
                    s, n_attended, l,
                    ctx=self._chunk_ctx(l, h, q, k_suf, v_suf, k_sel, v_sel, valid, c))
                # attention-guided cache updates (Eq. 1/2)
                if isinstance(self.cache, AttentionGuidedCache):
                    for i, u in enumerate(selected):
                        self.cache.update_importance(self._key(l, u), float(mass[i]))
                self._insert_cache(l, selected)

        logits = yield ComputeOp(lambda hh=h: be.logits(hh),
                                 flops=2.0 * cfg.d_model * cfg.vocab_size, tag="compute")
        trace.ttft = clock.t - t_start
        logits = yield from self._decode_phase(decode_tokens, request_id, clock, trace, logits,
                                               s, trace.selected_per_layer, handles, kv_suffix)
        self._sweep_data()
        return logits


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------
class _BlockBaselineEngine(_EngineBase):
    """Per-layer serial flow over coarse blocks with H2O-style token
    selection (AS+H2O and IMPRESS): part A, the probe wait, token scores,
    the top ceil(budget * n) tokens and the blocks that hold them, the
    demand load of those blocks, part B over the gathered tokens at one
    token a chunk, then decode over the resident blocks as pages."""

    probe_ratio = 1.0  # fraction of key dims loaded for probing
    probe_prefetch = False  # IMPRESS: prefetch the next layer's probe keys

    def _steps(self, suffix_tokens, request_id, clock, trace, decode_tokens=0):
        be, cfg = self.backend, self.cfg
        if hasattr(be, "new_request"):
            be.new_request(request_id)
        prefix_len = self.session.prefix_len
        layout = self.session.store.layout
        s = len(suffix_tokens)
        t_start = clock.t
        h = yield ComputeOp(lambda: be.embed(suffix_tokens),
                            flops=2.0 * s * cfg.d_model, tag="compute")
        handles: Dict = {}
        probe_handles: Dict[int, IOHandle] = {}
        kv_suffix: Dict[int, Tuple] = {}
        resident: Dict[int, np.ndarray] = {}
        keep_suffix_kv = decode_tokens > 0 and not self.sim

        for l in range(cfg.n_layers):
            x, q, k_suf, v_suf = yield ComputeOp(
                lambda hh=h, ll=l: be.part_a(ll, hh, prefix_len),
                flops=self._cost_part_a(s), tag="compute")
            if l not in probe_handles:  # lazy (AS+H2O: no overlap at all)
                probe_handles[l] = self._submit_probe(l, trace, clock, self.probe_ratio)
            t0 = clock.t
            probe_data = yield WaitOp(probe_handles[l], tag="probe_io")
            trace.add_stage("probe_io", clock.t - t0)
            if self.probe_prefetch and l + 1 < cfg.n_layers:
                # IMPRESS overlaps the next layer's probe load with compute
                probe_handles[l + 1] = self._submit_probe(l + 1, trace, clock,
                                                          self.probe_ratio)
            tok_scores = yield ComputeOp(
                self._bound(request_id,
                            lambda qq=q, pd=probe_data, ll=l: be.token_scores(qq, pd, ll)),
                flops=self._cost_identify(s) * self.probe_ratio, tag="identify")
            tokens = select_topk_tokens(np.asarray(tok_scores), self.budget)
            blocks = layout.units_for_tokens(tokens)
            trace.selected_per_layer[l] = tokens
            # read amplification source: only the selected tokens are needed
            # out of each loaded block
            tok_bytes = layout.geom.token_bytes
            needed: Dict[int, int] = {}
            for t in tokens:
                blk = int(t) // layout.unit_tokens
                needed[blk] = needed.get(blk, 0) + tok_bytes
            if l == 0:
                yield from self._hybrid_reprefill(
                    request_id, blocks, trace, handles, clock, suffix_len=s,
                    attended=len(tokens) + s,
                    extra_overlap_flops=(cfg.n_layers * self._cost_identify(s)
                                         * self.probe_ratio))

            self._submit_units(l, blocks, trace, handles, clock, needed_bytes_per_unit=needed)
            yield from self._wait_keys(l, blocks, handles, trace, "kv_io", clock)
            k_sel, v_sel, valid = self._gather_tokens(l, tokens)
            resident[l] = np.asarray(blocks, dtype=int)
            if keep_suffix_kv:
                kv_suffix[l] = (k_suf, v_suf)
            h, _ = yield from self._part_b_ops(
                self._bound(request_id,
                            lambda hh=h, ll=l, qq=q, ks=k_suf, vs=v_suf, k1=k_sel, v1=v_sel,
                                   vd=valid: be.part_b(ll, hh, qq, ks, vs, k1, v1, vd, 1)),
                s, len(tokens) + s, l,
                ctx=self._chunk_ctx(l, h, q, k_suf, v_suf, k_sel, v_sel, valid, 1))
            if isinstance(self.cache, ImpressScoreCache):
                # static importance: the fraction of each block's tokens selected
                for blk in blocks:
                    lo = blk * layout.unit_tokens
                    hi = lo + layout.unit_tokens
                    cnt = int(np.sum((tokens >= lo) & (tokens < hi)))
                    self.cache.set_static_score(self._key(l, blk), cnt / layout.unit_tokens)
            self._insert_cache(l, blocks)

        logits = yield ComputeOp(lambda hh=h: be.logits(hh),
                                 flops=2.0 * cfg.d_model * cfg.vocab_size, tag="compute")
        trace.ttft = clock.t - t_start
        logits = yield from self._decode_phase(decode_tokens, request_id, clock, trace, logits,
                                               s, resident, handles, kv_suffix)
        self._sweep_data()
        return logits

    def _gather_tokens(self, layer: int, tokens: np.ndarray):
        """Token-granular gather out of the loaded blocks (the re-assembly the
        paper's Fig. 13 notes alignment removes): (k_sel, v_sel, valid) of
        shape (bucket(n_tok), 1, n_kv, d) float16, zero past the tokens;
        sim mode gathers nothing (Nones).

        The JAX engine copies token by token; this copies each block's
        selected tokens with one indexed read (``tokens`` is ascending), so
        the arrays hold the same bytes."""
        tokens = np.asarray(tokens)
        nb = bucket_size(max(len(tokens), 1))
        valid = np.zeros((nb,), bool)
        valid[: len(tokens)] = True
        if self.sim:
            return None, None, valid
        layout = self.session.store.layout
        g = layout.geom
        k_sel = np.zeros((nb, 1, g.n_kv_heads, g.d_head), np.float16)
        v_sel = np.zeros_like(k_sel)
        blk = tokens // layout.unit_tokens
        for b in np.unique(blk):
            idx = np.flatnonzero(blk == b)
            rec = self._unit_data(layer, int(b))  # (B, 2, n_kv, d)
            off = tokens[idx] - b * layout.unit_tokens
            k_sel[idx, 0] = rec[off, 0]
            v_sel[idx, 0] = rec[off, 1]
        return k_sel, v_sel, valid


class ASLRUEngine(_EngineBase):
    """AttentionStore: the whole prefix KV streamed in blocks (budget 1.0 by
    construction), every layer's blocks submitted up front, an LRU cache.
    Part B takes the blocks whole, a block a chunk, so read amplification is
    1.0 by construction. (The JAX package derives it from the token
    baselines' class and overrides their flow; here it shares only the
    engines' machinery.)"""

    name = "as_lru"

    def __init__(self, session, backend, executor, *, device_cap=0, host_cap=0,
                 device_tail_pool: bool = True, prefill_chunk_tokens: Optional[int] = None,
                 hybrid: Optional[HybridPlanner] = None):
        super().__init__(session, backend, executor, LRUCache(device_cap, host_cap),
                         budget=1.0, device_tail_pool=device_tail_pool,
                         prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)

    def _steps(self, suffix_tokens, request_id, clock, trace, decode_tokens=0):
        be, cfg = self.backend, self.cfg
        if hasattr(be, "new_request"):
            be.new_request(request_id)
        prefix_len = self.session.prefix_len
        layout = self.session.store.layout
        s = len(suffix_tokens)
        t_start = clock.t
        kv_suffix: Dict[int, Tuple] = {}
        keep_suffix_kv = decode_tokens > 0 and not self.sim
        h = yield ComputeOp(lambda: be.embed(suffix_tokens),
                            flops=2.0 * s * cfg.d_model, tag="compute")
        handles: Dict = {}
        blocks = list(range(layout.n_units))
        yield from self._hybrid_reprefill(request_id, blocks, trace, handles, clock,
                                          suffix_len=s, attended=prefix_len + s)
        # AS prefetches all layers' KV up front (full cache streaming)
        for l in range(cfg.n_layers):
            self._submit_units(l, blocks, trace, handles, clock)
        for l in range(cfg.n_layers):
            x, q, k_suf, v_suf = yield ComputeOp(
                lambda hh=h, ll=l: be.part_a(ll, hh, prefix_len),
                flops=self._cost_part_a(s), tag="compute")
            yield from self._wait_keys(l, blocks, handles, trace, "kv_io", clock)
            k_sel, v_sel, valid = self._gather_chunks(l, blocks)
            if keep_suffix_kv:
                kv_suffix[l] = (k_suf, v_suf)
            h, _ = yield from self._part_b_ops(
                self._bound(request_id,
                            lambda hh=h, ll=l, qq=q, ks=k_suf, vs=v_suf, k1=k_sel, v1=v_sel,
                                   vd=valid: be.part_b(ll, hh, qq, ks, vs, k1, v1, vd,
                                                       layout.unit_tokens)),
                s, prefix_len + s, l,
                ctx=self._chunk_ctx(l, h, q, k_suf, v_suf, k_sel, v_sel, valid,
                                    layout.unit_tokens))
            self._insert_cache(l, blocks)
        logits = yield ComputeOp(lambda hh=h: be.logits(hh),
                                 flops=2.0 * cfg.d_model * cfg.vocab_size, tag="compute")
        trace.ttft = clock.t - t_start
        resident = {l: np.asarray(blocks, dtype=int) for l in range(cfg.n_layers)}
        logits = yield from self._decode_phase(decode_tokens, request_id, clock, trace, logits,
                                               s, resident, handles, kv_suffix)
        self._sweep_data()
        return logits


class ASH2OEngine(_BlockBaselineEngine):
    """AS + H2O token selection with full-width probe keys, block loads, LFU."""

    name = "as_h2o_lfu"

    def __init__(self, session, backend, executor, *, budget=0.25, device_cap=0,
                 host_cap=0, device_tail_pool: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 hybrid: Optional[HybridPlanner] = None):
        super().__init__(session, backend, executor, LFUCache(device_cap, host_cap),
                         budget=budget, device_tail_pool=device_tail_pool,
                         prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)


class IMPRESSEngine(_BlockBaselineEngine):
    """IMPRESS: partial-key probing, token selection, block loads, the
    score-based cache and the next layer's probe prefetched."""

    name = "impress"
    probe_ratio = 0.125  # partial keys; calibrated so probe cost ~= ours (§5 note)
    probe_prefetch = True

    def __init__(self, session, backend, executor, *, budget=0.25, device_cap=0,
                 host_cap=0, device_tail_pool: bool = True,
                 prefill_chunk_tokens: Optional[int] = None,
                 hybrid: Optional[HybridPlanner] = None):
        super().__init__(session, backend, executor, ImpressScoreCache(device_cap, host_cap),
                         budget=budget, device_tail_pool=device_tail_pool,
                         prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)


# ---------------------------------------------------------------------------
# state-space / hybrid families
# ---------------------------------------------------------------------------
class StateSpaceEngine:
    """Step-plan factory for the SSM (falcon-mamba) and hybrid (hymba)
    families: the heterogeneous fleet's counterpart of the KV engines.

    There is no granular prefix KV to identify or load, so the plan has no
    I/O legs: the prefill over prefix + suffix is one ComputeOp (stage
    ``ssm_prefill``) running ``StateCompute.prefill``, priced by
    :func:`costmodel.ssm_prefill_cost`, or with ``prefill_chunk_tokens``
    ceil(total / c) chunk-granular ops of which only the last runs it (the
    earlier ones only occupy the device); each decode step is one ComputeOp
    priced by :func:`costmodel.ssm_decode_cost`, the constant recurrent state
    instead of a growing KV read (hybrids add their attention span). The
    request's serve state lives in a :class:`backends.StatePool`, advanced in
    place, and each decode op carries a ``DecodeBatchCtx`` over it: the
    scheduler's batching, preemption and handoff surface. In sim mode
    (``ChannelSim``) no op runs anything, the backend may be None and
    ``prefix_len`` stands in for the prefix tokens. Every op's
    ``weight_key`` is ``"model@<cfg.name>"``, so a mixed fleet's batch former
    never amortizes one model's weights against another family's ops.

    The scheduler's sim-mode swap and handoff pricing asks the engine
    through :meth:`swap_bytes_of` / :meth:`handoff_payload` (the KV engines'
    resident-unit accounting does not apply here)."""

    name = "state_space"
    hybrid = None  # no compute-or-load planner: there is no stored KV to load
    cache = None  # no prefix-unit cache: the prefill scan is always compute

    def __init__(self, cfg, backend, executor: BaseExecutor, *, prefix_tokens=None,
                 prefix_len: int = 0, tenant: int = 0,
                 prefill_chunk_tokens: Optional[int] = None):
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(f"StateSpaceEngine serves ssm/hybrid, not {cfg.family!r}")
        self.cfg = cfg
        self.backend = backend
        self.ex = executor
        self.sim = isinstance(executor, ChannelSim)
        self.tenant = tenant
        self.stream = cfg.name
        if prefix_tokens is not None or not self.sim:
            prefix_tokens = (np.zeros(0, np.int32) if prefix_tokens is None
                             else np.asarray(prefix_tokens, dtype=np.int32))
            prefix_len = len(prefix_tokens)
        self.prefix_tokens = prefix_tokens
        self.prefix_len = int(prefix_len)
        self.prefill_chunk_tokens = prefill_chunk_tokens

    def plan(self, suffix_tokens, request_id: int = 0, arrival: float = 0.0,
             decode_tokens: int = 0) -> StepPlan:
        """Build a resumable step plan for one request (does not run it)."""
        clock = RequestClock(arrival)
        trace = ReprefillTrace(system=self.name)
        gen = self._steps(np.asarray(suffix_tokens), request_id, clock, trace,
                          decode_tokens=decode_tokens)
        return StepPlan(request_id=request_id, gen=gen, clock=clock, trace=trace)

    def reprefill(self, suffix_tokens, request_id: int = 0,
                  decode_tokens: int = 0):
        """Run one request's plan to completion: (logits, trace)."""
        p = self.plan(suffix_tokens, request_id, decode_tokens=decode_tokens)
        logits = drive_serial(self.ex, p)
        return logits, p.trace

    # -- scheduler pricing hooks ----------------------------------------------
    def _state_bytes(self, suffix_len: int, decoded: int) -> int:
        """Bytes a swap or handoff of one request's live state must move: the
        constant per-layer recurrent state, plus the attention KV written so
        far for hybrid models."""
        cfg = self.cfg
        n = cfg.n_layers * CM.ssm_state_bytes(cfg)
        if cfg.family == "hybrid":
            tokens = self.prefix_len + suffix_len + decoded
            n += tokens * CM.token_kv_bytes(cfg) * cfg.n_layers
        return int(n)

    def swap_bytes_of(self, a) -> int:
        return self._state_bytes(len(a.request.suffix), len(a.plan.trace.decode_times))

    def handoff_payload(self, a):
        """(bytes, tokens) a prefill-to-decode handoff must move or recompute."""
        suffix_len = len(a.request.suffix)
        nbytes = self._state_bytes(suffix_len, len(a.plan.trace.decode_times))
        return nbytes, self.prefix_len + suffix_len

    # -- the plan -------------------------------------------------------------
    def _steps(self, suffix_tokens, request_id, clock, trace, decode_tokens=0):
        cfg, be = self.cfg, self.backend
        if hasattr(be, "new_request"):
            be.new_request(request_id)
        t_start = clock.t
        total = self.prefix_len + len(suffix_tokens)
        wb = float(CM.decode_weight_bytes(cfg))
        chunk = self.prefill_chunk_tokens or total
        prefill = None
        if not self.sim:
            toks = np.concatenate([self.prefix_tokens, np.asarray(suffix_tokens, np.int32)])
            prefill = lambda: be.prefill(toks, extra_tokens=decode_tokens + 1)  # noqa: E731
        done = 0
        while done < total:
            n_tok = min(chunk, total - done)
            done += n_tok
            final = done >= total
            cost = CM.ssm_prefill_cost(cfg, n_tok, attended_tokens=done)
            out = yield ComputeOp(
                prefill if final else None,
                flops=cost.flops, hbm_bytes=cost.hbm_bytes, tag="ssm_prefill", phase="prefill",
                tokens=n_tok, weight_bytes=wb, weight_key=f"model@{self.stream}")
        logits, pool = (None, None) if self.sim else out
        trace.add_stage("ssm_prefill", clock.t - t_start)
        trace.ttft = clock.t - t_start
        if decode_tokens <= 0:
            return logits
        trace.first_token_at = clock.t
        if self.sim:
            return (yield from self._sim_decode(decode_tokens, clock, trace, total, wb))
        tok = int(np.argmax(logits[0, -1]))
        for step in range(decode_tokens):
            attended = ([total + step + 1] * cfg.n_layers if cfg.family == "hybrid"
                        else None)
            cost = CM.ssm_decode_cost(cfg, attended)
            ctx = DecodeBatchCtx(backend=be, token=tok, pos=total + step, pools={0: pool})

            def fn(ctx=ctx):
                # the backend comes off the ctx (a disaggregated scheduler
                # restamps it at the handoff); the state advances in place
                lg, ctx.pools[0].state = ctx.backend.decode_step(ctx.token, ctx.pools[0].state)
                return lg

            logits = yield ComputeOp(fn, flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                                     tag="decode", phase="decode", tokens=1, weight_bytes=wb,
                                     weight_key=f"model@{self.stream}", batch_ctx=ctx)
            tok = int(np.argmax(logits[0, -1]))
            trace.decode_tokens_out.append(tok)
            trace.decode_times.append(clock.t)
        return logits

    def _sim_decode(self, decode_tokens, clock, trace, total, wb):
        """Sim mode's decode steps: one priced ComputeOp per token."""
        cfg = self.cfg
        for step in range(decode_tokens):
            attended = ([total + step + 1] * cfg.n_layers if cfg.family == "hybrid"
                        else None)
            cost = CM.ssm_decode_cost(cfg, attended)
            yield ComputeOp(None, flops=cost.flops, hbm_bytes=cost.hbm_bytes, tag="decode",
                            phase="decode", tokens=1, weight_bytes=wb,
                            weight_key=f"model@{self.stream}")
            trace.decode_times.append(clock.t)
        return None
