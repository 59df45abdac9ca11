"""Re-Prefill engine: ContiguousKV (§4), real mode.

ContiguousKVEngine runs a real model on the card (or the CPU, if the backend
was built there) with real chunk reads on the wall clock: chunk granularity,
period-reused identification, intra- and inter-period prefetch and the
attention-guided cache. Identification runs the chunk_score kernel through
``backend.chunk_scores``, so only the (m,) chunk scores reach the host.

The engine is a *step-plan factory*: ``plan()`` returns a resumable generator
of ComputeOp/WaitOp steps (repro_torch.core.stepplan) and ``reprefill()``
drives one plan to completion. The sim mode, chunked prefill and the
compute-or-load planner of the JAX engine come with the slices that bring
their callers (``SimCompute`` and the serving ``Scheduler``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import costmodel as CM
from repro_torch.core.backends import DeviceTailPool, TailPool
from repro_torch.core.cache import DEVICE, HOST, AttentionGuidedCache, CachePolicy
from repro_torch.core.chunking import ChunkMeta
from repro_torch.core.importance import select_topk_chunks
from repro_torch.core.periods import PeriodSchedule
from repro_torch.core.sparse_attention import bucket_size
from repro_torch.core.stepplan import ComputeOp, RequestClock, StepPlan, WaitOp, drive_serial
from repro_torch.storage.timing import BaseExecutor, ChannelSim, IOHandle


# ---------------------------------------------------------------------------
# session + trace
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PrefixSession:
    cfg: object
    prefix_len: int
    meta: ChunkMeta
    store: object  # ChunkStore
    probe: Optional[np.ndarray] = None  # (L, n, n_kv, d) fp16 prefix keys


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
    misses: int = 0
    selected_per_period: List[np.ndarray] = dataclasses.field(default_factory=list)
    selected_per_layer: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # decode phase (request lifecycle past the first token)
    first_token_at: float = 0.0  # absolute clock time of the first token
    decode_times: List[float] = dataclasses.field(default_factory=list)
    decode_tokens_out: List[int] = dataclasses.field(default_factory=list)  # greedy token ids

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

    def add_stage(self, tag: str, dt: float):
        self.stages[tag] = self.stages.get(tag, 0.0) + dt


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
    ):
        if isinstance(executor, ChannelSim):
            raise TypeError("the engine runs real mode only; the sim mode comes "
                            "with SimCompute")
        self.session = session
        self.backend = backend
        self.ex = executor
        self.cache = cache
        self.budget = budget
        # decode-phase KV pools live in device memory (one upload at decode
        # start, in-place writes per token) unless the host-resident pool is
        # forced for comparison
        self.device_tail_pool = device_tail_pool
        self.cfg = session.cfg
        self._data: Dict[Tuple, np.ndarray] = {}

    # -- plan entry points ----------------------------------------------------
    def plan(self, suffix_tokens, request_id: int = 0,
             decode_tokens: int = 0) -> StepPlan:
        """Build a resumable step plan for one request (does not run it).

        With ``decode_tokens=N`` the plan continues past the first token with
        one decode step (phase="decode") per token.
        """
        clock = RequestClock()
        trace = ReprefillTrace(system=self.name)
        gen = self._steps(np.asarray(suffix_tokens), clock, trace,
                          decode_tokens=decode_tokens)
        return StepPlan(request_id=request_id, gen=gen, clock=clock, trace=trace)

    def reprefill(self, suffix_tokens, request_id: int = 0,
                  decode_tokens: int = 0):
        """Run one request's plan to completion: (logits, trace)."""
        p = self.plan(suffix_tokens, request_id, decode_tokens=decode_tokens)
        logits = drive_serial(self.ex, p)
        return logits, p.trace

    def _steps(self, suffix_tokens, clock, trace, decode_tokens=0):
        raise NotImplementedError

    @staticmethod
    def _key(layer: int, unit: int) -> Tuple[int, int]:
        return (layer, int(unit))

    # -- I/O helpers ---------------------------------------------------------
    def _submit_units(self, layer: int, units: List[int], trace: ReprefillTrace,
                      handles: Dict, *, speculative: bool = False) -> None:
        """Load `units` of `layer` honoring cache tiers; records handles."""
        store = self.session.store
        missing, host_hits = [], []
        for u in units:
            key = self._key(layer, u)
            if key in handles:
                continue
            tier = self.cache.lookup(key)
            if tier == DEVICE:
                trace.hits_device += 1
                handles[key] = IOHandle()
                handles[key].result = self._data.get(key)
            elif tier == HOST:
                trace.hits_host += 1
                host_hits.append(u)
            else:
                trace.misses += 1
                missing.append(u)
        unit_bytes = store.layout.unit_bytes
        if host_hits:
            nbytes = len(host_hits) * unit_bytes
            h = self.ex.submit_io(self._mk_fetch(layer, host_hits, from_host=True),
                                  nbytes=nbytes, n_requests=1, channel="pcie")
            trace.pcie_bytes += nbytes
            for u in host_hits:
                handles[self._key(layer, u)] = h
        if missing:
            miss_nb, miss_nr = store.run_plan(layer, missing)
            h = self.ex.submit_io(self._mk_fetch(layer, missing, from_host=False),
                                  nbytes=miss_nb, n_requests=miss_nr, channel="ssd")
            trace.ssd_bytes += miss_nb
            if speculative:
                trace.ssd_bytes_spec += miss_nb
            else:
                trace.ssd_bytes_demand += miss_nb
                trace.needed_bytes += len(missing) * unit_bytes
            trace.ssd_requests += miss_nr
            trace.pcie_bytes += miss_nb
            trace.tokens_loaded += len(missing) * store.layout.unit_tokens
            for u in missing:
                handles[self._key(layer, u)] = h

    def _mk_fetch(self, layer: int, units: List[int], from_host: bool):
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

    def _insert_cache(self, layer: int, units):
        for u in units:
            key = self._key(layer, u)
            self.cache.insert(key, DEVICE, payload=self._data.get(key))

    def _sweep_data(self):
        live = self.cache.tiers[DEVICE] | self.cache.tiers[HOST]
        for key in list(self._data.keys()):
            if key not in live:
                del self._data[key]

    def _unit_data(self, layer: int, unit: int) -> np.ndarray:
        """KV payload of one unit; re-read from the store if the sweep at the
        end of an earlier request dropped it."""
        key = self._key(layer, unit)
        rec = self._data.get(key)
        if rec is None:
            rec = self.session.store.read_units(layer, [int(unit)])[int(unit)]
        self._data[key] = rec
        return rec

    # -- probe ----------------------------------------------------------------
    def _submit_probe(self, layer: int, trace: ReprefillTrace) -> IOHandle:
        nbytes = CM.probe_bytes(self.cfg, self.session.prefix_len)
        probe = self.session.probe
        h = self.ex.submit_io(lambda: None if probe is None else probe[layer],
                              nbytes=nbytes, n_requests=1, channel="ssd")
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
        """-> (k_sel, v_sel, valid), padded to the bucket size."""
        nb = bucket_size(max(len(units), 1))
        valid = np.zeros((nb,), bool)
        valid[: len(units)] = True
        k_sel, v_sel = self._unit_pages(layer, units, nb)
        return k_sel, v_sel, valid

    # -- decode phase ----------------------------------------------------------
    def _decode_phase(self, decode_tokens, clock, trace, logits, suffix_len,
                      resident, kv_suffix):
        """Per-token decode steps after the first token (phase="decode").

        Sparse decode attention (the decode_attention kernel) over a
        preallocated per-layer pool built once at decode start: the resident
        unit pages and the suffix KV are paged in, and each decoded token's
        KV is written into its page slot in place; greedy next-token
        feedback. By default the pool is a :class:`DeviceTailPool` (pages in
        device memory, no pool bytes over H2D after the start);
        ``device_tail_pool=False`` forces the host-resident
        :class:`TailPool`, re-uploaded per step. The resident units are the
        ones loaded and waited for during prefill, so decode issues no IO.
        The attention-guided cache keeps accumulating A_j (Eq. 2) from the
        decode-time page mass.
        """
        if decode_tokens <= 0:
            return logits
        be, cfg = self.backend, self.cfg
        unit_tokens = self.session.store.layout.unit_tokens
        trace.first_token_at = clock.t
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
            attended = [len(per_layer[l]) * unit_tokens + suffix_len + step + 1
                        for l in range(cfg.n_layers)]
            cost = CM.decode_step_cost(cfg, attended)
            pos = self.session.prefix_len + suffix_len + step

            def fn(tok_now=tok, pos=pos):
                h = be.embed(np.array([tok_now]))
                masses = {}
                for l in range(cfg.n_layers):
                    _, q, k_cur, v_cur = be.part_a_at(l, h, [[pos]])
                    pools[l].append(k_cur, v_cur)
                    h, masses[l] = be.decode_attend(l, h, q, pools[l])
                return be.logits(h), masses

            logits, masses = yield ComputeOp(fn, flops=cost.flops,
                                             hbm_bytes=cost.hbm_bytes, tag="decode",
                                             phase="decode", weight_bytes=weight_bytes,
                                             tokens=1)
            tok = int(np.argmax(logits[0, -1]))
            trace.decode_tokens_out.append(tok)
            for l, units in per_layer.items():
                if isinstance(self.cache, AttentionGuidedCache):
                    for i, u in enumerate(units):
                        self.cache.update_importance(self._key(l, u), float(masses[l][i]))
                self._insert_cache(l, units)
            trace.decode_times.append(clock.t)
        return logits


# ---------------------------------------------------------------------------
# ContiguousKV
# ---------------------------------------------------------------------------
class ContiguousKVEngine(_EngineBase):
    name = "contiguous_kv"

    def __init__(self, session, backend, executor, cache=None, *, budget=0.25,
                 period: int = 8, subperiod: int = 4, device_cap: int = 0,
                 host_cap: int = 0, device_tail_pool: bool = True):
        cache = cache if cache is not None else AttentionGuidedCache(device_cap, host_cap)
        super().__init__(session, backend, executor, cache, budget=budget,
                         device_tail_pool=device_tail_pool)
        self.schedule = PeriodSchedule(self.cfg.n_layers, period, subperiod)
        self.chunk_tokens = session.meta.chunk_tokens

    def _steps(self, suffix_tokens, clock, trace, decode_tokens=0):
        be, cfg = self.backend, self.cfg
        c = self.chunk_tokens
        prefix_len = self.session.prefix_len
        s = len(suffix_tokens)
        t_start = clock.t
        kv_suffix: Dict[int, Tuple] = {}

        h = yield ComputeOp(lambda: be.embed(suffix_tokens),
                            flops=2.0 * s * cfg.d_model, tag="compute")
        handles: Dict = {}
        probe_handles: Dict[int, IOHandle] = {0: self._submit_probe(0, trace)}

        for period in self.schedule:
            head = period.head
            x, q, k_suf, v_suf = yield ComputeOp(
                lambda hh=h, l=head: be.part_a(l, hh, prefix_len),
                flops=self._cost_part_a(s), tag="compute")

            t0 = clock.t
            probe_data = yield WaitOp(probe_handles[period.index], tag="probe_io")
            trace.add_stage("probe_io", clock.t - t0)

            # (m,) chunk scores straight from the chunk_score kernel: the
            # token scores never leave the device
            cs = yield ComputeOp(lambda qq=q, pd=probe_data, l=head: be.chunk_scores(qq, pd, l, c),
                                 flops=self._cost_identify(s), tag="identify")
            selected = select_topk_chunks(cs, self.budget)
            trace.selected_per_period.append(selected)
            for l in period.layers:
                trace.selected_per_layer[l] = selected

            # intra-period prefetch of this period's layers; inter-period:
            # the next period's probe, and its layers warmed up with the
            # current set
            for l in period.layers:
                self._submit_units(l, list(selected), trace, handles)
            if period.index + 1 < len(self.schedule):
                nxt = self.schedule.periods[period.index + 1]
                probe_handles[nxt.index] = self._submit_probe(nxt.head, trace)
                for l in nxt.layers:
                    self._submit_units(l, list(selected), trace, handles,
                                       speculative=True)
            for l in self.schedule.gate_layers(period):
                yield from self._wait_keys(l, selected, handles, trace, "kv_io", clock)

            fl, hb = self._cost_part_b(s, len(selected) * c + s)
            for l in period.layers:
                if l != head:
                    x, q, k_suf, v_suf = yield ComputeOp(
                        lambda hh=h, ll=l: be.part_a(ll, hh, prefix_len),
                        flops=self._cost_part_a(s), tag="compute")
                yield from self._wait_keys(l, selected, handles, trace, "kv_io", clock)
                k_sel, v_sel, valid = self._gather_chunks(l, selected)
                if decode_tokens > 0:
                    kv_suffix[l] = (k_suf, v_suf)
                h, mass = yield ComputeOp(
                    lambda hh=h, ll=l, qq=q, ks=k_suf, vs=v_suf, k1=k_sel, v1=v_sel,
                           vd=valid: be.part_b(ll, hh, qq, ks, vs, k1, v1, vd, c),
                    flops=fl, hbm_bytes=hb, tag="compute")
                # attention-guided cache updates (Eq. 1/2)
                if isinstance(self.cache, AttentionGuidedCache):
                    for i, u in enumerate(selected):
                        self.cache.update_importance(self._key(l, u), float(mass[i]))
                self._insert_cache(l, selected)

        logits = yield ComputeOp(lambda hh=h: be.logits(hh),
                                 flops=2.0 * cfg.d_model * cfg.vocab_size, tag="compute")
        trace.ttft = clock.t - t_start
        logits = yield from self._decode_phase(decode_tokens, clock, trace, logits, s,
                                               trace.selected_per_layer, kv_suffix)
        self._sweep_data()
        return logits
