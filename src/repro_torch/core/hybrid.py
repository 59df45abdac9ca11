"""Compute-or-load hybrid re-prefill planner.

When the SSD/PCIe path is the bottleneck, the fastest way to "load" a missing
ContiguousChunk's KV is sometimes to recompute it from the prefix tokens (cf.
"Compute Or Load KV Cache? Why Not Both?", arxiv 2410.03065).  This module
prices both legs with the same roofline model the simulator runs on and picks
a *cut point*: a contiguous head ``[0, end)`` of the prefix is recomputed by
one truncated causal forward (bit-identical to the ingested KV — causal
attention over a prefix head never sees the tail, and the NEG_INF mask makes
excluded positions contribute exactly 0.0), while the remaining missing units
load over SSD + PCIe.

The cost of a cut is **additive**, not ``max()``: the recompute op runs on
the same accelerator as the rest of the prefill, so it delays everything
downstream by its full duration, while the tail's loads already overlap the
prefill compute the request performs anyway — only the *residual* IO (queue
wait + service time exceeding that overlap window) stalls the request:

  cost(cut) = T_compute(head) + [wait_io + max(0, T_io_service(tail) - overlap)]

  * cut at 0            -> force-load   (T_compute = 0, full residual IO)
  * cut after last unit -> force-compute (no IO: skips the queue entirely)
  * best cut            -> min over all cuts of the additive cost

Queue-aware pricing: in sim mode the planner reads the ``ChannelSim``
``free_at`` occupancy so a backlogged SSD channel shifts the crossover toward
recompute; in real mode it keeps an EWMA of measured-vs-modeled IO service
time (fed by the engines' timed fetch closures) and scales the IO leg by it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core import costmodel as CM
from repro_torch.models.common import ModelConfig
from repro_torch.storage.timing import ChannelSim, DeviceModel

HYBRID_MODES = ("off", "auto", "force-compute", "force-load")

# Prefix tokens fetched before a recompute leg are priced at 4 B/token
# (int32 vocab ids) — a rounding error next to the KV bytes they replace.
TOKEN_BYTES = 4


@dataclasses.dataclass
class HybridDecision:
    """Outcome of one recompute-vs-load cut-point walk."""

    recompute_units: Tuple[int, ...]  # head units satisfied by recompute
    load_units: Tuple[int, ...]  # tail units left on the IO path
    recompute_tokens: int  # causal frontier extent: recompute covers [0, end)
    t_hybrid: float  # modeled T_compute(head) + residual T_io(tail) at the cut
    t_force_load: float  # modeled time had every missing unit loaded
    t_force_compute: float  # modeled time had every missing unit recomputed
    ssd_bytes_avoided: int  # SSD traffic (all layers) the recompute leg saves


class HybridPlanner:
    """Per-request recompute-vs-load decisions, shared across an engine.

    `mode`:
      off           — planner disabled; engines take today's load-only path.
      auto          — pick the cut minimizing T_compute(head) + residual
                      T_io(tail).
      force-compute — recompute every missing unit (cut after the last one).
      force-load    — load every missing unit (cut at 0); bit-identical to
                      running without a planner, by construction.
    """

    def __init__(self, mode: str = "auto",
                 device_model: Optional[DeviceModel] = None,
                 ewma_alpha: float = 0.5, congestion_cap: float = 4.0):
        if mode not in HYBRID_MODES:
            raise ValueError(f"hybrid mode {mode!r} not in {HYBRID_MODES}")
        self.mode = mode
        self.model = device_model or DeviceModel()
        self.ewma_alpha = float(ewma_alpha)
        # Upper bound on the utilization-based IO service inflation
        # 1/(1-rho): in a closed system with N admitted requests the fair
        # share of a saturated channel is ~N, not the open-system infinity.
        self.congestion_cap = float(congestion_cap)
        # Risk premium on the compute leg: the truncated forward interleaves
        # with concurrent requests' prefill ops, so its wall time runs over
        # the roofline estimate.  Pricing the premium into every cut keeps
        # marginal (modeled ~break-even) recomputes from firing and losing.
        self.compute_margin = 1.25
        # Fixed per-firing overhead (kernel dispatch, token upload latency,
        # pool-page writes, cache churn): breaks modeled near-ties toward
        # the load path instead of letting sub-ms noise pick the cut.
        self.fire_overhead = 5e-3
        # Anti-herd reservation (sim): concurrent requests decide before each
        # other's recompute ops reach the compute channel, so the channel's
        # `free_at` misses committed-but-unissued recompute work.  The shared
        # planner tracks its own commitments' projected finish time, per
        # compute channel (disaggregated fleets have one channel per worker).
        # Reservations are sim-clock-scoped: `reset()` (called by the
        # Scheduler at the start of every run) drops them so a fleet-shared
        # planner reused across sim runs — whose clocks restart at 0 — does
        # not carry a stale reservation that suppresses firing forever.
        self._reserved_until: dict = {}
        # EWMA of measured / modeled IO service time (real mode only);
        # 1.0 until the first observation.
        self.io_scale = 1.0
        self.io_observations = 0

    def reset(self):
        """Drop sim-clock-scoped state (the anti-herd reservations).

        The reservation is an absolute point on the *simulated* timeline;
        a new run restarts that timeline at 0, so keeping the old value
        would price every compute leg as blocked until the previous run's
        finish time.  Real-mode calibration (`io_scale` EWMA) survives —
        wall-clock IO behaviour does not reset between runs.
        """
        self._reserved_until.clear()

    # ---------------------------------------------------------------- real
    def observe_io(self, nbytes: int, n_requests: int, seconds: float):
        """Fold one measured IO service time into the EWMA scale factor."""
        modeled = (self.model.ssd_read_time(nbytes, n_requests)
                   + self.model.pcie_time(nbytes))
        if modeled <= 0.0 or seconds <= 0.0:
            return
        ratio = seconds / modeled
        a = self.ewma_alpha
        if self.io_observations == 0:
            self.io_scale = ratio
        else:
            self.io_scale = (1.0 - a) * self.io_scale + a * ratio
        self.io_observations += 1

    def timed_fetch(self, fn: Callable, nbytes: int,
                    n_requests: int) -> Callable:
        """Wrap a real-mode fetch closure so its wall time feeds the EWMA."""

        def timed():
            t0 = time.perf_counter()
            out = fn()
            self.observe_io(nbytes, n_requests, time.perf_counter() - t0)
            return out

        return timed

    # ------------------------------------------------------------ pricing
    def _io_leg(self, nbytes: int, n_requests: int,
                scale: float, model: DeviceModel, overlap: float) -> float:
        """IO leg = the tail's (congestion-scaled) service time *not hidden*
        behind the request's own prefill compute.  The engines issue loads
        asynchronously and wait layers later, so service up to `overlap`
        (the compute the request performs anyway) is free.  The queue
        backlog is deliberately NOT an addend: the request queues for its
        probe loads either way, so the wait cancels between the cut's legs
        — it enters only through the congestion `scale` on the service."""
        service = scale * (model.ssd_read_time(nbytes, n_requests)
                           + model.pcie_time(nbytes))
        return max(0.0, service - overlap)

    def _compute_leg(self, cfg: ModelConfig, end_tokens: int, wait: float,
                     model: DeviceModel) -> float:
        """Compute leg is *not* overlap-credited: the truncated forward and
        the request's own prefill serialize on the same accelerator.  The
        prefix tokens are host-resident (they arrived with the request), so
        the fetch is a PCIe upload only — it never joins the SSD queue."""
        c = CM.chunk_recompute_cost(cfg, end_tokens, 0)
        t_tok = model.pcie_time(TOKEN_BYTES * end_tokens)
        return wait + self.fire_overhead + self.compute_margin * (
            model.compute_time(c.flops, c.hbm_bytes) + t_tok)

    def decide(self, *, cfg: ModelConfig, store, missing_units: Sequence[int],
               prefix_len: int, clock_t: float = 0.0,
               executor: Optional[ChannelSim] = None,
               suffix_len: int = 0, attended_tokens: int = 0,
               extra_overlap_flops: float = 0.0,
               compute_channel: str = "compute") -> HybridDecision:
        """Walk every cut point over `missing_units` (ascending) and return
        the chosen head/tail split plus the modeled times of both pure modes.

        `executor` (sim only) provides channel occupancy for queue-aware
        pricing; real mode passes None and the EWMA scale applies instead.
        `suffix_len`/`attended_tokens` size the overlap credit: the prefill
        compute the request performs anyway, which hides that much of the IO
        leg's service time.  `extra_overlap_flops` adds engine-specific
        compute (e.g. per-period identification) to that credit.
        `compute_channel` names the accelerator channel the request's ops run
        on — "compute" for a colocated fleet, the assigned worker's channel
        (e.g. "compute:p0") under a disaggregated topology.
        """
        missing = sorted(int(u) for u in set(missing_units))
        layout = store.layout
        n_layers = layout.n_layers
        if executor is not None:
            model = executor.model
            wait_io = max(0.0, max(executor.free_at["ssd"],
                                   executor.free_at["pcie"]) - clock_t)
            wait_cp = max(0.0, max(executor.free_at.get(compute_channel, 0.0),
                                   self._reserved_until.get(compute_channel,
                                                            0.0)) - clock_t)
            # congestion inflation: decision-time backlog (`wait_io`) misses
            # the contention concurrent requests will add WHILE this
            # request's tail loads.  Scale it with the backlog itself, but
            # only once the queue holds more than one full request's worth
            # of service — transient blips (queue < svc_all) drain while the
            # request computes and deserve no inflation; a queue past 2x
            # svc_all means sustained saturation, where every byte of tail
            # service is fair-shared (factor -> `congestion_cap`).
            if missing:
                nb_all, _ = store.run_plan(0, missing)
                svc_all = (model.ssd_read_time(nb_all * n_layers, n_layers)
                           + model.pcie_time(nb_all * n_layers))
            else:
                svc_all = 0.0
            pressure = min(1.0, max(0.0, wait_io - svc_all)
                           / max(svc_all, 1e-9))
            scale = 1.0 + (self.congestion_cap - 1.0) * pressure
        else:
            model = self.model
            wait_io = wait_cp = 0.0
            scale = self.io_scale
        overlap = 0.0
        if suffix_len > 0:
            # everything the request computes per layer anyway: QKV/O
            # projections + MLP (part A) and suffix attention (part B)
            lc = CM.suffix_layer_cost(cfg, suffix_len,
                                      max(attended_tokens, suffix_len))
            part_a = 2.0 * suffix_len * cfg.d_model * (cfg.attn_dim
                                                       + 2 * cfg.kv_dim)
            overlap = model.compute_time(
                n_layers * (lc.flops + part_a) + float(extra_overlap_flops),
                n_layers * lc.hbm_bytes)

        costs: List[float] = []
        ends: List[int] = []
        for i in range(len(missing) + 1):
            tail = missing[i:]
            end = (0 if i == 0 else
                   min((missing[i - 1] + 1) * layout.unit_tokens, prefix_len))
            t_cp = (0.0 if end == 0 else
                    self._compute_leg(cfg, end, wait_cp, model))
            if tail:
                nb, nr = store.run_plan(0, tail)
                t_io = self._io_leg(nb * n_layers, nr * n_layers,
                                    scale, model, overlap)
            else:
                t_io = 0.0
            costs.append(t_cp + t_io)
            ends.append(end)

        if self.mode == "force-load":
            cut = 0
        elif self.mode == "force-compute":
            cut = len(missing)
        else:  # auto (and "off" never reaches decide())
            # The endpoints (pure load, pure recompute) are always
            # candidates; an intermediate cut must DOMINATE both by 10 % —
            # mid cuts trade quadratic frontier compute for linear IO
            # savings, so a modeled sliver of an edge is usually noise.
            endpoint_best = min(costs[0], costs[-1])
            cut = 0 if costs[0] <= costs[-1] else len(missing)
            for k in range(1, len(missing)):
                if (costs[k] < 0.9 * endpoint_best
                        and costs[k] < costs[cut]):
                    cut = k

        head, tail = tuple(missing[:cut]), tuple(missing[cut:])
        if cut > 0 and executor is not None:
            # reserve the compute channel for this commitment: the chosen
            # cut's compute leg is priced to finish at clock_t + t_cp
            self._reserved_until[compute_channel] = max(
                self._reserved_until.get(compute_channel, 0.0),
                clock_t + self._compute_leg(cfg, ends[cut], wait_cp, model))
        avoided = 0
        if head:
            nb_head, _ = store.run_plan(0, list(head))
            avoided = int(nb_head) * n_layers
        return HybridDecision(
            recompute_units=head,
            load_units=tail,
            recompute_tokens=ends[cut],
            t_hybrid=costs[cut],
            t_force_load=costs[0],
            t_force_compute=costs[-1],
            ssd_bytes_avoided=avoided,
        )

    # ---------------------------------------------------- disaggregation
    def price_handoff(self, *, cfg: ModelConfig, nbytes: int, tokens: int,
                      executor: ChannelSim, dst_channel: str,
                      clock_t: float = 0.0,
                      src_channel: str = "interconnect"):
        """Price the prefill->decode KV handoff's two legs (sim only).

        One more cut-point alternative, at the phase boundary instead of
        inside the prefill: the decode worker either *pulls* the prefill
        worker's KV over the interconnect FIFO (queue wait + transfer of
        `nbytes`) or *recomputes* it locally with one truncated causal
        forward over `tokens` prefix+suffix tokens (queue wait on the decode
        worker's own compute channel, with the same margin/overhead pricing
        as the in-prefill compute leg — and the same anti-herd reservation,
        now keyed by the decode worker's channel).

        Returns ``(choice, t_pull, t_recompute)`` with choice in
        {"pull", "recompute"}.  Modes map naturally: "force-compute"
        always recomputes, "off"/"force-load" always pull, "auto" takes
        the cheaper leg.
        """
        model = executor.model
        t_pull = (max(0.0, executor.free_at.get(src_channel, 0.0) - clock_t)
                  + model.interconnect_time(nbytes))
        wait_cp = max(0.0, max(executor.free_at.get(dst_channel, 0.0),
                               self._reserved_until.get(dst_channel, 0.0))
                      - clock_t)
        t_rec = self._compute_leg(cfg, max(int(tokens), 1), wait_cp, model)
        if self.mode == "force-compute":
            choice = "recompute"
        elif self.mode == "auto" and t_rec < t_pull:
            choice = "recompute"
        else:  # off / force-load / auto with pull cheaper
            choice = "pull"
        if choice == "recompute":
            self._reserved_until[dst_channel] = max(
                self._reserved_until.get(dst_channel, 0.0), clock_t + t_rec)
        return choice, t_pull, t_rec
