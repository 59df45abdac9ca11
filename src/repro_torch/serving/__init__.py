"""Serving: schedulable step plans over shared channels (sim) or on the wall
clock (real).

  arrivals  — Poisson / burst / uniform arrival processes;
  scheduler — Scheduler and admission policies (FCFS, cache-aware, SLO-aware),
              Request / CompletedRequest, run summaries;
  tenancy   — the engine classes by system name, fleet specs
              (``parse_fleet_spec``), the fleet record (``TenantFleet``) and
              the sim mode's fleets over one ChannelSim (``build_sim_fleet``);
  disagg    — prefill/decode worker topology and KV handoff;
  replicas  — data-parallel engine replicas behind one Scheduler.
"""
from repro_torch.serving.arrivals import (
    burst_arrivals,
    make_arrivals,
    poisson_arrivals,
    uniform_arrivals,
)
from repro_torch.serving.disagg import INTERCONNECT, DisaggTopology
from repro_torch.serving.replicas import ReplicaSet, replica_channel
from repro_torch.serving.scheduler import (
    POLICIES,
    CacheAffinityPolicy,
    CompletedRequest,
    FCFSPolicy,
    Request,
    Scheduler,
    SLOAwarePolicy,
    summarize,
)
from repro_torch.serving.tenancy import (
    ENGINE_CLASSES,
    TenantFleet,
    build_sim_fleet,
    parse_fleet_spec,
)

__all__ = [
    "burst_arrivals",
    "make_arrivals",
    "poisson_arrivals",
    "uniform_arrivals",
    "INTERCONNECT",
    "DisaggTopology",
    "ReplicaSet",
    "replica_channel",
    "POLICIES",
    "CacheAffinityPolicy",
    "CompletedRequest",
    "FCFSPolicy",
    "Request",
    "Scheduler",
    "SLOAwarePolicy",
    "summarize",
    "ENGINE_CLASSES",
    "TenantFleet",
    "build_sim_fleet",
    "parse_fleet_spec",
]
