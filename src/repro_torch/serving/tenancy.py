"""Multi-tenant serving: the engine classes by system name, fleet specs and
the fleet record.

A heterogeneous fleet serves several model families behind one Scheduler:
``parse_fleet_spec`` turns ``"qwen2_5_7b:2,falcon_mamba_7b:1"`` into the
port's registry names with their tenant counts, and :class:`TenantFleet`
holds one deployment's per-tenant engines over shared resources. Real mode
builds its fleet in ``launch.serve`` (``--fleet``). The JAX package's
``build_sim_fleet`` (the sim mode's fleets over one ChannelSim, with
``SimCompute`` workloads) waits for the port's sim slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import resolve_config_name
from repro_torch.core.engine import (ASH2OEngine, ASLRUEngine, ContiguousKVEngine,
                                     IMPRESSEngine)
from repro_torch.serving.disagg import DisaggTopology
from repro_torch.serving.replicas import ReplicaSet

ENGINE_CLASSES = {
    "contiguous_kv": ContiguousKVEngine,
    "impress": IMPRESSEngine,
    "as_h2o_lfu": ASH2OEngine,
    "as_lru": ASLRUEngine,
}


def parse_fleet_spec(spec: str) -> List[Tuple[str, int]]:
    """``"qwen2_5_7b:2,falcon_mamba_7b:1"`` -> [("qwen2.5-7b", 2), ...].

    Each entry is ``model[:count]`` (count defaults to 1); model names
    tolerate underscore CLI spellings via :func:`resolve_config_name`, which
    raises a KeyError naming the port's registry for an architecture the
    port does not have."""
    entries: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        try:
            n = int(count) if count else 1
        except ValueError:
            raise ValueError(f"bad fleet entry {part!r}: count must be int") from None
        if n < 1:
            raise ValueError(f"bad fleet entry {part!r}: count must be >= 1")
        entries.append((resolve_config_name(name), n))
    if not entries:
        raise ValueError(f"empty fleet spec {spec!r}")
    return entries


@dataclasses.dataclass
class TenantFleet:
    """One serving deployment: per-tenant engines over shared resources.

    ``topology`` (optional) is the fleet's prefill/decode worker split and
    ``replicas`` its data-parallel replica set; a Scheduler built over this
    fleet should receive the same objects. ``configs`` maps tenant -> the
    model config its engine serves. ``workloads`` holds the sim mode's
    per-tenant workload models (empty in real mode)."""

    engines: Dict[int, object]
    executor: object
    cache: object
    workloads: Dict[int, object] = dataclasses.field(default_factory=dict)
    topology: Optional[DisaggTopology] = None
    replicas: Optional[ReplicaSet] = None
    configs: Dict[int, object] = dataclasses.field(default_factory=dict)
