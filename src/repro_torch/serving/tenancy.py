"""Multi-tenant serving: the engine classes by system name, fleet specs,
the fleet record and the sim mode's fleets.

A heterogeneous fleet serves several model families behind one Scheduler:
``parse_fleet_spec`` turns ``"qwen2_5_7b:2,falcon_mamba_7b:1"`` into the
port's registry names with their tenant counts, and :class:`TenantFleet`
holds one deployment's per-tenant engines over shared resources. Real mode
builds its fleet in ``launch.serve`` (``--fleet``); :func:`build_sim_fleet`
builds the sim mode's: N tenants, each with its own prefix, session and
workload, competing for one cache and the same ssd/pcie/compute channels of
one ``ChannelSim``. Cache keys are namespaced (tenant, layer, unit), so
``cache.tenant_usage()`` reports per-tenant occupancy and the cache-aware
admission policy can steer warm tenants.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import get_config, resolve_config_name
from repro_torch.core.backends import SimCompute
from repro_torch.core.cache import AttentionGuidedCache
from repro_torch.core.engine import (ASH2OEngine, ASLRUEngine, ContiguousKVEngine,
                                     IMPRESSEngine, StateSpaceEngine)
from repro_torch.core.hybrid import HybridPlanner
from repro_torch.core.session import SyntheticWorkload, build_sim_session
from repro_torch.serving.disagg import DisaggTopology
from repro_torch.serving.replicas import ReplicaSet
from repro_torch.storage.tierstore import TieredPrefixStore
from repro_torch.storage.timing import ChannelSim, DeviceModel

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
    ``replicas`` its data-parallel replica set (a sim fleet registers their
    channels on ``executor`` at build time); a Scheduler built over this
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


def build_sim_fleet(
    system: str,
    model_name: str,
    *,
    n_tenants: int = 1,
    prefix_len: int = 4096,
    budget: float = 0.25,
    chunk_tokens: int = 16,
    block_tokens: int = 64,
    period: int = 8,
    subperiod: int = 4,
    device_cap: int = 256,
    host_cap: int = 1024,
    ssd_cap: int = 0,
    device_model: Optional[DeviceModel] = None,
    seed: int = 0,
    prefill_chunk_tokens: Optional[int] = None,
    hybrid_reprefill: str = "off",
    topology: Optional[DisaggTopology] = None,
    replicas: Optional[ReplicaSet] = None,
    prefix_digests: Optional[Dict[int, str]] = None,
    segment_units: int = 64,
    fleet: Optional[str] = None,
) -> TenantFleet:
    """Build `n_tenants` sim engines of one system sharing executor + cache.

    Tenant ids are 1..n_tenants (0 is the single-tenant namespace). The
    baselines get their own policy class but still share one cache instance
    across tenants, so occupancy competition is real.

    ``fleet`` (``"model:count,model:count"``, see :func:`parse_fleet_spec`)
    builds a heterogeneous fleet instead: ``model_name``/``n_tenants`` are
    ignored and each entry contributes ``count`` tenants of its model.
    Attention-family tenants get the ``system`` KV engine (tenants of one
    model share one cache instance; different models never share a cache,
    their KV layouts differ); ssm/hybrid tenants get a
    :class:`StateSpaceEngine`, whose ops carry ``"model@<name>"`` weight
    streams, so each model's weight stream is its own and one ``ChannelSim``
    is shared by all.

    ``ssd_cap > 0`` (contiguous_kv only) makes the shared cache the
    content-addressed three-tier :class:`TieredPrefixStore` in plan mode:
    host victims demote into a log-structured SSD segment tier instead of
    dropping. ``prefix_digests`` maps tenant -> content digest of its
    prefix: tenants sharing a digest serve the same system prompt, so their
    sessions carry the digest (one deduped resident copy in a
    content-addressed store) and their workloads draw from one digest-keyed
    importance field.
    """
    if fleet is not None:
        tenant_cfgs = [get_config(name)
                       for name, count in parse_fleet_spec(fleet)
                       for _ in range(count)]
    else:
        tenant_cfgs = [get_config(model_name)] * n_tenants
    executor = ChannelSim(device_model or DeviceModel())
    if replicas is not None:
        if topology is not None and replicas.topology is None:
            replicas.topology = topology  # per-replica worker split
        replicas.attach_sim(executor)
    elif topology is not None:
        topology.attach_sim(executor)
    cls = ENGINE_CLASSES[system]
    # one planner per fleet: the compute channel is shared, so the anti-herd
    # reservation must see every tenant's recompute commitments
    hybrid = (None if hybrid_reprefill == "off"
              else HybridPlanner(hybrid_reprefill, device_model=executor.model))
    shared_cache = None
    model_caches: Dict[str, object] = {}  # one shared cache per model
    engines: Dict[int, object] = {}
    workloads: Dict[int, SyntheticWorkload] = {}
    configs: Dict[int, object] = {}
    digests = prefix_digests or {}
    for tenant, cfg in enumerate(tenant_cfgs, start=1):
        configs[tenant] = cfg
        if cfg.family in ("ssm", "hybrid"):
            engines[tenant] = StateSpaceEngine(
                cfg, None, executor, prefix_len=prefix_len, tenant=tenant,
                prefill_chunk_tokens=prefill_chunk_tokens)
            continue
        coarse = system != "contiguous_kv"
        digest = digests.get(tenant)
        sess = build_sim_session(cfg, prefix_len, chunk_tokens=chunk_tokens,
                                 coarse_blocks=coarse, block_tokens=block_tokens,
                                 digest=digest)
        sess = dataclasses.replace(sess, tenant=tenant)
        if digest is not None:
            # identical content attends identically: one importance field per
            # digest (crc32, not hash(): stable under PYTHONHASHSEED)
            wl_seed = seed + zlib.crc32(digest.encode()) % 100_000
        else:
            wl_seed = seed + 1000 * tenant
        wl = SyntheticWorkload(prefix_len, cfg.n_layers, seed=wl_seed)
        be = SimCompute(cfg, wl)
        model_cache = model_caches.get(cfg.name)
        if system == "contiguous_kv":
            if model_cache is None:
                if ssd_cap > 0:
                    model_cache = TieredPrefixStore(
                        device_cap, host_cap, ssd_cap,
                        unit_bytes=sess.store.layout.unit_bytes,
                        segment_units=segment_units, payload_mode="plan")
                else:
                    model_cache = AttentionGuidedCache(device_cap, host_cap)
                model_caches[cfg.name] = model_cache
            eng = cls(sess, be, executor, cache=model_cache, budget=budget,
                      period=period, subperiod=subperiod,
                      prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)
        else:
            kw = dict(device_cap=device_cap, host_cap=host_cap,
                      prefill_chunk_tokens=prefill_chunk_tokens, hybrid=hybrid)
            if system != "as_lru":
                kw["budget"] = budget
            eng = cls(sess, be, executor, **kw)
            if model_cache is None:
                model_caches[cfg.name] = eng.cache
            else:
                eng.cache = model_cache  # same-model tenants share one policy
        if shared_cache is None:
            shared_cache = model_caches[cfg.name]
        engines[tenant] = eng
        workloads[tenant] = wl
    return TenantFleet(engines=engines, executor=executor, cache=shared_cache,
                       workloads=workloads, topology=topology,
                       replicas=replicas, configs=configs)
