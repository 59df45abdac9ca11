"""Attention-guided tiered cache (§4.4) + baseline policies.

Score S_j = I_j x F_j: cumulative attention-based importance times access
frequency. Lazy min-heaps per tier evict the lowest-scored ContiguousChunk;
evictions cascade down the tier chain (device -> host by default; the
three-tier store in ``repro_torch.storage.tierstore`` appends an SSD tier)
when the victim's score beats the destination minimum, else the victim is dropped out
the bottom. Scores persist in an in-memory table even after eviction (the
paper stores them "including those evicted from memory").

Keys are (layer, unit) pairs, (tenant, layer, unit) triples in multi-tenant
serving, or (prefix_digest, layer, unit) when the content-addressed tier
store shares identical prefixes across tenants. Capacities are in units
(chunks/blocks).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Hashable, Iterable, Optional, Set, Tuple

Key = Tuple[int, int]  # (layer, unit) — or (tenant|digest, layer, unit)

DEVICE = "device"
HOST = "host"
SSD = "ssd"


def tenant_of(key) -> int:
    """Owner of a cache key: multi-tenant keys are (tenant, layer, unit);
    legacy 2-tuples belong to the implicit tenant 0."""
    if isinstance(key, tuple) and len(key) == 3:
        return key[0]
    return 0


class CachePolicy:
    """Interface shared by all policies.

    One policy instance may be shared by several tenants (multi-tenant
    serving): keys are then tenant-namespaced 3-tuples and per-tenant
    hit/miss/occupancy accounting is kept alongside the global counters.

    Tiering is generic over ``_tier_chain``: ``insert`` admits into a tier,
    ``_enforce`` evicts the lowest-priority member of any over-capacity tier
    and demotes it down the chain when it beats the destination's minimum
    (``_admits``), else hands it to ``_on_drop``. Subclasses customize via
    the ``_track`` / ``_on_demote`` / ``_on_drop`` / ``_accept_payload`` /
    ``_owners_of`` hooks rather than overriding the cascade itself.
    """

    _tier_chain: Tuple[str, ...] = (DEVICE, HOST)

    def __init__(self, device_capacity: int, host_capacity: int):
        self.device_capacity = device_capacity
        self.host_capacity = host_capacity
        self.tiers: Dict[str, Set[Key]] = {t: set() for t in self._tier_chain}
        self.hits = {t: 0 for t in self._tier_chain}
        self.misses = 0
        # per-tenant counters: tenant -> {tier: hits..., "miss": n}
        self.tenant_stats: Dict[int, Dict[str, int]] = {}

    def _capacity(self, tier: str) -> int:
        if tier == DEVICE:
            return self.device_capacity
        if tier == HOST:
            return self.host_capacity
        raise KeyError(tier)

    def _tstat(self, key, tenant: Optional[int] = None) -> Dict[str, int]:
        t = tenant_of(key) if tenant is None else tenant
        st = self.tenant_stats.get(t)
        if st is None:
            st = self.tenant_stats[t] = {tr: 0 for tr in self._tier_chain}
            st["miss"] = 0
        return st

    def lookup(self, key: Key, tenant: Optional[int] = None) -> Optional[str]:
        for tier in self._tier_chain:
            if key in self.tiers[tier]:
                self.hits[tier] += 1
                self._tstat(key, tenant)[tier] += 1
                self.on_access(key)
                return tier
        self.misses += 1
        self._tstat(key, tenant)["miss"] += 1
        return None

    def _owners_of(self, key: Key) -> Tuple[int, ...]:
        """Tenants a resident key is accounted to (content-addressed stores
        return every tenant holding a reference to the key's digest)."""
        return (tenant_of(key),)

    def tenant_usage(self) -> Dict[int, Dict[str, int]]:
        """Resident units per tenant per tier (scan; capacities are small)."""
        usage: Dict[int, Dict[str, int]] = {}
        for tier in self._tier_chain:
            for key in self.tiers[tier]:
                for owner in self._owners_of(key):
                    u = usage.setdefault(owner, {t: 0 for t in self._tier_chain})
                    u[tier] += 1
        return usage

    def resident_units(self, tenant: int, tier: Optional[str] = None) -> int:
        tiers = self._tier_chain if tier is None else (tier,)
        return sum(1 for t in tiers for k in self.tiers[t]
                   if tenant in self._owners_of(k))

    def contains(self, key: Key) -> Optional[str]:
        for tier in self._tier_chain:
            if key in self.tiers[tier]:
                return tier
        return None

    # subclass hooks -----------------------------------------------------------
    def on_access(self, key: Key):
        pass

    def priority(self, key: Key) -> float:
        raise NotImplementedError

    def _track(self, key: Key, tier: str):
        """Index a key that just became resident in `tier`."""

    def _on_demote(self, key: Key, src: str, dst: str):
        """A victim moved down the chain from `src` to `dst`."""

    def _on_move(self, key: Key, src: str, dst: str):
        """A resident key was explicitly re-inserted into another tier
        (promotion path; demotions go through ``_on_demote``)."""

    def _on_drop(self, key: Key, tier: str):
        """A victim fell out the bottom of the chain (no longer resident)."""

    def _accept_payload(self, key: Key, payload):
        """Retain the KV bytes for a key (tier stores only; default drops)."""

    # insertion with eviction cascade ------------------------------------------
    def insert(self, key: Key, tier: str = DEVICE, *,
               tenant: Optional[int] = None, payload=None):
        if payload is not None:
            self._accept_payload(key, payload)
        if tenant is not None:
            self._note_owner(key, tenant)
        resident = self.contains(key)
        if resident == tier:
            self.on_access(key)
            return
        if resident is not None:
            self.tiers[resident].discard(key)
            self._on_move(key, resident, tier)
        self.tiers[tier].add(key)
        self.on_access(key)
        self._track(key, tier)
        self._enforce(tier)

    def _note_owner(self, key: Key, tenant: int):
        """Record that `tenant` references `key` (content-addressed stores)."""

    def _demote_targets(self, tier: str) -> Tuple[str, ...]:
        chain = self._tier_chain
        return tuple(dst for dst in chain[chain.index(tier) + 1:]
                     if self._capacity(dst) > 0)

    def _admits(self, tier: str, prio: float) -> bool:
        return (len(self.tiers[tier]) < self._capacity(tier)
                or prio > self._min_priority(tier))

    def _enforce(self, tier: str):
        while len(self.tiers[tier]) > self._capacity(tier):
            victim = self._evict_lowest(tier)
            if victim is None:
                break
            # a victim rejected by the next tier down still gets a shot at
            # the tiers below it (e.g. a cold device victim skips a full
            # host full of hotter keys and lands in the SSD log)
            for dst in self._demote_targets(tier):
                if self._admits(dst, self.priority(victim)):
                    self.tiers[dst].add(victim)
                    self._track(victim, dst)
                    self._on_demote(victim, tier, dst)
                    self._enforce(dst)
                    break
            else:
                self._on_drop(victim, tier)

    def _evict_lowest(self, tier: str) -> Optional[Key]:
        members = self.tiers[tier]
        if not members:
            return None
        victim = min(members, key=self.priority)
        members.discard(victim)
        return victim

    def _min_priority(self, tier: str) -> float:
        members = self.tiers[tier]
        return min((self.priority(k) for k in members), default=float("-inf"))


class AttentionGuidedCache(CachePolicy):
    """The paper's policy: S = I x F with persistent score table.

    Uses lazy min-heaps per tier for O(log n) eviction instead of the O(n)
    scan in the generic base class. Priorities only ever rise (F increments,
    I accumulates non-negative attention mass), which is what makes the lazy
    heap sound: a popped entry whose current priority exceeds its pushed
    priority is simply re-pushed at the current value.
    """

    def __init__(self, device_capacity: int, host_capacity: int):
        super().__init__(device_capacity, host_capacity)
        self.I: Dict[Key, float] = {}
        self.F: Dict[Key, int] = {}
        self._heaps = {t: [] for t in self._tier_chain}
        self._counter = itertools.count()

    def priority(self, key: Key) -> float:
        return self.I.get(key, 0.0) * self.F.get(key, 0)

    def on_access(self, key: Key):
        self.F[key] = self.F.get(key, 0) + 1

    def update_importance(self, key: Key, attention_score: float):
        """I_j += A_j after a request used chunk j (Eq. 2 inputs)."""
        self.I[key] = self.I.get(key, 0.0) + float(attention_score)

    def _track(self, key: Key, tier: str):
        heapq.heappush(self._heaps[tier],
                       (self.priority(key), next(self._counter), key))

    def _evict_lowest(self, tier: str) -> Optional[Key]:
        heap = self._heaps[tier]
        members = self.tiers[tier]
        while heap:
            prio, _, key = heapq.heappop(heap)
            if key not in members:
                continue  # stale
            cur = self.priority(key)
            if cur > prio:  # score rose since push: reinsert lazily
                heapq.heappush(heap, (cur, next(self._counter), key))
                continue
            members.discard(key)
            return key
        return None

    def _min_priority(self, tier: str) -> float:
        # The heap stores priorities as *pushed*; a member whose score rose
        # since its push would understate the tier minimum and over-admit
        # demotions, so settle the head until pushed == current. Every member
        # keeps >= 1 entry pushed at or below its current priority, so the
        # first settled head is the true minimum.
        heap = self._heaps[tier]
        members = self.tiers[tier]
        while heap:
            prio, _, key = heap[0]
            if key not in members:
                heapq.heappop(heap)
                continue
            cur = self.priority(key)
            if cur > prio:  # stale: score rose since push
                heapq.heapreplace(heap, (cur, next(self._counter), key))
                continue
            return prio
        return float("-inf")


class LRUCache(CachePolicy):
    """AttentionStore baseline."""

    def __init__(self, device_capacity: int, host_capacity: int):
        super().__init__(device_capacity, host_capacity)
        self._clock = itertools.count()
        self._last: Dict[Key, int] = {}

    def on_access(self, key: Key):
        self._last[key] = next(self._clock)

    def priority(self, key: Key) -> float:
        return self._last.get(key, -1)


class LFUCache(CachePolicy):
    """AS+H2O+LFU baseline."""

    def __init__(self, device_capacity: int, host_capacity: int):
        super().__init__(device_capacity, host_capacity)
        self._freq: Dict[Key, int] = {}

    def on_access(self, key: Key):
        self._freq[key] = self._freq.get(key, 0) + 1

    def priority(self, key: Key) -> float:
        return self._freq.get(key, 0)


class ImpressScoreCache(CachePolicy):
    """IMPRESS's score-based policy: static importance ratio x frequency."""

    def __init__(self, device_capacity: int, host_capacity: int):
        super().__init__(device_capacity, host_capacity)
        self._score: Dict[Key, float] = {}
        self._freq: Dict[Key, int] = {}

    def set_static_score(self, key: Key, score: float):
        self._score[key] = max(self._score.get(key, 0.0), float(score))

    def on_access(self, key: Key):
        self._freq[key] = self._freq.get(key, 0) + 1

    def priority(self, key: Key) -> float:
        return self._score.get(key, 0.0) * (1 + self._freq.get(key, 0))
