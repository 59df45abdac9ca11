"""Content-addressed three-tier prefix store: HBM / host DRAM / SSD.

``TieredPrefixStore`` extends the paper's ``AttentionGuidedCache`` (§4.4)
with a third tier: instead of dropping host-DRAM victims on the floor,
evictions cascade HBM -> DRAM -> SSD, where a log-structured
ContiguousChunk segment layout (``storage.layout.SegmentLayout`` /
``storage.ssd.SegmentStore``) absorbs demotion waves as sequential appends.
Attention-guided scores drive the whole ladder: a victim is only admitted
into the next tier down while its S = I x F score beats that tier's
minimum, and an SSD hit is promoted back to HBM by the engine's normal
fetch-then-insert path. Sealed segments whose occupancy decays below a
threshold are compacted (live units re-appended, dead segments recycled),
keeping the log's read amplification bounded.

Content-addressed sharing: when engines carry a prefix digest
(``PrefixSession.digest``), cache keys become ``(digest, layer, unit)`` so
identical system prompts across tenants dedupe to ONE resident entry. A
digest -> {tenants} refcount map keeps ``tenant_usage()`` /
``resident_units()`` and eviction fairness working per tenant: every
referencing tenant is charged for a shared unit, and ``release`` drops a
tenant's reference, reclaiming the entry once the refcount hits zero.

Payload modes mirror ``SegmentStore``: "plan" holds no bytes (sim serving
prices reads off the run plan), "memory"/"file" keep one canonical copy of
every resident unit in ``_payload`` — which is how the dedup claim is
byte-verified: N tenants sharing a prompt hold exactly one copy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.cache import DEVICE, HOST, SSD, AttentionGuidedCache, Key, tenant_of
from repro_torch.storage.layout import SegmentLayout
from repro_torch.storage.ssd import SegmentStore


class TieredPrefixStore(AttentionGuidedCache):
    """Three-tier attention-guided store with content-addressed sharing.

    Capacities are in units. ``unit_bytes`` sizes the SSD log's slots (and
    the byte-level stats); ``payload_mode`` selects whether KV bytes are
    actually held ("memory"/"file") or only planned ("plan", sim serving).
    """

    _tier_chain = (DEVICE, HOST, SSD)

    def __init__(self, device_capacity: int, host_capacity: int,
                 ssd_capacity: int, *, unit_bytes: int,
                 segment_units: int = 64, gap_merge_units: int = 1,
                 payload_mode: str = "plan",
                 unit_shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float16, compact_below: float = 0.35,
                 content_addressed: bool = True):
        self.ssd_capacity = ssd_capacity
        super().__init__(device_capacity, host_capacity)
        self.unit_bytes = unit_bytes
        self.compact_below = compact_below
        self.content_addressed = content_addressed
        self.ssd = SegmentStore(
            SegmentLayout(unit_bytes, segment_units=segment_units,
                          gap_merge_units=gap_merge_units),
            mode=payload_mode, unit_shape=unit_shape, dtype=dtype)
        # canonical payload per resident key (one copy per digest, however
        # many tenants share it) — empty in plan mode
        self._payload: Dict[Key, np.ndarray] = {}
        # digest -> tenants referencing it (refcount = len); tenant -> digests
        self.digest_tenants: Dict[object, Set[int]] = {}
        self.tenant_digests: Dict[int, Set[object]] = {}

    # -- tier chain hooks ------------------------------------------------------
    def _capacity(self, tier: str) -> int:
        if tier == SSD:
            return self.ssd_capacity
        return super()._capacity(tier)

    def _accept_payload(self, key: Key, payload):
        if self.ssd.mode != "plan":
            self._payload[key] = payload

    def _on_demote(self, key: Key, src: str, dst: str):
        if dst == SSD:
            # demotion waves append in arrival order: adjacent slots, so the
            # hot tail of the log reads back as coalesced sequential runs
            self.ssd.put(key, self._payload.get(key))

    def _on_move(self, key: Key, src: str, dst: str):
        if src == SSD and dst != SSD:
            # promoted back up: tombstone the log slot (occupancy decay is
            # what compaction feeds on)
            self.ssd.discard(key)

    def _on_drop(self, key: Key, tier: str):
        # fell out the bottom of the chain: no longer resident anywhere
        if tier == SSD:
            with self.ssd.lock:
                self.ssd.discard(key)
                self._compact_if_due()
        self._payload.pop(key, None)

    def _compact_if_due(self):
        if self.ssd.layout.compaction_candidates(self.compact_below):
            self.ssd.compact(self.compact_below)

    # -- content addressing ----------------------------------------------------
    def _note_owner(self, key: Key, tenant: int):
        if not (self.content_addressed and isinstance(key, tuple)
                and len(key) == 3):
            return
        digest = key[0]
        self.digest_tenants.setdefault(digest, set()).add(tenant)
        self.tenant_digests.setdefault(tenant, set()).add(digest)

    def _owners_of(self, key: Key) -> Tuple[int, ...]:
        if isinstance(key, tuple) and len(key) == 3:
            owners = self.digest_tenants.get(key[0])
            if owners:
                return tuple(sorted(owners))
        return (tenant_of(key),)

    def release(self, tenant: int, digest) -> bool:
        """Drop `tenant`'s reference to `digest`; when the refcount hits
        zero every resident unit of that prefix is reclaimed from all tiers
        (scores persist, per the paper). Returns True if reclaimed."""
        owners = self.digest_tenants.get(digest)
        if owners is None or tenant not in owners:
            return False
        owners.discard(tenant)
        self.tenant_digests.get(tenant, set()).discard(digest)
        if owners:
            return False
        del self.digest_tenants[digest]
        for tier in self._tier_chain:
            for key in [k for k in self.tiers[tier]
                        if isinstance(k, tuple) and len(k) == 3
                        and k[0] == digest]:
                self.tiers[tier].discard(key)
                if tier == SSD:
                    self.ssd.discard(key)
                self._payload.pop(key, None)
        return True

    def dedup_saved_units(self) -> int:
        """Resident units NOT duplicated thanks to content addressing: each
        shared unit would exist once per referencing tenant in a
        tenant-keyed cache."""
        saved = 0
        for tier in self._tier_chain:
            for key in self.tiers[tier]:
                if isinstance(key, tuple) and len(key) == 3:
                    owners = self.digest_tenants.get(key[0])
                    if owners and len(owners) > 1:
                        saved += len(owners) - 1
        return saved

    def payload_bytes(self) -> int:
        """Bytes of KV actually held for device/host-resident units (one
        canonical copy per key — the dedup byte-verification hook)."""
        return len(self._payload) * self.unit_bytes

    def payload_of(self, key: Key):
        return self._payload.get(key)

    # -- SSD tier reads --------------------------------------------------------
    def ssd_plan(self, keys: Sequence[Key], *,
                 charge: bool = False) -> Tuple[int, int, int]:
        """(loaded_bytes, requests, live_bytes) an SSD-tier fetch of `keys`
        would cost — what sim mode prices onto the ssd channel. With
        ``charge`` the run is also booked into the store's IOStats (sim mode
        has no ``ssd_fetch`` call to do it), so read amplification stays
        observable either way."""
        nbytes, nreq, live_bytes = self.ssd.plan(keys)
        if charge:
            st = self.ssd.stats
            st.bytes_read += nbytes
            st.requests += nreq
            st.units_read += len(keys)
        return nbytes, nreq, live_bytes

    def ssd_pin(self, keys: Sequence[Key]):
        """Hold `keys`' log slots for an ``ssd_fetch`` that runs later, on
        another thread: the tiers may drop or promote them meanwhile, but
        their bytes stay in the log, in place or moved by compaction, until
        the fetch has read them."""
        self.ssd.pin(keys)

    def ssd_fetch(self, keys: Sequence[Key]) -> Dict[Key, np.ndarray]:
        """Read SSD-resident `keys` (charges the store's IOStats); payloads
        come back in memory/file modes, {} in plan mode. Releases the pins
        of ``ssd_pin``; a drop that waited on them compacts now."""
        with self.ssd.lock:
            pending = self.ssd.pending_discards
            got = self.ssd.read(keys)
            if self.ssd.pending_discards < pending:
                self._compact_if_due()
        return got

    def read_amplification(self) -> float:
        return self.ssd.read_amplification()

    def tier_occupancy(self) -> Dict[str, int]:
        return {t: len(self.tiers[t]) for t in self._tier_chain}

    def close(self):
        self.ssd.close()

    def __enter__(self) -> "TieredPrefixStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
