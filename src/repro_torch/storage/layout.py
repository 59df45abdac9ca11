"""On-SSD layouts: where a (layer, unit) lives and what a selection costs.

The paper's granularity argument lives here:

  ContiguousChunkLayout — the storage unit IS the pruning unit (c tokens).
      Reading one selected chunk reads exactly its bytes: amplification 1.0.

  CoarseBlockLayout — IMPRESS/AttentionStore style: storage unit is a B-token
      block (B=64). Token-granular selections force whole containing blocks
      to be read -> read amplification = loaded_bytes / needed_bytes.

Both lay chunks of one layer contiguously, so adjacent selected units coalesce
into sequential runs (Challenge 1: fine granularity *without* losing the
device's sequential bandwidth).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    """Byte geometry of one token's KV for one layer."""

    n_kv_heads: int
    d_head: int
    bytes_per_el: int = 2  # bf16

    @property
    def token_bytes(self) -> int:  # K + V
        return 2 * self.n_kv_heads * self.d_head * self.bytes_per_el


@dataclasses.dataclass(frozen=True)
class Run:
    """A coalesced contiguous byte range on the device."""

    offset: int
    nbytes: int
    units: Tuple[int, ...]  # unit indices covered


class BaseLayout:
    unit_tokens: int

    def __init__(self, n_tokens: int, n_layers: int, geom: KVGeometry, unit_tokens: int):
        self.n_tokens = n_tokens
        self.n_layers = n_layers
        self.geom = geom
        self.unit_tokens = unit_tokens
        self.n_units = -(-n_tokens // unit_tokens)
        self.unit_bytes = unit_tokens * geom.token_bytes
        self.layer_bytes = self.n_units * self.unit_bytes

    @property
    def total_bytes(self) -> int:
        return self.layer_bytes * self.n_layers

    def unit_offset(self, layer: int, unit: int) -> int:
        return layer * self.layer_bytes + unit * self.unit_bytes

    def coalesce(self, layer: int, units: Sequence[int]) -> List[Run]:
        """Group sorted unit ids into contiguous runs (one I/O request each)."""
        if len(units) == 0:
            return []
        units = sorted(set(int(u) for u in units))
        runs: List[Run] = []
        start = prev = units[0]
        for u in units[1:]:
            if u == prev + 1:
                prev = u
                continue
            runs.append(self._run(layer, start, prev))
            start = prev = u
        runs.append(self._run(layer, start, prev))
        return runs

    def _run(self, layer: int, first: int, last: int) -> Run:
        return Run(
            offset=self.unit_offset(layer, first),
            nbytes=(last - first + 1) * self.unit_bytes,
            units=tuple(range(first, last + 1)),
        )


class ContiguousChunkLayout(BaseLayout):
    """Paper's layout: storage unit == ContiguousChunk (c tokens)."""

    def __init__(self, n_tokens: int, n_layers: int, geom: KVGeometry, chunk_tokens: int = 16):
        super().__init__(n_tokens, n_layers, geom, chunk_tokens)

    def units_for_chunks(self, chunk_ids: Sequence[int]) -> List[int]:
        return sorted(set(int(c) for c in chunk_ids))

    def bytes_needed(self, chunk_ids: Sequence[int]) -> int:
        return len(set(map(int, chunk_ids))) * self.unit_bytes


class CoarseBlockLayout(BaseLayout):
    """IMPRESS/AS layout: storage unit = B-token block (B=64 in the paper)."""

    def __init__(self, n_tokens: int, n_layers: int, geom: KVGeometry, block_tokens: int = 64):
        super().__init__(n_tokens, n_layers, geom, block_tokens)

    def units_for_tokens(self, token_ids: Sequence[int]) -> List[int]:
        return sorted({int(t) // self.unit_tokens for t in token_ids})

    def units_for_chunks(self, chunk_ids: Sequence[int], chunk_tokens: int) -> List[int]:
        units = set()
        for c in chunk_ids:
            first = int(c) * chunk_tokens
            last = min(first + chunk_tokens, self.n_tokens) - 1
            units.update(range(first // self.unit_tokens, last // self.unit_tokens + 1))
        return sorted(units)

    def bytes_needed_tokens(self, token_ids: Sequence[int], geom_bytes: int | None = None) -> int:
        per_tok = self.geom.token_bytes if geom_bytes is None else geom_bytes
        return len(set(map(int, token_ids))) * per_tok


def read_amplification(loaded_bytes: int, needed_bytes: int) -> float:
    return loaded_bytes / max(needed_bytes, 1)


# -- log-structured multi-prefix segment layout (SSD tier of the tier store) --

@dataclasses.dataclass
class Segment:
    """One append-only region of the log: `capacity` fixed-size unit slots.

    Slots hold arbitrary cache keys (the tier store uses
    ``(digest|tenant, layer, unit)``); a discarded key leaves a ``None``
    tombstone, so ``occupancy`` decays until compaction recycles the segment.
    """

    base: int  # byte offset of slot 0 in the log
    capacity: int
    slots: List[object] = dataclasses.field(default_factory=list)
    sealed: bool = False

    @property
    def live(self) -> int:
        return sum(1 for k in self.slots if k is not None)

    @property
    def occupancy(self) -> float:
        return self.live / max(self.capacity, 1)


@dataclasses.dataclass(frozen=True)
class SegRun:
    """A coalesced read over one segment; `nbytes` includes any dead-slot
    gaps merged into the run (the read-amplification cost of log structure),
    `live_bytes` only the requested units."""

    offset: int
    nbytes: int
    keys: Tuple[object, ...]
    live_bytes: int


class SegmentLayout:
    """Append-only multi-prefix log of fixed-size unit slots.

    Unlike ``ContiguousChunkLayout`` (one prefix, units addressed by
    (layer, unit) position) the log holds units of *many* prefixes in
    arrival order: demotion waves land adjacently, so the hot tail of the
    log reads back as long sequential runs. Readers may merge runs across
    up to ``gap_merge_units`` dead/unrequested slots — trading amplification
    bytes for fewer I/O requests, exactly the knob the paper's Challenge 1
    is about. Sealed segments whose occupancy decays below a threshold are
    compacted: live slots are re-appended to the open segment and the dead
    segment is recycled before the log grows.
    """

    def __init__(self, unit_bytes: int, segment_units: int = 64,
                 gap_merge_units: int = 1):
        assert segment_units > 0 and unit_bytes > 0
        self.unit_bytes = unit_bytes
        self.segment_units = segment_units
        self.segment_bytes = segment_units * unit_bytes
        self.gap_merge_units = gap_merge_units
        self.segments: List[Segment] = []
        self.index: dict = {}  # key -> (seg_id, slot)
        self._open_id: int | None = None

    # -- log bookkeeping ------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        """Log footprint (segments are recycled, so this only grows when no
        dead segment is available)."""
        return len(self.segments) * self.segment_bytes

    def live_units(self) -> int:
        return len(self.index)

    def _open_segment(self) -> int:
        # recycle a fully-dead sealed segment before growing the log
        for i, seg in enumerate(self.segments):
            if seg.sealed and seg.live == 0:
                seg.slots = []
                seg.sealed = False
                self._open_id = i
                return i
        seg = Segment(base=len(self.segments) * self.segment_bytes,
                      capacity=self.segment_units)
        self.segments.append(seg)
        self._open_id = len(self.segments) - 1
        return self._open_id

    def append(self, key) -> Tuple[int, int]:
        """Claim the next slot for `key`; idempotent for resident keys.
        Seals eagerly on fill, so a just-filled tail segment is a
        compaction candidate as soon as its occupancy decays."""
        if key in self.index:
            return self.index[key]
        if self._open_id is None:
            self._open_segment()
        seg = self.segments[self._open_id]
        slot = len(seg.slots)
        seg.slots.append(key)
        self.index[key] = (self._open_id, slot)
        loc = self.index[key]
        if len(seg.slots) >= seg.capacity:
            seg.sealed = True
            self._open_id = None
        return loc

    def discard(self, key) -> bool:
        loc = self.index.pop(key, None)
        if loc is None:
            return False
        seg_id, slot = loc
        self.segments[seg_id].slots[slot] = None
        return True

    def offset_of(self, key) -> int:
        seg_id, slot = self.index[key]
        return self.segments[seg_id].base + slot * self.unit_bytes

    # -- reads ----------------------------------------------------------------
    def plan_read(self, keys: Sequence) -> List[SegRun]:
        """Coalesce resident `keys` into per-segment runs, merging across
        gaps of up to ``gap_merge_units`` slots (gap bytes are counted in
        ``nbytes`` but not ``live_bytes``)."""
        by_seg: dict = {}
        for k in keys:
            loc = self.index.get(k)
            if loc is None:
                raise KeyError(k)
            by_seg.setdefault(loc[0], []).append((loc[1], k))
        runs: List[SegRun] = []
        ub = self.unit_bytes
        for seg_id in sorted(by_seg):
            base = self.segments[seg_id].base
            slots = sorted(by_seg[seg_id])
            start_slot, prev_slot = slots[0][0], slots[0][0]
            run_keys = [slots[0][1]]
            for slot, k in slots[1:]:
                if slot - prev_slot <= 1 + self.gap_merge_units:
                    prev_slot = slot
                    run_keys.append(k)
                    continue
                runs.append(SegRun(base + start_slot * ub,
                                   (prev_slot - start_slot + 1) * ub,
                                   tuple(run_keys), len(run_keys) * ub))
                start_slot = prev_slot = slot
                run_keys = [k]
            runs.append(SegRun(base + start_slot * ub,
                               (prev_slot - start_slot + 1) * ub,
                               tuple(run_keys), len(run_keys) * ub))
        return runs

    # -- compaction -----------------------------------------------------------
    def compaction_candidates(self, max_occupancy: float) -> List[int]:
        """Sealed, partially-dead segments worth rewriting (the open segment
        and fully-dead segments — recycled for free — are excluded)."""
        return [i for i, seg in enumerate(self.segments)
                if seg.sealed and 0 < seg.live
                and seg.occupancy <= max_occupancy]

    def compact(self, max_occupancy: float = 0.5) -> List[Tuple[object, int, int]]:
        """Re-append live keys of low-occupancy sealed segments; returns
        ``(key, old_offset, new_offset)`` moves so a payload-holding store
        can relocate bytes."""
        moves: List[Tuple[object, int, int]] = []
        for seg_id in self.compaction_candidates(max_occupancy):
            seg = self.segments[seg_id]
            for slot, key in enumerate(seg.slots):
                if key is None:
                    continue
                old = seg.base + slot * self.unit_bytes
                seg.slots[slot] = None
                del self.index[key]
                self.append(key)
                moves.append((key, old, self.offset_of(key)))
        return moves
