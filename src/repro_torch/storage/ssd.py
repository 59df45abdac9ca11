"""File-backed KV chunk store: the "SSD" tier.

Real mode does actual pread()s through a np.memmap so read amplification and
coalescing behaviour are measured, not asserted. The store records every read
(bytes, request count) for the benchmark harness.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage.layout import BaseLayout, Run, SegmentLayout


def _unlink_quiet(path: Optional[str]):
    if path and os.path.exists(path):
        os.unlink(path)


@dataclasses.dataclass
class IOStats:
    bytes_read: int = 0
    requests: int = 0
    units_read: int = 0

    def reset(self):
        self.bytes_read = self.requests = self.units_read = 0


class ChunkStore:
    """KV of one prefix on "SSD": array of (layer, unit) records in one file.

    Record layout per unit: (unit_tokens, 2, n_kv, d_head) in `dtype`
    (K then V stacked on axis 1).
    """

    def __init__(self, layout: BaseLayout, dtype=np.float16, path: Optional[str] = None,
                 in_memory: bool = False):
        self.layout = layout
        self.dtype = np.dtype(dtype)
        g = layout.geom
        self.unit_shape = (layout.unit_tokens, 2, g.n_kv_heads, g.d_head)
        self.unit_elems = int(np.prod(self.unit_shape))
        assert self.unit_elems * self.dtype.itemsize == layout.unit_bytes, (
            self.unit_elems * self.dtype.itemsize, layout.unit_bytes)
        self.stats = IOStats()
        self._in_memory = in_memory
        self._mm = None
        self._finalizer = None
        if in_memory:
            self._mem = np.zeros((layout.n_layers, layout.n_units, self.unit_elems), self.dtype)
            self.path = None
        else:
            owns_path = path is None
            if path is None:
                fd, path = tempfile.mkstemp(suffix=".kv", prefix="ckv_")
                os.close(fd)
            self.path = path
            with open(path, "wb") as f:
                f.truncate(layout.total_bytes)
            self._mm = np.memmap(path, dtype=self.dtype, mode="r+",
                                 shape=(layout.n_layers, layout.n_units, self.unit_elems))
            if owns_path:
                # safety net: a store that is never close()d must not leak
                # its temp .kv file past garbage collection
                self._finalizer = weakref.finalize(self, _unlink_quiet, path)

    # -- ingest ---------------------------------------------------------------
    def write_layer(self, layer: int, k: np.ndarray, v: np.ndarray):
        """k, v: (n_tokens, n_kv, d_head). Pads the tail unit with zeros."""
        lay = self.layout
        n, n_kv, dh = k.shape
        pad = lay.n_units * lay.unit_tokens - n
        if pad:
            k = np.concatenate([k, np.zeros((pad, n_kv, dh), k.dtype)], 0)
            v = np.concatenate([v, np.zeros((pad, n_kv, dh), v.dtype)], 0)
        kv = np.stack([k, v], axis=1)  # (tokens, 2, n_kv, dh)
        kv = kv.reshape(lay.n_units, lay.unit_tokens, 2, n_kv, dh).astype(self.dtype)
        flat = kv.reshape(lay.n_units, self.unit_elems)
        if self._in_memory:
            self._mem[layer] = flat
        else:
            self._mm[layer] = flat
            self._mm.flush()

    # -- reads ----------------------------------------------------------------
    def read_units(self, layer: int, units: Sequence[int]) -> Dict[int, np.ndarray]:
        """Read units via coalesced runs; returns {unit_id: (c,2,n_kv,dh)}."""
        runs = self.layout.coalesce(layer, units)
        out: Dict[int, np.ndarray] = {}
        for run in runs:
            first = run.units[0]
            count = len(run.units)
            if self._in_memory:
                data = np.array(self._mem[layer, first : first + count])
            else:
                data = np.array(self._mm[layer, first : first + count])
            for i, u in enumerate(run.units):
                out[u] = data[i].reshape(self.unit_shape)
            self.stats.bytes_read += run.nbytes
            self.stats.requests += 1
            self.stats.units_read += count
        return out

    def run_plan(self, layer: int, units: Sequence[int]) -> Tuple[int, int]:
        """(total bytes, request count) that read_units would incur."""
        runs = self.layout.coalesce(layer, units)
        return sum(r.nbytes for r in runs), len(runs)

    def close(self):
        """Idempotent: releases the mapping and unlinks the backing file on
        the first call, no-ops afterwards (a second close used to raise
        AttributeError on the deleted memmap)."""
        mm, self._mm = self._mm, None
        if mm is not None:
            del mm  # release the mapping before unlinking
        _unlink_quiet(self.path)
        self.path = None
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None

    def __enter__(self) -> "ChunkStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SegmentStore:
    """Payload + I/O accounting for a ``SegmentLayout`` log (the tier
    store's SSD tier).

    Three payload modes:

      mode="plan"   — no bytes held; reads only charge ``IOStats`` from the
                      layout's run plan (what the sim-mode tier store uses);
      mode="memory" — the log is one in-process bytearray;
      mode="file"   — the log is a real file, grown segment-by-segment,
                      read with seek/read per coalesced run (pread-style).

    Reads go through ``SegmentLayout.plan_read``: each run is one request,
    ``bytes_read`` includes gap-merged dead slots (the read-amplification
    cost of the log), ``units_read`` counts only the requested units.
    Compaction relocates live slots of low-occupancy sealed segments and
    charges its traffic to a separate ``compaction`` IOStats so foreground
    amplification stays measurable on its own.
    """

    def __init__(self, layout: SegmentLayout, mode: str = "plan",
                 unit_shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float16, path: Optional[str] = None):
        assert mode in ("plan", "memory", "file"), mode
        self.layout = layout
        self.mode = mode
        self.unit_shape = unit_shape
        self.dtype = np.dtype(dtype)
        if unit_shape is not None:
            assert int(np.prod(unit_shape)) * self.dtype.itemsize == layout.unit_bytes
        self.stats = IOStats()
        self.compaction = IOStats()
        self._buf = bytearray() if mode == "memory" else None
        self._f = None
        self._finalizer = None
        self.path = None
        if mode == "file":
            owns_path = path is None
            if path is None:
                fd, path = tempfile.mkstemp(suffix=".kvlog", prefix="ckv_seg_")
                os.close(fd)
            self.path = path
            self._f = open(path, "w+b")
            if owns_path:
                self._finalizer = weakref.finalize(self, _unlink_quiet, path)

    # -- writes ---------------------------------------------------------------
    def _ensure_capacity(self, end: int):
        if self.mode == "memory" and len(self._buf) < end:
            self._buf.extend(bytes(end - len(self._buf)))
        elif self.mode == "file":
            self._f.seek(0, os.SEEK_END)
            if self._f.tell() < end:
                self._f.truncate(end)

    def _write_at(self, offset: int, raw: bytes):
        self._ensure_capacity(offset + len(raw))
        if self.mode == "memory":
            self._buf[offset:offset + len(raw)] = raw
        elif self.mode == "file":
            self._f.seek(offset)
            self._f.write(raw)

    def _read_at(self, offset: int, nbytes: int) -> bytes:
        self._ensure_capacity(offset + nbytes)
        if self.mode == "memory":
            return bytes(self._buf[offset:offset + nbytes])
        self._f.seek(offset)
        raw = self._f.read(nbytes)
        return raw + bytes(nbytes - len(raw))

    def put(self, key, data: Optional[np.ndarray] = None):
        """Append `key` to the log (idempotent) and store its payload."""
        self.layout.append(key)
        if self.mode == "plan" or data is None:
            return
        raw = np.ascontiguousarray(data, dtype=self.dtype).tobytes()
        assert len(raw) == self.layout.unit_bytes, (len(raw), self.layout.unit_bytes)
        self._write_at(self.layout.offset_of(key), raw)

    def discard(self, key) -> bool:
        return self.layout.discard(key)

    # -- reads ----------------------------------------------------------------
    def plan(self, keys: Sequence) -> Tuple[int, int, int]:
        """(loaded_bytes, requests, live_bytes) a read of `keys` would cost,
        without charging stats (sim pricing / planners)."""
        runs = self.layout.plan_read(keys)
        return (sum(r.nbytes for r in runs), len(runs),
                sum(r.live_bytes for r in runs))

    def read(self, keys: Sequence) -> Dict[object, np.ndarray]:
        """Read `keys` via gap-merged coalesced runs, charging IOStats;
        returns payloads (empty dict in plan mode)."""
        runs = self.layout.plan_read(keys)
        out: Dict[object, np.ndarray] = {}
        ub = self.layout.unit_bytes
        for run in runs:
            self.stats.bytes_read += run.nbytes
            self.stats.requests += 1
            self.stats.units_read += len(run.keys)
            if self.mode == "plan":
                continue
            raw = self._read_at(run.offset, run.nbytes)
            for k in run.keys:
                rel = self.layout.offset_of(k) - run.offset
                arr = np.frombuffer(raw[rel:rel + ub], dtype=self.dtype)
                if self.unit_shape is not None:
                    arr = arr.reshape(self.unit_shape)
                out[k] = arr
        return out

    def read_amplification(self) -> float:
        return self.stats.bytes_read / max(
            self.stats.units_read * self.layout.unit_bytes, 1)

    # -- compaction -----------------------------------------------------------
    def compact(self, max_occupancy: float = 0.5) -> int:
        """Rewrite low-occupancy sealed segments; returns units moved.
        Payload copies follow the layout's move order (all reads from a
        reclaimed segment precede any write into its recycled slots)."""
        moves = self.layout.compact(max_occupancy)
        ub = self.layout.unit_bytes
        for key, old, new in moves:
            if self.mode != "plan":
                self._write_at(new, self._read_at(old, ub))
            self.compaction.bytes_read += ub
            self.compaction.requests += 1
            self.compaction.units_read += 1
        return len(moves)

    def close(self):
        f, self._f = self._f, None
        if f is not None:
            f.close()
        _unlink_quiet(self.path)
        self.path = None
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None

    def __enter__(self) -> "SegmentStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
