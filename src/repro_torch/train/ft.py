"""Fault tolerance: heartbeat/straggler monitoring + restartable train loop.

At 1000+ nodes the failure modes are: node death (handled by checkpoint +
restart, optionally onto a different mesh — elastic), stragglers (detected
from per-step timing outliers; the mitigation hook lets the launcher swap the
slow host or re-shard), and hangs (wall-clock watchdog). Everything here is
host-side and framework-agnostic, driven by the train loop; it is the JAX
package's module as it is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StepRecord:
    step: int
    duration: float
    host: int = 0


class HeartbeatMonitor:
    """Per-step timing telemetry with straggler detection.

    A step is flagged when it exceeds mean + `k_sigma` * std of the trailing
    window (and the window is warm). `on_straggler` is the mitigation hook —
    in production it triggers host replacement / elastic re-shard; tests
    inject a synthetic slow step and assert the flag fires.
    """

    def __init__(self, window: int = 50, k_sigma: float = 3.0,
                 watchdog_timeout: float = 600.0,
                 on_straggler: Optional[Callable[[StepRecord], None]] = None):
        self.window = window
        self.k_sigma = k_sigma
        self.watchdog_timeout = watchdog_timeout
        self.on_straggler = on_straggler
        self.records: List[StepRecord] = []
        self.stragglers: List[StepRecord] = []
        self._last_beat = time.monotonic()

    def beat(self, step: int, duration: float, host: int = 0) -> bool:
        """Record one step; returns True if flagged as straggler."""
        self._last_beat = time.monotonic()
        rec = StepRecord(step=step, duration=duration, host=host)
        window = [r.duration for r in self.records[-self.window:]]
        self.records.append(rec)
        if len(window) >= 10:
            mean = sum(window) / len(window)
            var = sum((d - mean) ** 2 for d in window) / len(window)
            thresh = mean + self.k_sigma * max(var ** 0.5, 0.05 * mean)
            if duration > thresh:
                self.stragglers.append(rec)
                if self.on_straggler:
                    self.on_straggler(rec)
                return True
        return False

    def hung(self) -> bool:
        return (time.monotonic() - self._last_beat) > self.watchdog_timeout

    def summary(self) -> Dict[str, float]:
        ds = [r.duration for r in self.records]
        if not ds:
            return {}
        return {
            "steps": len(ds),
            "mean_s": sum(ds) / len(ds),
            "p95_s": sorted(ds)[int(0.95 * (len(ds) - 1))],
            "stragglers": len(self.stragglers),
        }


class FailureInjector:
    """Deterministic failure schedule for FT tests: raises at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.failed: List[int] = []

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.failed:
            self.failed.append(step)
            raise RuntimeError(f"injected node failure at step {step}")
