"""Periods (Definition 4.2): consecutive layers sharing one critical-chunk set.

The schedule drives both prefetch levels:
  - intra-period: identify at the head layer, async-load all member layers;
  - inter-period: while period i-1 computes, speculatively warm period i with
    period i-1's indices; on identification load only the set difference.
SubPeriod `sp` gates how many member layers must be resident before the
period's compute starts (§4.5).
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Period:
    index: int
    head: int  # first layer
    layers: List[int]


class PeriodSchedule:
    def __init__(self, n_layers: int, period: int = 8, subperiod: int = 4):
        assert period >= 1 and 1 <= subperiod <= period
        self.n_layers = n_layers
        self.period = period
        self.subperiod = subperiod
        self.periods: List[Period] = []
        for i, head in enumerate(range(0, n_layers, period)):
            layers = list(range(head, min(head + period, n_layers)))
            self.periods.append(Period(index=i, head=head, layers=layers))

    def __iter__(self):
        return iter(self.periods)

    def __len__(self):
        return len(self.periods)

    def period_of(self, layer: int) -> Period:
        return self.periods[layer // self.period]

    def is_head(self, layer: int) -> bool:
        return layer % self.period == 0

    def gate_layers(self, p: Period) -> List[int]:
        """Layers whose KV must be resident before the period computes."""
        return p.layers[: self.subperiod]
