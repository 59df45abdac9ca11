"""Prefill/decode disaggregation: worker topology and KV-handoff channel.

A disaggregated fleet splits serving into prefill workers (probe reads,
unit loads, part B) and decode workers (one token per iteration over a paged
tail pool), joined by a KV-transfer link, so a long prefill never sits in
front of another request's decode iteration.

Real mode: ``decode_backends`` carries one
:class:`repro_torch.core.backends.RealCompute` per decode worker (sharing
the colocated engine's params, so logits stay bit-identical). At a plan's
first decode op the scheduler moves its per-layer pools across with the
pools' ``swap_out`` / ``swap_in`` (the device-to-host and host-to-device
legs of a cross-worker transfer) and restamps the op's
``DecodeBatchCtx.backend`` to the worker's. The simulated topology (one FIFO
compute channel per worker plus the interconnect) comes with the sim slice;
the channel names are fixed here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

INTERCONNECT = "interconnect"


def prefill_channel(i: int) -> str:
    return f"compute:p{i}"


def decode_channel(i: int) -> str:
    return f"compute:d{i}"


@dataclasses.dataclass
class DisaggTopology:
    """One prefill/decode worker split.

    ``n_prefill``/``n_decode`` size the two worker pools. ``decode_backends``
    (real mode) maps decode worker -> its backend; when set, its length
    overrides ``n_decode``.
    """

    n_prefill: int = 1
    n_decode: int = 1
    decode_backends: Optional[List[object]] = None

    def __post_init__(self):
        if self.decode_backends is not None:
            self.n_decode = len(self.decode_backends)
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError(
                f"DisaggTopology needs at least one prefill and one decode "
                f"worker, got {self.n_prefill}:{self.n_decode}")

    @classmethod
    def parse(cls, spec: str) -> "DisaggTopology":
        """Parse a ``--disaggregate P:D`` worker-ratio spec like "2:1"."""
        try:
            p, d = spec.split(":")
            return cls(n_prefill=int(p), n_decode=int(d))
        except ValueError:
            raise ValueError(
                f"--disaggregate expects P:D with positive integers, "
                f"got {spec!r}") from None

    @property
    def prefill_channels(self) -> List[str]:
        return [prefill_channel(i) for i in range(self.n_prefill)]

    @property
    def decode_channels(self) -> List[str]:
        return [decode_channel(i) for i in range(self.n_decode)]

    def attach_sim(self, ex):
        """Register the workers' channels on a simulated executor: the sim
        slice of the port brings it."""
        raise NotImplementedError("the simulated topology comes with the port's sim slice")
