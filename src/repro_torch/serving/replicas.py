"""Data-parallel engine replicas behind one Scheduler.

A :class:`ReplicaSet` scales the serving tier horizontally: N replicas (or
N disaggregated worker groups) serve one admission queue, the Scheduler
staying the single control point.

Real mode: ``backends`` carries one worker-backend list per replica (one
:class:`repro_torch.core.backends.RealCompute` without disaggregation, D of
them with). A plan is assigned the least-loaded replica at admission, and
its decode phase moves to the replica's backend at the first decode op
through the pools' ``swap_out`` / ``swap_in`` handoff; the batch former
groups by backend, so every batch stays within one replica. The simulated
replicas (one FIFO compute channel each) come with the sim slice; the
channel names are fixed here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.serving.disagg import DisaggTopology


def replica_channel(r: int) -> str:
    """The one compute channel of replica `r` (no disaggregation)."""
    return f"compute:r{r}"


@dataclasses.dataclass
class ReplicaSet:
    """N data-parallel serving replicas behind one Scheduler.

    ``topology`` (optional) gives every replica its own prefill/decode
    worker split. ``backends`` (real mode) maps replica -> its worker-backend
    list; when set, its length overrides ``n_replicas``.
    """

    n_replicas: int = 1
    topology: Optional[DisaggTopology] = None
    backends: Optional[List[List[object]]] = None

    def __post_init__(self):
        if self.backends is not None:
            self.n_replicas = len(self.backends)
            if any(not bs for bs in self.backends):
                raise ValueError(
                    "every replica needs at least one worker backend")
        if self.n_replicas < 1:
            raise ValueError(
                f"ReplicaSet needs at least one replica, got "
                f"{self.n_replicas}")

    @classmethod
    def parse(cls, spec: str) -> "ReplicaSet":
        """Parse a ``--replicas N`` count spec like "4"."""
        try:
            return cls(n_replicas=int(spec))
        except ValueError:
            raise ValueError(
                f"--replicas expects a positive integer replica count, "
                f"got {spec!r}") from None

    def prefill_channels(self, r: int) -> List[str]:
        """Replica `r`'s admission channels (its prefill workers under a
        per-replica topology, else its single compute channel)."""
        if self.topology is None:
            return [replica_channel(r)]
        return [f"{replica_channel(r)}:p{j}"
                for j in range(self.topology.n_prefill)]

    def decode_channels(self, r: int) -> List[str]:
        """Replica `r`'s decode-phase channels (== prefill channels when no
        per-replica topology splits the phases)."""
        if self.topology is None:
            return [replica_channel(r)]
        return [f"{replica_channel(r)}:d{j}"
                for j in range(self.topology.n_decode)]

    @property
    def all_channels(self) -> List[str]:
        names = []
        for r in range(self.n_replicas):
            for c in self.prefill_channels(r) + self.decode_channels(r):
                if c not in names:
                    names.append(c)
        return names

    def attach_sim(self, ex):
        """Register the replicas' channels on a simulated executor: the sim
        slice of the port brings it."""
        raise NotImplementedError("the simulated replicas come with the port's sim slice")
