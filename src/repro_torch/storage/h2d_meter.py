"""Host-to-device transfer meter for the port.

The pool and backend code moves host data to the device through five torch
doors only: ``Tensor.to``, ``Tensor.cuda``, ``torch.as_tensor(device=)``,
``torch.tensor(device=)`` and ``Tensor.copy_`` from a host source. The meter
patches the five for the duration of a ``with`` block and records every
call that carries a host-sourced tensor, array or Python sequence toward the
meter's device, with its size in bytes.

It counts by door and source, not by the bytes that really crossed a bus:
on the CPU the "device" is the CPU and nothing crosses, yet a host pool's
per-step upload still passes a door with a host source toward it, so a test
on the CPU sees the same transfers as a run on the card. A device-resident
source is never counted, and neither is a call that only changes the dtype.
"""
from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    return np.asarray(x).nbytes


def _is_host(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "cpu"
    return True  # numpy arrays, Python scalars and sequences


def _to_device(args, kwargs):
    """The device a ``Tensor.to`` call moves to, or None for a dtype-only
    call: ``to(device, ...)``, ``to(other_tensor)`` or ``to(device=...)``."""
    if "device" in kwargs and kwargs["device"] is not None:
        return torch.device(kwargs["device"])
    if args:
        a = args[0]
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (str, torch.device, int)) and not isinstance(a, bool):
            return torch.device(a)
    return None


class H2DMeter:
    """Context manager recording host-sourced transfers toward ``device``.

    ``transfers`` holds (door, bytes) in call order; ``total`` and
    ``largest`` sum and bound their bytes. The patches are process-wide
    while the block runs; calls from other threads are recorded too."""

    _DOORS = ("to", "cuda", "copy_")

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.transfers: List[Tuple[str, int]] = []
        self._lock = threading.Lock()
        self._saved = None

    def _record(self, door: str, src, dst) -> None:
        if dst is not None and torch.device(dst).type == self.device.type and _is_host(src):
            with self._lock:
                self.transfers.append((door, _nbytes(src)))

    def __enter__(self):
        meter = self
        saved = {name: torch.Tensor.__dict__.get(name) for name in self._DOORS}
        real = {name: getattr(torch.Tensor, name) for name in self._DOORS}
        real_as_tensor, real_tensor = torch.as_tensor, torch.tensor
        self._saved = (saved, real_as_tensor, real_tensor)

        def to(self, *args, **kwargs):
            meter._record("to", self, _to_device(args, kwargs))
            return real["to"](self, *args, **kwargs)

        def cuda(self, *args, **kwargs):
            meter._record("cuda", self, "cuda")
            return real["cuda"](self, *args, **kwargs)

        def copy_(self, src, *args, **kwargs):
            if isinstance(src, torch.Tensor):
                meter._record("copy_", src, self.device)
            return real["copy_"](self, src, *args, **kwargs)

        def as_tensor(data, *args, **kwargs):
            meter._record("as_tensor", data, kwargs.get("device"))
            return real_as_tensor(data, *args, **kwargs)

        def tensor(data, *args, **kwargs):
            meter._record("tensor", data, kwargs.get("device"))
            return real_tensor(data, *args, **kwargs)

        torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.copy_ = to, cuda, copy_
        torch.as_tensor, torch.tensor = as_tensor, tensor
        return self

    def __exit__(self, *exc):
        saved, real_as_tensor, real_tensor = self._saved
        for name, attr in saved.items():
            if attr is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, attr)
        torch.as_tensor, torch.tensor = real_as_tensor, real_tensor
        return False

    @property
    def total(self) -> int:
        return sum(n for _, n in self.transfers)

    @property
    def largest(self) -> int:
        return max((n for _, n in self.transfers), default=0)
