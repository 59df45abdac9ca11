"""Device meshes: named axes over a grid of devices.

A :class:`Mesh` names its axes, gives each axis's size (``mesh.shape[a]``,
as a JAX mesh reads) and holds the devices in the mesh's shape. Nothing
here launches or communicates: a mesh says which device owns which shard,
and the code that runs over it (``launch/sharded_sparse.py``) moves the
shards' partials and combines them with plain tensor ops where the JAX
package's ``shard_map`` bodies call ``pmax`` / ``psum``.

The mesh is one process's view of its local devices, not a
``torch.distributed`` process group. The serving tier it exists for is one
process driving every local device, as the JAX package's ``serve`` drives
them through ``shard_map``: over a host's distinct cards its shards' work
runs on their own cards, their tensors move between cards by peer copies,
and every kernel launches under its tensors' device (the wrappers' own
guard, ``kernels/build.py:on_own_device``). A process group waits for a
mesh over more than one host. A device may appear more than once:
``[cuda:0] * k`` (or ``[cpu] * k``) is a mesh of k shards on one device,
which stands where the JAX tests force k host devices, so the CPU tests
and a one-card machine run the k-shard path. :func:`synchronize` and
:func:`peak_memory` read every card of a mesh, where ``torch.cuda``'s
calls without a device read the current one alone.

The builders take ``devices=`` explicitly and default to every local CUDA
device; with no CUDA device and no ``devices=`` they raise, never falling
back to the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over devices: ``shape[a]`` is axis ``a``'s size and
    ``devices`` a numpy object array of ``torch.device`` in the mesh's
    shape (axes in ``axis_names`` order)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: np.ndarray


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _local_devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [_device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= to build a mesh on the CPU "
                           "(e.g. [torch.device('cpu')] * n)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], devices: list) -> Mesh:
    n = math.prod(shape)
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(tuple(axes), dict(zip(axes, shape)), grid.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False, kv_split: int = 0,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 devices a pod; ``multi_pod`` adds a leading 2-pod axis.

    ``kv_split=k`` factors the 16-way tensor axis into (kv=k, rep=16/k), so
    kv-head dims shard exactly on ``kv``. Takes the first 256 (512) of the
    devices and raises if there are fewer."""
    if kv_split:
        if kv_split < 1 or 16 % kv_split:
            raise ValueError(f"kv_split={kv_split} must be positive and divide 16")
        tp = (kv_split, 16 // kv_split)
        shape = (2, 16) + tp if multi_pod else (16,) + tp
        axes = ("pod", "data", "kv", "rep") if multi_pod else ("data", "kv", "rep")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _local_devices(devices)
    n = math.prod(shape)
    if len(devs) < n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {n} devices, "
                         f"{len(devs)} given")
    return _make_mesh(shape, axes, devs)


def tp_axes(mesh: Mesh) -> tuple:
    """Axis names carrying tensor parallelism."""
    return ("kv", "rep") if "kv" in mesh.axis_names else ("model",)


def kv_axes(mesh: Mesh) -> tuple:
    """Axis names for KV-head sharding (a subset of tp_axes on a GQA mesh)."""
    return ("kv",) if "kv" in mesh.axis_names else ("model",)


def dp_axes(mesh: Mesh) -> tuple:
    """Axis names that carry pure data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_serving_mesh(*, kv_split: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """Tensor-parallel mesh for the serving tier's decode backend.

    256 devices or more get the production mesh; fewer turn every device
    into tensor parallelism: ``kv_split=k`` factors them into (kv=k,
    rep=n/k), else one flat "model" axis."""
    devs = _local_devices(devices)
    n = len(devs)
    if n >= 256:
        return make_production_mesh(kv_split=kv_split, devices=devs)
    if kv_split:
        if kv_split < 1 or n % kv_split:
            raise ValueError(f"kv_split={kv_split} must be positive and divide the "
                             f"local device count {n}")
        return _make_mesh((kv_split, n // kv_split), ("kv", "rep"), devs)
    return _make_mesh((n,), ("model",), devs)


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first data * model devices."""
    devs = _local_devices(devices)
    if data < 1 or model < 1 or data * model > len(devs):
        raise ValueError(f"a {data} x {model} mesh over {len(devs)} devices")
    return _make_mesh((data, model), ("data", "model"), devs)


def shard_positions(mesh: Mesh, axes: Sequence[str]) -> list:
    """The mesh position of each shard over ``axes``, in the order of the
    flattened shard index (row-major over ``axes``, as ``lax.axis_index``
    numbers a tuple of axes); every other axis is taken at index 0, where
    its replicas of the shard lie."""
    at = [mesh.axis_names.index(a) for a in axes]
    return [tuple(p[at.index(i)] if i in at else 0 for i in range(len(mesh.axis_names)))
            for p in np.ndindex(*(mesh.devices.shape[i] for i in at))]


def shard_devices(mesh: Mesh, axes: Sequence[str]) -> list:
    """The device of each shard over ``axes`` (:func:`shard_positions`)."""
    return [mesh.devices[pos] for pos in shard_positions(mesh, axes)]


def distinct_devices(mesh: Mesh) -> list:
    """The mesh's devices, each once, in the mesh's order."""
    return list(dict.fromkeys(mesh.devices.flat))


def synchronize(mesh: Mesh) -> None:
    """Wait for the work queued on every CUDA device of ``mesh``: a step
    over several cards has ended when its last card has, and
    ``torch.cuda.synchronize()`` without a device waits for the current
    one alone."""
    for d in distinct_devices(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def reset_peak_memory(mesh: Mesh) -> None:
    """``torch.cuda.reset_peak_memory_stats`` on every CUDA device of the
    mesh."""
    for d in distinct_devices(mesh):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def peak_memory(mesh: Mesh) -> Dict[str, int]:
    """Each CUDA device's peak allocated bytes since its last reset
    (``torch.cuda.max_memory_allocated(d)``), by device name."""
    return {str(d): torch.cuda.max_memory_allocated(d) for d in distinct_devices(mesh)
            if d.type == "cuda"}
