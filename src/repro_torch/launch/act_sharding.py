"""Activation-sharding policy: the JAX package's trace-time hints, as specs.

In the JAX package, model code stays sharding-agnostic and, when a policy
is active, ``constrain(x, role)`` pins activation shardings for GSPMD:

  hidden  (b, s, d)      -> P(dp, None, None)
  heads   (b, s, H, dh)  -> P(dp, None, 'model', None)  if H >= model axis
                         -> P(dp, 'model', None, None)  otherwise (sequence
                            parallelism)

:func:`activation_spec` gives the spec JAX's ``constrain`` pins for a shape
and role under a policy. The port's :func:`constrain` returns ``x``
unchanged, with or without a policy: the port has no partitioner to take a
hint. Its steps over a mesh lay activations out themselves: the train step
(``launch/steps.py``) by its own batch split, each data-parallel shard's
rows on that shard's device, which is ``P(dp, ...)``, what ``hidden`` asks
for; the serving steps (``launch/tp_compute.py``) by that split where the
batch is 16 or more, and each tensor shard's q / k / v by its own heads,
which is ``heads``' kv-head or full-head sharding (the sequence-parallel
form is not used). The model code calls ``constrain`` at the reference's
three sites (q, k and v in ``qkv_project``, the MoE and the dense FFN's
residual returns), so that the two packages' model code reads alike.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.launch.sharding import NamedSharding, P

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)


@dataclasses.dataclass(frozen=True)
class Policy:
    mesh: object
    dp: Tuple[str, ...]
    tp: Tuple[str, ...]  # full tensor axis(es)
    kv: Tuple[str, ...]  # kv-head sub-axis (== tp on a flat mesh)
    shard_batch: bool = True  # False for batch=1 cells
    seq_parallel: bool = False  # Megatron-SP: hidden states shard seq over TP

    def _size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp_size(self) -> int:
        return self._size(self.tp)

    @property
    def kv_size(self) -> int:
        return self._size(self.kv)


@contextlib.contextmanager
def activation_sharding(mesh, *, shard_batch: bool = True, seq_parallel: bool = False):
    from repro_torch.launch.mesh import dp_axes, kv_axes, tp_axes

    token = _POLICY.set(Policy(mesh=mesh, dp=dp_axes(mesh), tp=tp_axes(mesh),
                               kv=kv_axes(mesh), shard_batch=shard_batch,
                               seq_parallel=seq_parallel))
    try:
        yield
    finally:
        _POLICY.reset(token)


def current_policy() -> Optional[Policy]:
    return _POLICY.get()


def activation_spec(shape: Sequence[int], role: str,
                    policy: Optional[Policy]) -> Optional[P]:
    """The spec JAX's ``constrain`` pins on an activation of ``shape`` in
    ``role`` under ``policy``; None where it pins nothing (no policy, an
    unknown role or a rank the role does not take). Raises ValueError where
    JAX's does: a spec naming an axis the policy's mesh lacks."""
    spec = _spec(shape, role, policy)
    return None if spec is None else NamedSharding(policy.mesh, spec).spec


def _spec(shape, role, policy):
    if policy is None:
        return None
    dp = policy.dp if policy.shard_batch else None
    if role == "hidden" and len(shape) == 3:
        return (P(dp, policy.tp, None) if policy.seq_parallel and shape[1] > 1
                else P(dp, None, None))
    if role == "heads" and len(shape) == 4:
        _, s, h, _ = shape
        if h % policy.kv_size == 0 and h < policy.tp_size:
            return P(dp, None, policy.kv, None)  # exact kv-head sharding
        if h >= policy.tp_size:
            return P(dp, None, policy.tp, None)  # (padded) full head sharding
        if s > 1:
            return P(dp, policy.tp, None, None)  # sequence parallelism
        return P(dp, None, None, None)
    return None


def constrain(x, role: str):
    """``x`` unchanged: the port's mesh steps lay activations out
    themselves (see the module docstring)."""
    return x
