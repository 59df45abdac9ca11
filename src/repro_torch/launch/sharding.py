"""Sharding rules, and tensors laid out on a device mesh.

The rules are the JAX package's (``repro/launch/sharding.py``): 2D
FSDP(data) x TP for params, DP batch, EP experts, in two tensor-parallel
layouts:
  flat   mesh (data, model)        — head dims that don't divide the tensor
         axis fall back to contraction-dim sharding;
  GQA    mesh (data, kv, rep)      — kv-head dims shard exactly on `kv`,
         q-heads/d_ff/vocab on ("kv","rep").
The `pod` axis is pure DP in both layouts. ``param_specs`` and the other
rule functions give the same :class:`P` answers as JAX's for every config
and mesh.

JAX lays a tree on a mesh with ``jax.device_put(tree, shardings)`` and gets
it back with ``np.asarray``; the port does it with :func:`shard` and
:func:`unshard` (:func:`shard_tree` / :func:`unshard_tree` over a pytree).
A :class:`ShardedTensor` holds one block a mesh position, each on the
position's device and each owning its storage, also where two positions
share a device or hold the same (replicated) block.

The mesh is :class:`repro_torch.launch.mesh.Mesh`: one process drives every
device, as the JAX package's single controller does, and the train step
over a mesh (``launch/steps.py``) runs each data-parallel shard's forward
and backward in turn and combines them with plain tensor ops where JAX's
``jit`` partitions the step. A ``torch.distributed`` process group (a
process a rank) is not used: one process drives a host's cards, and a mesh
of ``[cuda:0] * k`` runs the k-shard path on one card and ``[cpu] * k`` in
the CPU tests against JAX on k forced host devices.
``init_params(..., shardings=)`` (:class:`LaidOutLeaves`) makes a model's
params straight into their blocks, so a model no one device holds can be
laid out over several.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, dp_axes, kv_axes, tp_axes
from repro_torch.models.common import Leaves, ModelConfig
from repro_torch.tree import tree_map


def _entry(e):
    """JAX's normal form of a spec entry: a one-name tuple is the name, an
    empty tuple is None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """The port's ``PartitionSpec``: a tuple with one entry a tensor dim
    (None, an axis name or a tuple of names; missing trailing dims are
    None). Entries are kept in JAX's normal form, so a spec compares equal
    to the tuple of JAX's and prints as JAX's does."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec({tuple.__repr__(self)[1:-1]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over the axes of ``mesh``. Raises ValueError, as JAX's does,
    for a spec naming an axis the mesh lacks."""

    mesh: Mesh
    spec: P

    def __post_init__(self):
        for e in self.spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                if a not in self.mesh.axis_names:
                    raise ValueError(f"Resource axis: {a} of {self.spec} is not found in "
                                     f"mesh: {tuple(self.mesh.axis_names)}.")


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------
def param_specs(cfg: ModelConfig, mesh, *, fsdp: bool = True) -> Dict[str, Any]:
    """A tree of :class:`P` in ``init_params``' structure.

    fsdp=True shards weight d_model/d_ff dims over `data` too (ZeRO-3).
    Dims that don't divide their axis fall back to contraction-dim
    sharding."""
    d_axis = "data" if fsdp else None
    TP = tp_axes(mesh)
    KV = kv_axes(mesh)
    tp_n = _axis_size(mesh, TP)
    kv_n = _axis_size(mesh, KV)

    lp: Dict[str, Any] = {}
    if cfg.has_attention:
        h_ok = cfg.n_heads % tp_n == 0
        kv_ok = cfg.n_kv_heads % kv_n == 0
        lp["wq"] = (P(None, d_axis, TP, None) if h_ok
                    else P(None, TP, None, d_axis))
        lp["wk"] = (P(None, d_axis, KV, None) if kv_ok
                    else P(None, TP, None, d_axis))
        lp["wv"] = lp["wk"]
        lp["wo"] = (P(None, TP, None, d_axis) if h_ok
                    else P(None, None, TP, d_axis))
        lp["attn_norm"] = P(None, None)
        if cfg.qkv_bias:
            lp["bq"] = P(None, TP, None) if h_ok else P(None, None, TP)
            lp["bk"] = P(None, KV, None) if kv_ok else P(None, None, TP)
            lp["bv"] = lp["bk"]
        if cfg.qk_norm:
            lp["q_norm"] = P(None, None)
            lp["k_norm"] = P(None, None)
    if cfg.family in ("ssm", "hybrid"):
        lp["mamba"] = {
            "w_in": P(None, d_axis, TP),
            "conv_w": P(None, None, TP),
            "conv_b": P(None, TP),
            "w_x": P(None, TP, None),
            "dt_bias": P(None),
            "A_log": P(None, TP, None),
            "D": P(None, TP),
            "w_out": P(None, TP, d_axis),
        }
        if cfg.family == "ssm":
            lp["attn_norm"] = P(None, None)
    if cfg.family == "moe":
        if cfg.n_experts % tp_n == 0:  # expert parallelism
            lp["moe"] = {
                "w_router": P(None, None, None),
                "w_gate": P(None, TP, d_axis, None),
                "w_up": P(None, TP, d_axis, None),
                "w_down": P(None, TP, None, d_axis),
            }
        else:  # TP inside each expert (8/40 experts don't divide 16)
            lp["moe"] = {
                "w_router": P(None, None, None),
                "w_gate": P(None, None, d_axis, TP),
                "w_up": P(None, None, d_axis, TP),
                "w_down": P(None, None, TP, d_axis),
            }
        lp["ffn_norm"] = P(None, None)
    elif cfg.d_ff and cfg.family != "ssm":
        lp["w_gate"] = P(None, d_axis, TP)
        lp["w_up"] = P(None, d_axis, TP)
        lp["w_down"] = P(None, TP, d_axis)
        lp["ffn_norm"] = P(None, None)
    v_ok = cfg.vocab_size % tp_n == 0
    specs: Dict[str, Any] = {
        "embed": P(TP, d_axis) if v_ok else P(None, TP),
        "layers": lp,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(d_axis, TP) if v_ok else P(TP, None)
    return specs


def param_shardings(cfg: ModelConfig, mesh, *, fsdp: bool = True):
    return tree_map(lambda s: NamedSharding(mesh, s), param_specs(cfg, mesh, fsdp=fsdp))


def batch_specs(cfg: ModelConfig, mesh, batch: int, seq: int, *, training: bool):
    """Shardings for the input batch dict: rows over the dp axes from a
    batch of 16 on."""
    dp = dp_axes(mesh)
    bspec = P(dp, None) if batch >= 16 else P(None, None)
    out: Dict[str, Any] = {}
    if cfg.frontend:
        espec = P(dp, None, None) if batch >= 16 else P(None, None, None)
        out["embeds"] = NamedSharding(mesh, espec)
    else:
        out["tokens"] = NamedSharding(mesh, bspec)
    if training:
        out["labels"] = NamedSharding(mesh, bspec)
    return out


def serve_state_shardings(cfg: ModelConfig, mesh, batch: int):
    """KV/SSM state shardings: on the GQA mesh the cache shards by kv-head
    exactly; on the flat mesh the cache *sequence* dim shards over the TP
    axis instead (split-KV). batch >= 16 also shards batch over dp; a
    smaller batch spreads the sequence over every remaining axis."""
    dp = dp_axes(mesh)
    TP = tp_axes(mesh)
    KV = kv_axes(mesh)
    kv_ok = (cfg.n_kv_heads % _axis_size(mesh, KV) == 0) if cfg.has_attention else False
    out: Dict[str, Any] = {"length": NamedSharding(mesh, P())}
    if cfg.has_attention:
        if batch >= 16:
            spec = (P(None, dp, None, KV, None) if kv_ok
                    else P(None, dp, TP, None, None))
        else:
            if kv_ok:
                seq_axes = tuple(dp) + (("rep",) if "rep" in mesh.axis_names else ())
                spec = P(None, None, seq_axes, KV, None)
            else:
                seq_axes = tuple(dp) + TP
                spec = P(None, None, seq_axes, None, None)
        out["k"] = NamedSharding(mesh, spec)
        out["v"] = NamedSharding(mesh, spec)
    if cfg.family in ("ssm", "hybrid"):
        baxis = dp if batch >= 16 else None
        out["ssm_h"] = NamedSharding(mesh, P(None, baxis, TP, None))
        out["ssm_conv"] = NamedSharding(mesh, P(None, baxis, None, TP))
    return out


def opt_state_shardings(param_sh):
    """Adam m/v mirror the parameter shardings; step counter replicated
    (the caller fills ``step`` with ``NamedSharding(mesh, P())``)."""
    return {"m": param_sh, "v": param_sh, "step": None}


# --------------------------------------------------------------------------
# tensors on a mesh
# --------------------------------------------------------------------------
def _dim_axes(spec: P, ndim: int):
    """Each dim's axis names (a tuple, major first)."""
    if len(spec) > ndim:
        raise ValueError(f"{spec} has {len(spec)} entries for a tensor of {ndim} dims")
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if e is None else ((e,) if isinstance(e, str) else tuple(e)))
    return out


def block_index(shape, sharding: NamedSharding, pos) -> Tuple[slice, ...]:
    """The slices of a ``shape`` tensor held at mesh position ``pos`` (an
    index tuple in the mesh's axis order). Raises ValueError, as JAX's
    ``device_put`` does, where a dim does not divide its axes."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.axis_names, pos))
    out = []
    for dim, (n, axes) in enumerate(zip(shape, _dim_axes(sharding.spec, len(shape)))):
        parts = _axis_size(mesh, axes)
        if n % parts:
            raise ValueError(
                f"the sharding {sharding.spec} implies that the global size of dimension "
                f"{dim} should be divisible by {parts}, but it is equal to {n} "
                f"(full shape: {tuple(shape)})")
        i = 0
        for a in axes:  # row-major over the dim's axes, as JAX numbers them
            i = i * mesh.shape[a] + coord[a]
        size = n // parts
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """A global tensor laid out on a mesh: ``blocks`` is a numpy object
    array in the mesh's shape whose entry at each position is that
    position's block, on that position's device."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    blocks: np.ndarray

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def positions(self):
        return itertools.product(*(range(n) for n in self.blocks.shape))

    def block_at(self, pos) -> torch.Tensor:
        return self.blocks[tuple(pos)]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    from repro_torch.bridge import tensor_from_numpy

    return tensor_from_numpy(np.asarray(x), "cpu")


def shard(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a tensor or numpy array) laid out by ``sharding``: a copy of
    each position's slice on the position's device. No block aliases
    another or ``x``."""
    x = _as_tensor(x)
    mesh = sharding.mesh
    shape = tuple(x.shape)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in itertools.product(*(range(n) for n in mesh.devices.shape)):
        sl = block_index(shape, sharding, pos)
        blocks[pos] = x[sl].to(device=mesh.devices[pos], copy=True,
                                memory_format=torch.contiguous_format)
    return ShardedTensor(shape, x.dtype, sharding, blocks)


def unshard(st: ShardedTensor, device) -> torch.Tensor:
    """The global tensor on ``device``, from one block of each distinct
    slice (a replicated block is read once)."""
    out = torch.empty(st.shape, dtype=st.dtype, device=device)
    seen = set()
    for pos in st.positions():
        sl = block_index(st.shape, st.sharding, pos)
        key = tuple((s.start, s.stop) for s in sl)
        if key in seen:
            continue
        seen.add(key)
        out[sl] = st.block_at(pos)
    return out


def _bounds(sl: slice, n: int) -> Tuple[int, int]:
    lo, hi, step = sl.indices(n)
    if step != 1:
        raise ValueError(f"a piece of a sharded tensor takes unit-step slices, got {sl}")
    return lo, max(lo, hi)


def block_pieces(st: ShardedTensor, index: Tuple[slice, ...], near, *,
                 replicas: bool = False):
    """The pieces of the global slice ``st[index]`` (one unit-step slice a
    dim), one a distinct block that holds part of it: (mesh position, the
    piece's slices in the slice ``index`` selects, its slices in the
    block). A block held at several positions (a replica) is read where its
    coordinates on the axes its dims do not use are ``near``'s (a position
    tuple), so a position reads its own replicas; ``replicas=True`` gives
    every position that holds each piece (what a write must reach)."""
    bounds = tuple(_bounds(sl, n) for sl, n in
                   zip(tuple(index) + (slice(None),) * len(st.shape), st.shape))
    return _piece_plan(st.sharding, tuple(st.shape), bounds, tuple(near), replicas)


@functools.lru_cache(maxsize=1 << 16)
def _piece_plan(sharding: NamedSharding, shape, bounds, near, replicas: bool) -> tuple:
    """:func:`block_pieces`' answer, a pure function of the layout, the
    slice's bounds and the position: a step over a mesh asks for the same
    plans every layer and call."""
    mesh = sharding.mesh
    dims = _dim_axes(sharding.spec, len(shape))
    spans = []  # per dim: (axes, block size, [(part, lo, hi) of the parts the slice meets])
    los = []
    out = []
    for n, axes, (lo, hi) in zip(shape, dims, bounds):
        size = n // _axis_size(mesh, axes)
        los.append(lo)
        spans.append((axes, size, [(i, max(lo, i * size), min(hi, (i + 1) * size))
                                   for i in range(lo // size, -(-hi // size))]))
    used = {a for axes in dims for a in axes}
    free = [a for a in mesh.axis_names if a not in used] if replicas else []
    copies = itertools.product(*(range(mesh.shape[a]) for a in free))
    for rep, combo in itertools.product(list(copies), itertools.product(
            *(parts for _, _, parts in spans))):
        coord = dict(zip(mesh.axis_names, near))
        coord.update(zip(free, rep))
        for (axes, _, _), (i, _, _) in zip(spans, combo):
            for a in reversed(axes):  # row-major over the dim's axes
                coord[a], i = i % mesh.shape[a], i // mesh.shape[a]
        out_sl = tuple(slice(a - lo, b - lo) for (_, a, b), lo in zip(combo, los))
        blk_sl = tuple(slice(a - i * size, b - i * size)
                       for ((_, size, _), (i, a, b)) in zip(spans, combo))
        out.append((tuple(coord[a] for a in mesh.axis_names), out_sl, blk_sl))
    return tuple(out)


@functools.lru_cache(maxsize=1 << 16)
def _gather_plan(sharding: NamedSharding, shape, bounds, near) -> tuple:
    """(the pieces as (position, block slices, whether they cover the
    block), the number of blocks each dim's pieces span, whether any piece
    lies at another position than ``near``) of :func:`gather_slice`."""
    sizes = [n // _axis_size(sharding.mesh, axes)
             for n, axes in zip(shape, _dim_axes(sharding.spec, len(shape)))]
    pieces = _piece_plan(sharding, shape, bounds, near, False)
    grid = tuple(len({p[1][d].start for p in pieces}) for d in range(len(shape)))
    return (tuple((pos, blk_sl, all(sl.stop - sl.start == n for sl, n in zip(blk_sl, sizes)))
                  for pos, _, blk_sl in pieces),
            grid, any(pos != near for pos, _, _ in pieces))


def gather_slice(st: ShardedTensor, index: Tuple[slice, ...], device, near):
    """``st[index]`` on ``device``, assembled from the blocks that hold it
    (:func:`block_pieces`, replicas read near ``near``). Returns (the
    tensor, the number of blocks read, whether any lies at another position
    than ``near``). A slice of ``near``'s own block on ``device`` comes back
    as a view of the block, uncopied."""
    bounds = tuple(_bounds(sl, n) for sl, n in
                   zip(tuple(index) + (slice(None),) * len(st.shape), st.shape))
    pieces, grid, remote = _gather_plan(st.sharding, tuple(st.shape), bounds, tuple(near))
    parts = [st.block_at(pos) if whole else st.block_at(pos)[blk_sl]
             for pos, blk_sl, whole in pieces]
    if len(parts) == 1:
        if not remote and parts[0].device == torch.device(device):
            return parts[0], 1, False
        return parts[0].to(device, copy=True), 1, remote
    # the pieces come in row-major order over a grid of blocks: join each
    # dim's runs of them, innermost dim first
    items = [p.to(device) for p in parts]
    for d in reversed(range(len(grid))):
        if grid[d] > 1:
            items = [torch.cat(items[i: i + grid[d]], dim=d)
                     for i in range(0, len(items), grid[d])]
    return items[0], len(parts), remote


class LaidOutLeaves(Leaves):
    """``init_params``' leaves laid out on a mesh (``init_params(...,
    shardings=)``): each a :class:`ShardedTensor` bit for bit
    :func:`shard` of the leaf ``Leaves`` would make.

    The draws are ``Leaves``' own, on the generator's device in the same
    order. A stacked leaf's blocks are allocated on their devices and each
    layer's cast draw is copied into every block that holds part of it
    before the next layer is drawn, so at most one layer's float32 draw of
    one leaf lives beside the blocks. A leaf drawn whole (the embedding, the
    unembedding) and a constant one are made whole on the generator's
    device and sharded."""

    def __init__(self, generator, device, shardings):
        super().__init__(generator, device)
        self.shardings = shardings

    def _sharding(self, path) -> NamedSharding:
        sh = self.shardings
        for k in path:
            sh = sh[k]
        return sh

    def stacked(self, path, layers: int, shape, std: float, dtype) -> ShardedTensor:
        sh = self._sharding(path)
        mesh, full = sh.mesh, (layers,) + tuple(shape)
        blocks = np.empty(mesh.devices.shape, dtype=object)
        where = {}
        for pos in itertools.product(*(range(n) for n in mesh.devices.shape)):
            where[pos] = block_index(full, sh, pos)
            blocks[pos] = torch.empty(tuple(sl.stop - sl.start for sl in where[pos]),
                                      dtype=dtype, device=mesh.devices[pos])
        for l in range(layers):
            x = self.draw(shape, std).to(dtype)
            for pos, sl in where.items():
                if sl[0].start <= l < sl[0].stop:
                    blocks[pos][l - sl[0].start] = x[sl[1:]]
            del x
        return ShardedTensor(full, dtype, sh, blocks)

    def normal(self, path, shape, std: float, dtype) -> ShardedTensor:
        return shard(super().normal(path, shape, std, dtype), self._sharding(path))

    def const(self, path, make) -> ShardedTensor:
        return shard(make(self.device), self._sharding(path))


def shard_tree(tree, shardings):
    """:func:`shard` over a pytree; a None leaf of ``shardings`` keeps the
    leaf as it is, as ``jax.device_put`` with a None sharding does not move
    it."""
    return tree_map(lambda sh, x: x if sh is None else shard(x, sh), shardings, tree)


def unshard_tree(tree, device):
    """:func:`unshard` over a pytree of :class:`ShardedTensor` leaves; a
    tensor leaf is moved to ``device`` and a None leaf kept."""
    def one(x):
        if isinstance(x, ShardedTensor):
            return unshard(x, device)
        return None if x is None else x.to(device)

    return tree_map(one, tree)
