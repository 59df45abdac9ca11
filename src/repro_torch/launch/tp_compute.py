"""Steps over a device mesh, serving and training: the port's stand-in for
GSPMD.

The JAX package runs a step over a mesh by jitting it on params laid out by
``param_shardings`` (and tokens by ``batch_specs``, the serve state by
``serve_state_shardings``); XLA's SPMD partitioner (GSPMD) then splits each
layer's compute by the params' specs and inserts the collectives that join
the pieces, and ``jax.grad`` differentiates the partitioned step. The port
has no partitioner, as it has no HLO (``launch/roofline.py``'s
``StepAnalyzer`` stands where the HLO parser stands): :class:`MeshServe`
runs every mesh position's share of each layer itself, one process driving
every device of the mesh, and joins the shares with autograd Functions where
GSPMD's collectives stand. One layer body serves the prefill and decode
steps (under ``torch.no_grad``) and the train step's forward, whose backward
autograd runs through the joins.

A position is (dp shard j, tensor shard t): j row-major over the dp axes,
t over the tensor axes (``launch/mesh.py``). Where ``batch_specs`` splits
the batch (batch >= 16) each dp shard computes its rows; otherwise the
whole batch runs on dp shard 0's positions (the train step splits each
microbatch itself, ``launch/steps.py``). Per layer, each computing
position:

- gathers its tensor shard's slice of the layer's weights from the blocks
  that hold it: over the dp axes (FSDP), and over the tensor axes too where
  ``param_specs`` fell back to splitting a weight along another dim than the
  one the compute splits (heads, kv heads or the vocabulary that do not
  divide the axis; mamba's ``w_in``, whose x and z columns lie in two
  blocks); it frees them after the layer;
- attention: projects and attends over its q heads (split ceil-wise: the
  last shards take fewer), with the kv heads those heads read (a kv head
  two shards read is computed by both); ``wo`` is row-parallel;
- SwiGLU by d_ff columns (``w_gate``, ``w_up`` column-parallel, ``w_down``
  row-parallel); an MoE layer routes once, replicated, with the whole
  batch's capacity and dispatch (``moe.MoeRoute`` across dp shards), runs
  its experts (where ``n_experts`` divides the tensor axes) or each
  expert's d_ff columns, and combines once;
- mamba by d_inner channels: ``w_in``'s columns, the conv taps, ``A_log``,
  ``D`` and the scan over the shard's channels, ``w_x``'s partial (dt, B, C)
  summed over the shards before the scan, ``w_out`` row-parallel;
- the logits by vocabulary columns (split ceil-wise): serving gathers them
  on the mesh's first device; training never forms them whole: each
  shard's row maxima are joined, then its rows' sums of exp(z - m) (two
  all-reduces of a float a row), then its labels' logits
  (:class:`_VocabShard`) into the loss (:class:`_VocabJoin`).

The joins, each an autograd Function that declares its collective to a step
analyzer:

- the weight gather (:class:`_WeightGather`): forward the slice gathered
  from its blocks (an all-gather; a permute from one block elsewhere);
  backward the slice's gradient added in float32 into each source block's
  accumulator (:class:`GradSink`) at the block's place (a reduce-scatter),
  a block that feeds several gathers of a layer (a kv head two shards read,
  a replicated norm scale) taking their sum in the gathers' order, which is
  shard order;
- the row-parallel sum (:class:`_RowSum`): forward the partials summed in
  shard order on the part's first device in float32, rounded once (an
  all-reduce); backward the gradient handed unchanged to each shard;
- the replicated activation (:class:`_Broadcast`): forward a copy on each
  shard's device; backward the shards' gradients summed in float32 in
  shard order on the first device, rounded once (an all-reduce).

GSPMD keeps the residual stream replicated over the tensor shards, so the
two broadcasts above (the activation's copy, the sum's gradient) move
nothing on its mesh, and they declare nothing. The experts' outputs join by
:class:`_ExpertCat` (an all-to-all both ways), the vocabulary shards' loss
statistics by :class:`_VocabJoin` (an all-reduce). A join's own sums and
copies run under ``roofline.uncounted``: they are its collective's work.
Serving writes the new K/V and mamba state into every block that holds them
(a collective-permute where the block lies at another position); its decode
attends each cache block where it lies and merges a row's blocks with the
flash-decode combine (``sharded_sparse.combine_partials``) in block order.

ContiguousKV's sparse decode (:meth:`MeshServe.sparse_decode`) runs the same
layer body with a sparse attend in the decode attend's place. Each tensor
shard scores the chunks of every cache block that holds its kv heads, where
the block lies: its q heads against the block's chunk-mean keys (the block's
K averaged a chunk, or its ``kmean`` block), summed in float32 over the
heads. The shards' (b, m) partials are summed in float32 in shard order on
the part's first device (an all-reduce of b x m floats), the chunks past the
new token masked, and one top-k (``steps.top_chunks``) gives every shard the
same picks. Each block then attends over the picked chunks it holds and the
blocks merge by the same combine; a block that holds none of a row's picks
weighs 0 there. With cached summaries the new key's 1/c share is added to
its chunk's ``kmean`` row once a kv head, by the first shard that holds the
head, and written into every block that holds the row.

Exactness: on a 1 x 1 mesh the steps are bit for bit the unsharded steps;
on a k x 1 mesh, bit for bit the unsharded steps over each dp shard's rows
(serving at batch >= 16); elsewhere they differ by the order of the float32
sums above (the sparse decode's picks too, where two chunks' scores lie
within that order's rounding).

To a step analyzer, the dp shards, the tensor shards and the cache blocks
are loops (``roofline.loop``) with their share of a device, and each join
and write above a declared collective, the chunk scores' sum an all-reduce.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import Mesh, dp_axes, tp_axes
from repro_torch.launch.sharded_sparse import _on, combine_partials
from repro_torch.launch.sharding import (NamedSharding, ShardedTensor, block_index, block_pieces,
                                         gather_slice)
from repro_torch.models import transformer as T
from repro_torch.models.attention import (NEG_INF, _grouped_out, _grouped_scores,
                                         attention_decode, qkv_project)
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import matmul, rms_norm, swiglu
from repro_torch.models.moe import MoeRoute, combine, expert_ffn, route_tokens
from repro_torch.models.ssm import (check_scan_dtype, mamba_decode_in, mamba_decode_out,
                                    mamba_in, mamba_out)
from repro_torch.tree import tree_leaves, tree_replace_leaves

ALL = slice(None)


def split(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Part i of n items split ceil-wise over ``parts``: [i c, (i + 1) c)
    clipped to n, c = ceil(n / parts); the last parts take fewer, or none."""
    c = -(-n // parts)
    return min(n, i * c), min(n, (i + 1) * c)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Shard:
    """What tensor shard t computes: q heads, the kv heads they read
    (``kv_index``: each q head's index into them where the heads are not
    whole groups, else None), dense d_ff columns, experts and each expert's
    d_ff columns, mamba channels and vocabulary columns, each [lo, hi)."""

    heads: Tuple[int, int]
    kv: Tuple[int, int]
    kv_index: Optional[Tuple[int, ...]]
    ff: Tuple[int, int]
    experts: Tuple[int, int]
    moe_ff: Tuple[int, int]
    channels: Tuple[int, int]
    vocab: Tuple[int, int]


def kv_index(h0: int, h1: int, group: int, kv0: int) -> Optional[Tuple[int, ...]]:
    """Each q head of [h0, h1)'s index into its kv heads from kv0, or None
    where the heads are whole groups of those kv heads (GQA takes them as
    they are)."""
    idx = tuple(h // group - kv0 for h in range(h0, h1))
    n_kv = idx[-1] + 1 if idx else 0
    if n_kv and len(idx) % n_kv == 0 and idx == tuple(i // (len(idx) // n_kv)
                                                       for i in range(len(idx))):
        return None
    return idx


def plan_shards(cfg: ModelConfig, n_tp: int) -> List[Shard]:
    out = []
    for t in range(n_tp):
        h0, h1 = split(cfg.n_heads, n_tp, t) if cfg.has_attention else (0, 0)
        g = cfg.n_heads // cfg.n_kv_heads if cfg.has_attention else 1
        kv = (h0 // g, (h1 - 1) // g + 1) if h1 > h0 else (0, 0)
        ep = cfg.family == "moe" and cfg.n_experts % n_tp == 0
        out.append(Shard(
            heads=(h0, h1), kv=kv, kv_index=kv_index(h0, h1, g, kv[0]) if h1 > h0 else None,
            ff=split(cfg.d_ff, n_tp, t),
            experts=split(cfg.n_experts, n_tp, t) if ep else (0, cfg.n_experts),
            moe_ff=(0, cfg.moe_d_ff) if ep else split(cfg.moe_d_ff, n_tp, t),
            channels=split(cfg.d_inner, n_tp, t) if cfg.family in T.STATE_FAMILIES else (0, 0),
            vocab=split(cfg.vocab_size, n_tp, t)))
    return out


# --------------------------------------------------------------------------
# reads and writes of a tensor laid out on the mesh
# --------------------------------------------------------------------------
def read_slice(st: ShardedTensor, index, device, near) -> torch.Tensor:
    """``st[index]`` on ``device`` for mesh position ``near``
    (``sharding.gather_slice``: a view of near's own block where the slice
    lies there), declared to a step analyzer as an all-gather over the
    blocks read where any lies at another position (a collective-permute
    from one block)."""
    out, n_blocks, remote = gather_slice(st, index, device, near)
    if remote:
        RL.collective("all-gather" if n_blocks > 1 else "collective-permute",
                      _nbytes(out), max(n_blocks, 2))
    return out


def write_slice(st: ShardedTensor, index, value: torch.Tensor, near, spread: float = 1.0):
    """``value`` (the shape of ``st[index]``) into every block that holds
    part of it, replicas too; a block at another position than ``near``
    takes it as a collective-permute (``spread`` of them a device)."""
    pieces = list(block_pieces(st, index, near, replicas=True))
    elems = sum(math.prod(sl.stop - sl.start for sl in out_sl)
                for pos, out_sl, _ in pieces if pos != tuple(near))
    if elems:
        RL.collective("collective-permute", elems * value.element_size() * spread, 2)
    for pos, out_sl, blk_sl in RL.loop(pieces, per_device=spread):
        blk = st.block_at(pos)
        blk[blk_sl] = value[out_sl].to(blk.device)


# --------------------------------------------------------------------------
# ContiguousKV's sparse attend, a cache block at a time
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SparseDecode:
    """ContiguousKV's sparse decode (``steps.make_sparse_decode_step``):
    ``max(1, int(budget * m))`` of the cache's m chunks of ``chunk_tokens``
    a layer, scored on the chunk means of K, or on the state's ``kmean``
    where ``cached_summaries``."""

    chunk_tokens: int
    budget: float
    cached_summaries: bool
    blocks: Tuple[Tuple[int, int], ...] = ()  # the cache blocks' chunk ranges [c0, c1)


def chunk_scores(q: torch.Tensor, k_mean: torch.Tensor) -> torch.Tensor:
    """q (b, 1, n_q, d) against chunk-mean keys (b, m, n_kv, d): each chunk's
    scores summed in float32 over the q heads, (b, m)."""
    return _grouped_scores(q, k_mean).to(torch.float32).sum(dim=(1, 2))


def attend_chunks(q, k, v, picks, *, chunk_tokens: int, length: int, pos0: int = 0,
                  most: Optional[int] = None, return_lse: bool = False):
    """q (b, 1, n_q, d) over the picked chunks (``picks`` (b, k), chunk
    indices of the whole cache) that the block k, v (b, S_blk, n_kv, d),
    positions ``pos0`` on, holds: each one's positions up to ``length`` (the
    new token's), in the order picked. ``most``: the most picks any row has
    in the block, where fewer than k; each row's held picks then come first
    and the attend reads ``most`` chunks a row. Returns (b, 1, n_q, d), and
    with ``return_lse`` each row's logsumexp of its masked float32 scores
    (b, n_q): near NEG_INF where the block holds none of the row's picks,
    which ``combine_partials`` weighs 0. Over a whole cache (``pos0`` 0) it
    is the unsharded sparse step's attend."""
    b, s_blk, n_kv, d = k.shape
    c = chunk_tokens
    m_blk, c0 = s_blk // c, pos0 // c
    rows = torch.arange(b, device=q.device)[:, None]
    if most is not None and most < picks.shape[1]:
        inside = (picks >= c0) & (picks < c0 + m_blk)
        order = torch.sort((~inside).to(torch.int8), dim=1, stable=True).indices[:, :most]
        picks = picks.gather(1, order)
    local = (picks - c0).clamp(0, m_blk - 1)
    kc = k.reshape(b, m_blk, c, n_kv, d)
    k_flat = kc[rows, local].reshape(b, -1, n_kv, d)
    v_flat = v.reshape(kc.shape)[rows, local].reshape(b, -1, n_kv, d)
    sel_pos = (picks[:, :, None] * c
               + torch.arange(c, device=q.device)[None, None, :]).reshape(b, -1)
    held = ((picks >= c0) & (picks < c0 + m_blk)).repeat_interleave(c, dim=1)
    valid = (sel_pos <= length) & held  # positions of a picked chunk past the new token
    att = _grouped_scores(q, k_flat).to(torch.float32) * (d ** -0.5)
    att = torch.where(valid[:, None, None, :], att, NEG_INF)
    p = torch.softmax(att, dim=-1).to(v_flat.dtype)
    out = _grouped_out(p, v_flat)
    if return_lse:
        return out, torch.logsumexp(att[:, :, 0], dim=-1)
    return out


def check_chunk_layout(state, chunk_tokens: int, cached_summaries: bool) -> tuple:
    """The chunk ranges [c0, c1) of the cache's sequence blocks, in order.
    Raises ValueError where a cache block of ``state["k"]`` (a
    ``ShardedTensor``) splits a chunk of ``chunk_tokens``, or, with
    ``cached_summaries``, where a block of ``state["kmean"]`` does not hold
    the chunks of the same position's K block (the same rows and kv
    heads)."""
    kst, c = state["k"], chunk_tokens
    S = kst.shape[2]
    kmst = state.get("kmean") if cached_summaries else None
    if cached_summaries and kmst is None:
        raise ValueError("sparse decode with cached_summaries needs the state's kmean")
    ranges = set()
    for pos in kst.positions():
        kb = block_index(kst.shape, kst.sharding, pos)
        s0, s1 = kb[2].start, kb[2].stop
        if s0 % c or s1 % c:
            n = S // (s1 - s0)
            raise ValueError(
                f"sparse decode over a mesh needs each cache block to hold whole "
                f"ContiguousChunks: the KV capacity S={S} splits into {n} blocks of {s1 - s0} "
                f"positions, not a multiple of chunk_tokens={c}; pad the KV state to a "
                f"multiple of n_blocks*chunk_tokens = {n}*{c} = {n * c} or lower chunk_tokens")
        if kmst is not None:
            mb = block_index(kmst.shape, kmst.sharding, pos)
            if (mb[2] != slice(s0 // c, s1 // c) or mb[:2] != kb[:2] or mb[3:] != kb[3:]):
                raise ValueError(
                    f"sparse decode over a mesh needs kmean's blocks to hold the chunks of k's: "
                    f"at mesh position {tuple(pos)} k holds positions [{s0}, {s1}) and kmean "
                    f"chunks [{mb[2].start}, {mb[2].stop}) of {kmst.shape[2]}; lay kmean "
                    f"(L, b, S/chunk_tokens, n_kv, d) out on k's spec")
        ranges.add((s0 // c, s1 // c))
    return tuple(sorted(ranges))


# --------------------------------------------------------------------------
# gradients block by block
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=1 << 16)
def _block_key(sharding: NamedSharding, shape: tuple, pos: tuple) -> tuple:
    """The global bounds of the block at ``pos``, one (start, stop) a dim:
    the same for every position that holds a replica of it."""
    return tuple((sl.start, sl.stop) for sl in block_index(shape, sharding, pos))


class GradSink:
    """A params tree's gradient on its mesh, block by block: one float32
    accumulator a distinct block of each leaf (replicas share it), on the
    device of the first position that holds the block. ``finish`` gives it
    back as a tree of ``ShardedTensor`` laid out as the params are."""

    def __init__(self, params):
        self.params = params
        self.open: set = set()  # the scopes whose gradients have not all arrived
        self.acc: Dict[ShardedTensor, Dict[tuple, torch.Tensor]] = {}
        for st in tree_leaves(params):
            blocks = self.acc[st] = {}
            for pos in st.positions():
                key = self.key(st, pos)
                if key not in blocks:
                    blk = st.block_at(pos)
                    blocks[key] = torch.zeros(blk.shape, dtype=torch.float32, device=blk.device)

    @staticmethod
    def key(st: ShardedTensor, pos) -> tuple:
        return _block_key(st.sharding, tuple(st.shape), tuple(pos))

    def add(self, st: ShardedTensor, pos, blk_sl, grad: torch.Tensor, weight: float):
        """``weight`` x ``grad`` into the accumulator of ``st``'s block at
        ``pos``, at ``blk_sl``, in float32."""
        a = self.acc[st][self.key(st, pos)][blk_sl]
        g = grad.to(device=a.device, dtype=torch.float32)
        if weight == 1.0:
            a.add_(g)
        else:
            a.add_(g, alpha=weight)

    def finish(self, fn) -> Any:
        """Each accumulator replaced by ``fn(leaf, accumulator)`` (one call
        a distinct block); returns the tree of ``ShardedTensor`` whose
        blocks are those tensors, replicas sharing one. Raises if a scope
        still waits for a gradient: a gather whose output never reached
        the loss would otherwise drop the gradients its scope holds."""
        if self.open:
            waiting = sorted({str(tuple(st.shape)) for scope in self.open
                              for (st, _), n in scope.expect.items() if n})
            raise RuntimeError(f"{len(self.open)} gradient scope(s) never drained: a weight "
                               f"gather's output has no path to the loss (leaves {waiting})")
        out = []
        for st in tree_leaves(self.params):
            blocks = self.acc[st]
            for key in list(blocks):
                blocks[key] = fn(st, blocks[key])
            arr = st.blocks.copy()
            for pos in st.positions():
                arr[tuple(pos)] = blocks[self.key(st, pos)]
            out.append(ShardedTensor(st.shape, arr.flat[0].dtype, st.sharding, arr))
        return tree_replace_leaves(self.params, out)


class _Scope:
    """The gradients of one layer call of one dp part (or of its embedding,
    or its head), held where a block feeds several of the call's gathers
    until the last arrives, then summed in float32 in the gathers' order
    (in a layer's body, shard order) and that sum added into the block's
    accumulator. A block one gather reads is added when it arrives.

    ``expect`` counts the pieces still to arrive a block, ``pending`` all
    of them. A scope that waits is in its sink's ``open`` set, which ``GradSink.finish`` requires
    empty; a scope ``tracked`` False (one a rematerialized layer opens in
    the backward, whose gathers' own backwards never run: the forward's
    nodes take the gradients) is left out of it. Over distinct cards
    autograd runs each card's backward nodes on a thread of its own, so the
    gradients arrive under a lock."""

    def __init__(self, sink: GradSink, weight: float, tracked: bool = True):
        self.sink, self.weight, self.tracked = sink, weight, tracked
        self.expect: Dict[tuple, int] = {}
        self.held: Dict[tuple, list] = {}
        self.n = self.pending = 0
        self.lock = threading.Lock()

    def register(self, st: ShardedTensor, pieces) -> int:
        for pos, _, _ in pieces:
            key = (st, GradSink.key(st, pos))
            self.expect[key] = self.expect.get(key, 0) + 1
        self.pending += len(pieces)
        if self.tracked:
            self.sink.open.add(self)
        self.n += 1
        return self.n

    def arrive(self, st: ShardedTensor, pieces, order: int, grad: torch.Tensor):
        with self.lock:
            self._arrive(st, pieces, order, grad)

    def _arrive(self, st: ShardedTensor, pieces, order: int, grad: torch.Tensor):
        for pos, out_sl, blk_sl in pieces:
            key = (st, GradSink.key(st, pos))
            held = self.held.setdefault(key, [])
            held.append((order, pos, blk_sl, grad[out_sl]))
            self.expect[key] -= 1
            if not self.expect[key]:
                del self.held[key]
                if len(held) == 1:
                    self.sink.add(st, pos, blk_sl, held[0][3], self.weight)
                    continue
                # the pieces' sum over the box their slices span, in order
                lo = [min(h[2][d].start for h in held) for d in range(len(blk_sl))]
                hi = [max(h[2][d].stop for h in held) for d in range(len(blk_sl))]
                total = torch.zeros([b - a for a, b in zip(lo, hi)], dtype=torch.float32,
                                    device=held[0][3].device)
                for _, _, sl, g in sorted(held, key=lambda h: h[0]):
                    # each gather's gradient lies on its shard's device
                    total[tuple(slice(x.start - a, x.stop - a) for x, a in zip(sl, lo))] += \
                        g.to(total.device)
                self.sink.add(st, pos, tuple(slice(a, b) for a, b in zip(lo, hi)), total,
                              self.weight)
        self.pending -= len(pieces)
        if not self.pending:
            self.sink.open.discard(self)


@dataclasses.dataclass
class _Train:
    """A dp part's share of a train step: the gradient sink and the part's
    weight in its microbatch's loss, the anchor every weight gather hangs
    on (autograd runs a Function's backward only where an input requires
    grad), and the scope of the layer call running."""

    sink: GradSink
    weight: float
    anchor: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((), requires_grad=True))
    scope: Optional[_Scope] = None

    def open_scope(self):
        self.scope = _Scope(self.sink, self.weight, tracked=not RL.in_backward())


# --------------------------------------------------------------------------
# the joins
# --------------------------------------------------------------------------
class _WeightGather(torch.autograd.Function):
    """``st[index]`` on ``device`` gathered for the position ``near`` (an
    all-gather over the blocks read, a permute from one block elsewhere);
    its gradient goes into ``scope``'s sink block by block (a
    reduce-scatter, a permute back)."""

    @staticmethod
    def forward(ctx, anchor, st, index, device, near, scope):
        out, n_blocks, remote = gather_slice(st, index, device, near)
        if remote:
            RL.collective("all-gather" if n_blocks > 1 else "collective-permute",
                          _nbytes(out), max(n_blocks, 2))
        ctx.st, ctx.scope, ctx.remote, ctx.n_blocks = st, scope, remote, n_blocks
        ctx.pieces = block_pieces(st, index, near)
        ctx.order = scope.register(st, ctx.pieces)
        # a view: autograd marks the output it is given, and a whole local
        # block comes back as the block itself
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        if ctx.remote:
            if ctx.n_blocks > 1:
                RL.collective("reduce-scatter", _nbytes(grad) / ctx.n_blocks, ctx.n_blocks)
            else:
                RL.collective("collective-permute", _nbytes(grad), 2)
        with RL.uncounted():
            ctx.scope.arrive(ctx.st, ctx.pieces, ctx.order, grad)
        return (None,) * 6


def _float32_sum(parts, home, dtype) -> torch.Tensor:
    """``parts`` moved to ``home`` and summed in order in float32 (float64
    parts in float64), rounded once to ``dtype``."""
    wide = torch.promote_types(torch.float32, parts[0].dtype)
    acc = parts[0].to(device=home, dtype=wide)
    for p in parts[1:]:
        acc += p.to(device=home, dtype=wide)
    return acc.to(dtype)


class _RowSum(torch.autograd.Function):
    """Row-parallel partials summed on ``home`` (``_float32_sum``); the
    gradient handed unchanged to each partial's device."""

    @staticmethod
    def forward(ctx, home, *parts):
        ctx.devices = [p.device for p in parts]
        with RL.uncounted():
            return _float32_sum(parts, home, parts[0].dtype)

    @staticmethod
    def backward(ctx, grad):
        with RL.uncounted():
            return (None,) + tuple(grad.to(d) for d in ctx.devices)


class _Broadcast(torch.autograd.Function):
    """``x`` on each of ``devices``; the gradients summed on x's device in
    float32 in order, rounded once (an all-reduce over the shards)."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.set_materialize_grads(False)
        ctx.home, ctx.dtype = x.device, x.dtype
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        got = [g for g in grads if g is not None]
        RL.collective("all-reduce", _nbytes(got[0]), len(grads), devices=len(grads))
        with RL.uncounted():
            return (_float32_sum(got, ctx.home, ctx.dtype),) + (None,) * len(grads)


class _ExpertCat(torch.autograd.Function):
    """The experts' outputs of each shard, ``(e0, e1)`` and (e1 - e0, cap,
    d) each, placed in one (E, cap, d) on ``home`` (an all-to-all over
    ``n`` shards); the gradient's rows sent back (an all-to-all)."""

    @staticmethod
    def forward(ctx, home, n_experts, n, ranges, *ys):
        ctx.ranges, ctx.n, ctx.devices = ranges, n, [y.device for y in ys]
        with RL.uncounted():
            out = ys[0].new_zeros((n_experts,) + tuple(ys[0].shape[1:]), device=home)
            for (e0, e1), y in zip(ranges, ys):
                out[e0:e1] = y.to(home)
        RL.collective("all-to-all", _nbytes(out), n, devices=n)
        return out

    @staticmethod
    def backward(ctx, grad):
        RL.collective("all-to-all", _nbytes(grad), ctx.n, devices=ctx.n)
        with RL.uncounted():
            return (None,) * 4 + tuple(grad[e0:e1].to(d)
                                       for (e0, e1), d in zip(ctx.ranges, ctx.devices))


class _VocabShard(torch.autograd.Function):
    """One vocabulary shard's part of the loss, from its float32 logits
    ``z`` (..., V_t), whose first column is vocabulary entry ``v0``, and
    every row's max ``m`` and log-sum-exp ``log_s`` of z - m over all
    shards: its labels' logits (0 where another shard owns the label) and
    a zero a row that carries the softmax's gradient. The backward is
    softmax minus one-hot on the shard's columns, in ``log_softmax``'s
    arithmetic: d z = exp((z - m) - log_s) d zero, and d label-logit at the
    label's column."""

    @staticmethod
    def forward(ctx, z, m, log_s, labels, v0: int):
        idx = labels.long() - v0
        own = (idx >= 0) & (idx < z.shape[-1])
        idx = idx.clamp(0, z.shape[-1] - 1)
        zl = torch.where(own, z.gather(-1, idx[..., None])[..., 0], 0.0)
        ctx.save_for_backward(z, m, log_s, idx, own)
        return zl, torch.zeros_like(zl)

    @staticmethod
    def backward(ctx, dzl, dzero):
        z, m, log_s, idx, own = ctx.saved_tensors
        dz = torch.exp((z - m[..., None]) - log_s[..., None]) * dzero[..., None]
        dz.scatter_add_(-1, idx[..., None], torch.where(own, dzl, 0.0)[..., None])
        return dz, None, None, None, None


def _join_rows(parts, home, op) -> torch.Tensor:
    """Per-row statistics of the shards joined on ``home`` in shard order
    by ``op`` (an all-reduce; no gradient)."""
    with RL.uncounted():
        out = parts[0].to(home)
        for x in parts[1:]:
            out = op(out, x.to(home))
    return out


class _VocabJoin(torch.autograd.Function):
    """The loss from every vocabulary shard's part (:class:`_VocabShard`, two
    tensors a shard, in shard order) on ``home``: nll = -((z_label - m) -
    log_s), the label's logit the sum of the shards' (one is not 0), plus
    the shards' zeros, then ``cross_entropy``'s weighting by ``mask``. An
    all-reduce of the labels' logits over ``n`` shards; its backward hands
    each shard -g for its labels' logits and g for its zeros."""

    @staticmethod
    def forward(ctx, home, n, m, log_s, mask, *parts):
        zls = parts[0::2]
        RL.collective("all-reduce", _nbytes(m), n, devices=n)
        with RL.uncounted():
            zl = _float32_sum(zls, home, m.dtype)
            nll = -((zl - m) - log_s)
            if mask is None:
                loss = nll.mean()
                weight = torch.full_like(nll, 1.0 / nll.numel())
            else:
                den = torch.clamp(mask.sum(), min=1)
                loss = (nll * mask).sum() / den
                weight = (mask / den).to(nll.dtype)
        ctx.save_for_backward(weight)
        ctx.devices = [x.device for x in zls]
        return loss

    @staticmethod
    def backward(ctx, grad):
        weight, = ctx.saved_tensors
        with RL.uncounted():
            g = grad * weight
            out = [None] * 5
            for d in ctx.devices:
                out += [(-g).to(d), g.to(d)]
        return tuple(out)


def vocab_cross_entropy(zs: Dict[int, Tuple[torch.Tensor, int]], labels: torch.Tensor, mask,
                        home, n: int, shards=None) -> torch.Tensor:
    """``T.cross_entropy`` of logits held by vocabulary shard: ``zs`` maps
    shard t to (its float32 logits (..., V_t), the vocabulary entry of its
    first column), each on its device (a shard with no columns is left
    out; the dict is emptied as the logits are used); ``labels`` and
    ``mask`` as ``cross_entropy`` takes them, the loss on ``home``. No
    device forms the whole logits: each row's max over the
    shards is joined, then its sum of exp(z - m), each an all-reduce of a
    float a row over ``n`` shards, then each shard's part of the loss
    (:class:`_VocabShard`) into the loss (:class:`_VocabJoin`). ``shards``
    gives the shard numbers to visit (a step analyzer's loop over them);
    default all of ``zs``."""
    visit = shards if shards is not None else lambda: iter(sorted(zs))
    rows = labels.numel() * 4
    RL.collective("all-reduce", rows, n, devices=n)
    maxima = [zs[t][0].detach().amax(dim=-1) for t in visit() if t in zs]
    m = _join_rows(maxima, home, torch.maximum)
    sums = []
    for t in visit():
        if t in zs:
            z = zs[t][0]
            with _on(z.device), torch.no_grad():
                sums.append(torch.exp(z - m.to(z.device)[..., None]).sum(dim=-1))
    RL.collective("all-reduce", rows, n, devices=n)
    log_s = torch.log(_join_rows(sums, home, torch.add))
    out = []
    for t in visit():
        if t in zs:
            z, v0 = zs.pop(t)
            dev = z.device
            with _on(dev):
                out += _VocabShard.apply(z, m.to(dev), log_s.to(dev), labels.to(dev), v0)
    return _VocabJoin.apply(home, n, m, log_s, mask, *out)


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Part:
    """One dp shard's share of a step call."""

    j: int
    rows: slice
    home: torch.device  # its first tensor shard's device
    near: tuple  # that position
    state: Optional[Dict[str, Any]]  # serving's state; None in training
    length: int  # positions already in the cache (decode)
    decode: bool
    spread: float  # the share of a part's cache blocks one device holds
    positions: Optional[torch.Tensor] = None
    train: Optional[_Train] = None
    sparse: Optional[SparseDecode] = None  # the sparse decode step's settings


class MeshServe:
    """The steps over ``mesh`` (see the module docstring).

    ``prefill(params, batch, state)`` and ``decode(params, token, state)``
    take params as trees of ``ShardedTensor`` laid out by
    ``param_shardings``, inputs as ``ShardedTensor`` (or tensors) laid out
    by ``batch_specs`` / ``decode_token_tree``'s spec, and the state's
    ``k``, ``v``, ``ssm_h`` and ``ssm_conv`` as ``ShardedTensor`` laid out by
    ``serve_state_shardings`` (``length`` a Python int). They return the
    logits on the mesh's first device and the state dict, its blocks
    written in place. ``sparse_decode(params, token, state, *,
    chunk_tokens, budget, cached_summaries)`` is ContiguousKV's sparse
    decode step over the same layout, ``state["kmean"]`` laid out on k's
    spec.

    ``part_loss(...)`` is one dp part of a train step's microbatch: its
    forward through the same layer body and the vocabulary-parallel loss;
    its backward adds the part's gradient into a :class:`GradSink`."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, *, block_q: int = 512):
        self.cfg, self.mesh, self.block_q = cfg, mesh, block_q
        self.dp = tuple(a for a in dp_axes(mesh) if a in mesh.axis_names)
        self.tp = tuple(a for a in tp_axes(mesh) if a in mesh.axis_names)
        self.n_dp = math.prod(mesh.shape[a] for a in self.dp)
        self.n_tp = math.prod(mesh.shape[a] for a in self.tp)
        self.shards = plan_shards(cfg, self.n_tp)
        self.first = mesh.devices.flat[0]
        # the kv heads whose chunk summaries each shard updates: those no
        # earlier shard holds (a kv head two shards read is updated once)
        done, self.kv_owned = 0, []
        for sh in self.shards:
            self.kv_owned.append((max(sh.kv[0], done), sh.kv[1]))
            done = max(done, sh.kv[1])

    # -- positions and movement ------------------------------------------------
    def pos(self, j: int, t: int) -> tuple:
        """The mesh position of dp shard j's tensor shard t."""
        coord = dict.fromkeys(self.mesh.axis_names, 0)
        for axes, i in ((self.dp, j), (self.tp, t)):
            for a in reversed(axes):
                coord[a], i = i % self.mesh.shape[a], i // self.mesh.shape[a]
        return tuple(coord[a] for a in self.mesh.axis_names)

    def _gather(self, st: ShardedTensor, index, device, near, part: _Part) -> torch.Tensor:
        """``st[index]`` on ``device`` for the position ``near``, declared as
        an all-gather over the blocks read (a permute from one block
        elsewhere); in a train step through :class:`_WeightGather`."""
        if part.train is not None:
            return _WeightGather.apply(part.train.anchor, st, index, device, near,
                                       part.train.scope)
        return read_slice(st, index, device, near)

    def _layer_slice(self, st: ShardedTensor, l: int, device, near, part: _Part,
                     *index) -> torch.Tensor:
        return self._gather(st, (slice(l, l + 1),) + index, device, near, part)[0]

    def _sum(self, parts: List[torch.Tensor], home) -> torch.Tensor:
        """Row-parallel partials summed in shard order on ``home`` in
        float32, rounded once (one partial is returned as it is): an
        all-reduce over the tensor shards (:class:`_RowSum`)."""
        RL.collective("all-reduce", _nbytes(parts[0]), self.n_tp, devices=self.n_tp)
        if len(parts) == 1:
            return parts[0].to(home)
        return _RowSum.apply(home, *parts)

    def _spread(self, x: torch.Tensor, part: _Part) -> List[torch.Tensor]:
        """``x`` on each tensor shard's device, in shard order; in a train
        step over several shards through :class:`_Broadcast`."""
        devices = [self.mesh.devices[self.pos(part.j, t)] for t in range(self.n_tp)]
        if part.train is not None and self.n_tp > 1:
            return list(_Broadcast.apply(x, *devices))
        return [x.to(d) for d in devices]

    def _tensor_shards(self, part: _Part):
        """(t, shard, position, device) of each tensor shard, as a loop."""
        for t in RL.loop(range(self.n_tp), per_device=1 / self.n_tp):
            pos = self.pos(part.j, t)
            yield t, self.shards[t], pos, self.mesh.devices[pos]

    # -- weights ---------------------------------------------------------------
    def _weights(self, params, l: int, sh: Shard, dev, near, part: _Part) -> Dict[str, Any]:
        """Shard ``sh``'s slice of layer l's weights on ``dev``, in the shapes
        the model code takes."""
        cfg, L = self.cfg, params["layers"]

        def get(name, *index, tree=L):
            return self._layer_slice(tree[name], l, dev, near, part, *index)

        w: Dict[str, Any] = {}
        if cfg.has_attention and sh.heads[1] > sh.heads[0]:
            H, K = slice(*sh.heads), slice(*sh.kv)
            w.update(wq=get("wq", ALL, H), wk=get("wk", ALL, K), wv=get("wv", ALL, K),
                     wo=get("wo", H))
            if cfg.qkv_bias:
                w.update(bq=get("bq", H), bk=get("bk", K), bv=get("bv", K))
            if cfg.qk_norm:
                w.update(q_norm=get("q_norm"), k_norm=get("k_norm"))
        if cfg.family in T.STATE_FAMILIES:
            m, (c0, c1), d_in = L["mamba"], sh.channels, cfg.d_inner
            C = slice(c0, c1)
            w_in = (get("w_in", tree=m) if (c0, c1) == (0, d_in) else
                    torch.cat([get("w_in", ALL, C, tree=m),
                               get("w_in", ALL, slice(d_in + c0, d_in + c1), tree=m)], dim=1))
            w["mamba"] = dict(w_in=w_in, conv_w=get("conv_w", ALL, C, tree=m),
                              conv_b=get("conv_b", C, tree=m), w_x=get("w_x", C, tree=m),
                              dt_bias=get("dt_bias", tree=m), A_log=get("A_log", C, tree=m),
                              D=get("D", C, tree=m), w_out=get("w_out", C, tree=m))
        if cfg.family == "moe":
            E, F = slice(*sh.experts), slice(*sh.moe_ff)
            m = L["moe"]
            w["moe"] = dict(w_gate=get("w_gate", E, ALL, F, tree=m),
                            w_up=get("w_up", E, ALL, F, tree=m),
                            w_down=get("w_down", E, F, tree=m))
        elif "w_gate" in L:
            F = slice(*sh.ff)
            w.update(w_gate=get("w_gate", ALL, F), w_up=get("w_up", ALL, F),
                     w_down=get("w_down", F))
        return w

    def _head_weight(self, params, vocab: Tuple[int, int], dev, near, part: _Part):
        """The unembedding's columns ``vocab`` (d_model, v1 - v0) on ``dev``."""
        V = slice(*vocab)
        if self.cfg.tie_embeddings:
            return self._gather(params["embed"], (V,), dev, near, part).T
        return self._gather(params["unembed"], (ALL, V), dev, near, part)

    # -- the serving steps -----------------------------------------------------
    def prefill(self, params, batch, state):
        if self.cfg.family in T.STATE_FAMILIES:
            check_scan_dtype(self.cfg)
        inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
        return self._run(params, inputs, state, decode=False)

    def decode(self, params, token, state):
        return self._run(params, token, state, decode=True)

    def sparse_decode(self, params, token, state, *, chunk_tokens: int = 16,
                      budget: float = 0.05, cached_summaries: bool = False):
        """ContiguousKV's sparse decode step over the mesh (the module
        docstring): the unsharded step's semantics
        (``steps.make_sparse_decode_step``) with its picks global over the
        cache's blocks. Raises ValueError, before anything is written, for
        a layout whose blocks split a chunk (``check_chunk_layout``)."""
        if not self.cfg.has_attention:
            raise ValueError(f"{self.cfg.name}: the sparse decode step needs attention layers")
        blocks = check_chunk_layout(state, chunk_tokens, cached_summaries)
        return self._run(params, token, state, decode=True,
                         sparse=SparseDecode(chunk_tokens, budget, cached_summaries, blocks))

    def _parts(self, b: int) -> List[Tuple[int, int, int]]:
        """(dp shard, first row, end row) of each computing dp shard."""
        if b < 16 or self.n_dp == 1:
            return [(0, 0, b)]
        if b % self.n_dp:
            raise ValueError(f"a batch of {b} rows does not split over {self.n_dp} dp shards")
        r = b // self.n_dp
        return [(j, j * r, (j + 1) * r) for j in range(self.n_dp)]

    def _run(self, params, inputs, state, *, decode: bool,
             sparse: Optional[SparseDecode] = None):
        cfg = self.cfg
        b, s = inputs.shape[:2]
        length = int(state["length"]) if decode else 0
        parts = self._parts(b)
        logits = torch.empty((b, 1, cfg.vocab_size), dtype=torch.float32, device=self.first)
        offsets = [None] * cfg.n_layers  # MoE: each expert's assignments in earlier parts
        for j, lo, hi in RL.loop(parts, per_device=1 / len(parts)):
            near = self.pos(j, 0)
            part = _Part(j, slice(lo, hi), self.mesh.devices[near], near, state, length,
                         decode, len(parts) / self.n_dp, sparse=sparse)
            routes = None
            if cfg.family == "moe" and len(parts) > 1:
                routes = [MoeRoute(b * s, None if o is None else o.to(part.home))
                          for o in offsets]
            self._part(params, inputs, part, routes, logits[lo:hi])
            if routes is not None:
                offsets = [r.counts if o is None else o.to(part.home) + r.counts
                           for o, r in zip(offsets, routes)]
        if len(parts) > 1:  # the dp shards' logits onto the first device
            RL.collective("all-gather", _nbytes(logits), len(parts))
        state["length"] = length + (1 if decode else s)
        return logits, state

    def _part(self, params, inputs, part: _Part, routes, out):
        """The dp shard's rows through every layer; their logits into
        ``out``."""
        cfg = self.cfg
        if isinstance(inputs, ShardedTensor):
            x = self._gather(inputs, (part.rows,), part.home, part.near, part)
        else:
            x = torch.as_tensor(inputs)[part.rows].to(part.home)
        h = x.to(cfg.activation_dtype()) if x.dim() == 3 else self._embed(params, x, part)
        bp, s = h.shape[:2]
        if part.decode:
            part.positions = torch.full((bp, 1), part.length, dtype=torch.long, device=part.home)
        else:
            part.positions = torch.arange(s, device=part.home).expand(bp, s)
        for l in range(cfg.n_layers):
            h = self._layer(params, l, h, part, None if routes is None else routes[l])
        self._logits(params, h if part.decode else h[:, -1:], part, out)

    def _logits(self, params, h, part: _Part, out):
        """Each tensor shard's vocabulary columns of the logits, into
        ``out`` on the mesh's first device."""
        cfg = self.cfg
        norm = self._gather(params["final_norm"], (ALL,), part.home, part.near, part)
        h = rms_norm(h, norm, cfg.norm_eps)
        for _, sh, pos, dev in self._tensor_shards(part):
            v0, v1 = sh.vocab
            if v1 == v0:
                continue
            w = self._head_weight(params, sh.vocab, dev, pos, part)
            with _on(dev):
                out[..., v0:v1] = matmul(h.to(dev), w).to(torch.float32).to(self.first)
            del w
        RL.collective("all-gather", _nbytes(out), self.n_tp)

    # -- the train step's part -------------------------------------------------
    def part_loss(self, params, batch: Dict[str, torch.Tensor], j: int, rows: slice,
                  sink: GradSink, weight: float, routes=None, remat=False) -> torch.Tensor:
        """dp shard j's rows ``rows`` of ``batch`` (tensors on the mesh's
        first device) through every layer and the vocabulary-parallel loss
        (``T.cross_entropy``'s where the tensor axes have one shard), under
        grad; its backward adds ``weight`` x the part's gradient into
        ``sink``. ``routes``: the MoE layers' parts of the microbatch's
        dispatch. ``remat`` as ``T.forward`` takes it, each checkpointed
        layer holding its weight gathers too, so the backward gathers
        again."""
        cfg = self.cfg
        near = self.pos(j, 0)
        home = self.mesh.devices[near]
        part = _Part(j, rows, home, near, None, 0, False, 1.0, train=_Train(sink, weight))
        mb = {k: v[rows].to(home) for k, v in batch.items()}
        if "embeds" in mb:
            h = mb["embeds"].to(cfg.activation_dtype())
        else:
            part.train.open_scope()
            h = self._embed(params, mb["tokens"], part)
        b, s = h.shape[:2]
        part.positions = torch.arange(s, device=home).expand(b, s)

        def layer(h, l, route):
            with RL.recomputed():
                return self._layer(params, l, h, part, route)

        # the whole layer runs again (no early stop), so a step analyzer
        # counts the same recompute whether it samples the tensor shards
        layer = T.rematerialized(layer, remat, early_stop=False)
        for l in range(cfg.n_layers):
            h = layer(h, l, None if routes is None else routes[l])
        return self._loss(params, h, mb["labels"], mb.get("loss_mask"), part)

    def _loss(self, params, h, labels, mask, part: _Part) -> torch.Tensor:
        """``T.cross_entropy`` of the logits, which no device holds whole
        over several tensor shards: each shard's logits of its vocabulary
        columns give its statistics (:class:`_VocabShard`), joined into the
        loss (:class:`_VocabJoin`)."""
        cfg = self.cfg
        part.train.open_scope()
        norm = self._gather(params["final_norm"], (ALL,), part.home, part.near, part)
        h = rms_norm(h, norm, cfg.norm_eps)
        if self.n_tp == 1:
            w = self._head_weight(params, (0, cfg.vocab_size), part.home, part.near, part)
            return T.cross_entropy(matmul(h, w).to(torch.float32), labels, mask)
        hs = self._spread(h, part)
        zs = {}
        for t, sh, pos, dev in self._tensor_shards(part):
            if sh.vocab[1] > sh.vocab[0]:
                w = self._head_weight(params, sh.vocab, dev, pos, part)
                with _on(dev):
                    zs[t] = (matmul(hs[t], w).to(torch.float32), sh.vocab[0])
                del w
        del hs
        return vocab_cross_entropy(zs, labels, mask, part.home, self.n_tp,
                                   lambda: (t for t, *_ in self._tensor_shards(part)))

    # -- the layer body --------------------------------------------------------
    def _embed(self, params, tokens, part: _Part):
        """Each tensor shard looks its vocabulary rows up (zeros for a token
        outside them); the rows are summed, which adds zeros alone."""
        parts = []
        V = self.cfg.vocab_size
        for _, sh, pos, dev in self._tensor_shards(part):
            v0, v1 = sh.vocab
            if v1 == v0:
                continue
            table = self._gather(params["embed"], (slice(v0, v1),), dev, pos, part)
            idx = tokens.to(dev)
            if (v0, v1) == (0, V):
                parts.append(table[idx])
            else:
                idx = idx - v0
                ok = (idx >= 0) & (idx < v1 - v0)
                parts.append(torch.where(ok[..., None], table[idx.clamp(0, v1 - v0 - 1)], 0))
            del table
        return self._sum(parts, part.home)

    def _layer(self, params, l: int, h, part: _Part, route):
        cfg, L = self.cfg, params["layers"]
        home, near = part.home, part.near
        if part.train is not None:
            part.train.open_scope()
        window = int(cfg.window_sizes()[l]) if cfg.has_attention else 0
        x = rms_norm(h, self._layer_slice(L["attn_norm"], l, home, near, part), cfg.norm_eps)
        xs = self._spread(x, part)
        ws, qs, ssm_mids, a_parts, proj_parts = {}, {}, {}, [], []
        for t, sh, pos, dev in self._tensor_shards(part):
            ws[t] = self._weights(params, l, sh, dev, pos, part)
            with _on(dev):
                if "wq" in ws[t]:
                    qs[t] = self._attention_in(xs[t], ws[t], l, sh, pos, part, window, a_parts)
                if "mamba" in ws[t]:
                    ssm_mids[t] = self._mamba_in(xs[t], ws[t]["mamba"], l, sh, pos, part,
                                                 proj_parts)
        del xs
        if part.decode and cfg.has_attention:
            picks = None if part.sparse is None else self._pick_chunks(qs, l, part)
            for t, sh, pos, dev in self._tensor_shards(part):
                if t in qs:
                    with _on(dev):
                        attn = self._attend(qs[t], l, sh, pos, part, window, picks)
                        a_parts.append(T._out_proj(attn, ws[t], cfg))
        a_out = self._sum(a_parts, home) if a_parts else None
        s_out = None
        if cfg.family in T.STATE_FAMILIES:
            projs = self._spread(self._sum(proj_parts, home), part)
            s_parts = []
            for t, sh, pos, dev in self._tensor_shards(part):
                with _on(dev):
                    s_parts.append(self._mamba_out(ssm_mids[t], projs[t], ws[t]["mamba"],
                                                   l, sh, pos, part))
            s_out = self._sum(s_parts, home)
            del projs
        del qs, ssm_mids, a_parts, proj_parts
        h = h + T.mixer_out(cfg, a_out, s_out)
        return self._ffn(h, params, l, ws, part, route)  # ws, the gathered layer, dies here

    # -- attention -------------------------------------------------------------
    def _attention_in(self, x, w, l, sh: Shard, pos, part: _Part, window, a_parts):
        """Prefill and training: the shard's attention partial into
        ``a_parts``; decode: its q. Serving writes the shard's new K/V."""
        cfg = self.cfg
        positions = part.positions.to(x.device)
        if part.decode:
            q, k, v = qkv_project(x, w, cfg, positions)
        else:
            out, k, v = T.attention_sublayer(x, w, window, positions, cfg, self.block_q,
                                             kv_heads=None if sh.kv_index is None
                                             else list(sh.kv_index))
            a_parts.append(out)
            q = None
        if part.state is not None:
            seq = slice(part.length, part.length + k.shape[1])
            for name, val in (("k", k), ("v", v)):
                write_slice(part.state[name], (slice(l, l + 1), part.rows, seq, slice(*sh.kv)),
                            val[None], pos, part.spread)
            if part.sparse is not None and part.sparse.cached_summaries:
                self._add_summary(k, l, sh, pos, part)
        return q

    def _add_summary(self, k, l, sh: Shard, pos, part: _Part):
        """The new key's 1/c share added to its chunk's mean in
        ``kmean`` for the kv heads this shard updates (``kv_owned``), the
        row written into every block that holds it."""
        o0, o1 = self.kv_owned[self.shards.index(sh)]
        if o1 <= o0:
            return
        c, st = part.sparse.chunk_tokens, part.state["kmean"]
        chunk = part.length // c
        index = (slice(l, l + 1), part.rows, slice(chunk, chunk + 1), slice(o0, o1))
        old = self._gather(st, index, k.device, pos, part)
        delta = (k[:, 0, o0 - sh.kv[0]: o1 - sh.kv[0]] / c).to(st.dtype)
        write_slice(st, index, old + delta[None, :, None], pos, part.spread)

    def _kv_groups(self, l, sh: Shard, pos, part: _Part):
        """The cache blocks that hold shard ``sh``'s kv heads for the part's
        rows, grouped by kv heads in head order: (the group's q heads as
        [q0, q1) of the shard's, each one's index into the group's kv heads
        or None (``kv_index``), its pieces (``block_pieces``) in sequence
        order)."""
        g = self.cfg.n_heads // self.cfg.n_kv_heads
        (h0, h1), (kv0, kv1) = sh.heads, sh.kv
        index = (slice(l, l + 1), part.rows, ALL, slice(kv0, kv1))
        groups: Dict[Tuple[int, int], list] = {}
        for piece in block_pieces(part.state["k"], index, pos):
            rows, heads = piece[1][1], piece[1][3]
            if (rows.start, rows.stop) != (0, part.rows.stop - part.rows.start):
                raise ValueError("the cache splits a dp shard's rows: not a serve-state layout")
            groups.setdefault((heads.start, heads.stop), []).append(piece)
        out = []
        for (a, b), pieces in sorted(groups.items()):
            qa, qb = max(h0, (kv0 + a) * g), min(h1, (kv0 + b) * g)
            out.append(((qa - h0, qb - h0), kv_index(qa, qb, g, kv0 + a),
                        sorted(pieces, key=lambda p: p[1][2].start)))
        return out

    def _pick_chunks(self, qs, l, part: _Part):
        """The sparse decode's picks of layer l for the part's rows: (picks
        (b, k) on the part's first device, {a sequence block's first chunk:
        the most picks a row has in it}). Each tensor shard's chunk scores
        over the blocks that hold its kv heads (:meth:`_shard_scores`) are
        summed in float32 in shard order (an all-reduce), the chunks from
        the new token's on masked, then ``steps.top_chunks``. The most a
        block holds is read from the picks (one read a layer and part) where
        the cache has several sequence blocks; on meta tensors, which hold
        no data, each block is taken to hold an even share of them, at most
        all its chunks."""
        from repro_torch.launch import steps  # it imports this module

        sp, state = part.sparse, part.state
        m = state["k"].shape[2] // sp.chunk_tokens
        partials = []
        for t, sh, pos, dev in self._tensor_shards(part):
            if t in qs:
                with _on(dev):
                    partials.append(self._shard_scores(qs[t], l, sh, pos, part, m))
        b = part.rows.stop - part.rows.start
        RL.collective("all-reduce", 4 * b * m, self.n_tp, devices=self.n_tp)
        with RL.uncounted():
            scores = _float32_sum(partials, part.home, torch.float32)
        cpos = torch.arange(m, device=part.home) * sp.chunk_tokens
        scores = torch.where(cpos[None] < part.length + 1, scores, float("-inf"))
        k = max(1, int(sp.budget * m))
        picks = steps.top_chunks(scores, k)
        if len(sp.blocks) == 1:  # one block holds every pick
            most = [k]
        elif picks.device.type == "meta":
            share = -(-k // len(sp.blocks))
            most = [min(share, c1 - c0) for c0, c1 in sp.blocks]
        else:
            most = torch.stack([((picks >= c0) & (picks < c1)).sum(dim=1).amax()
                                for c0, c1 in sp.blocks]).tolist()
        return picks, {c0: n for (c0, _), n in zip(sp.blocks, most)}

    def _shard_scores(self, q, l, sh: Shard, pos, part: _Part, m: int) -> torch.Tensor:
        """Shard ``sh``'s partial chunk scores (b, m) float32 on q's device:
        its q heads against each block's chunk means (``kmean``'s block, or
        the K block averaged a chunk), each block where it lies, the kv
        head groups' sums added in head order."""
        c = part.sparse.chunk_tokens
        kst = part.state["kmean" if part.sparse.cached_summaries else "k"]
        total = None
        for (q0, q1), idx, pieces in self._kv_groups(l, sh, pos, part):
            q_sub = q[:, :, q0:q1]
            out = torch.zeros((q.shape[0], m), dtype=torch.float32, device=q.device)
            for bpos, out_sl, blk_sl in RL.loop(pieces, per_device=part.spread):
                dev = self.mesh.devices[bpos]
                s0, s1 = out_sl[2].start, out_sl[2].stop
                with _on(dev):
                    if part.sparse.cached_summaries:
                        sl = blk_sl[:2] + (slice(blk_sl[2].start // c, blk_sl[2].stop // c),
                                           blk_sl[3])
                        k_mean = kst.block_at(bpos)[sl][0]
                    else:
                        kb_ = kst.block_at(bpos)[blk_sl][0]
                        k_mean = kb_.reshape(kb_.shape[0], -1, c, *kb_.shape[2:]).mean(dim=2)
                    if idx is not None:
                        k_mean = k_mean[:, :, list(idx)]
                    out[:, s0 // c: s1 // c] = chunk_scores(q_sub.to(dev), k_mean).to(q.device)
            total = out if total is None else total + out
        return total

    def _attend(self, q, l, sh: Shard, pos, part: _Part, window, picks=None):
        """The decode attend of the shard's q heads over the cache blocks
        that hold their kv heads, each block where it lies, the blocks of
        one row and kv heads merged by the flash-decode combine in block
        order; with ``picks`` (the sparse decode's, :meth:`_pick_chunks`)
        over the picked chunks each block holds (:func:`attend_chunks`), a
        block that holds none of them skipped. Returns (b, 1, heads, d) on
        the shard's device."""
        kst, vst = part.state["k"], part.state["v"]
        outs = []
        for (q0, q1), idx, pieces in self._kv_groups(l, sh, pos, part):
            q_sub = q[:, :, q0:q1]
            combined = len(pieces) > 1
            partials = []
            for bpos, out_sl, blk_sl in RL.loop(pieces, per_device=part.spread):
                most = None if picks is None else picks[1][out_sl[2].start
                                                            // part.sparse.chunk_tokens]
                if most == 0:
                    continue
                dev = self.mesh.devices[bpos]
                kb_, vb_ = kst.block_at(bpos)[blk_sl][0], vst.block_at(bpos)[blk_sl][0]
                if idx is not None:
                    kb_, vb_ = kb_[:, :, list(idx)], vb_[:, :, list(idx)]
                with _on(dev):
                    if picks is None:
                        partials.append(attention_decode(
                            q_sub.to(dev), kb_, vb_, length=part.length + 1, window=window,
                            pos0=out_sl[2].start, return_lse=combined))
                    else:
                        partials.append(attend_chunks(
                            q_sub.to(dev), kb_, vb_, picks[0].to(dev),
                            chunk_tokens=part.sparse.chunk_tokens, length=part.length,
                            pos0=out_sl[2].start, most=most, return_lse=combined))
            if combined:
                parts = [(o[:, 0], None, lse) for o, lse in partials]
                RL.collective("all-reduce", 4 * q_sub.numel(), len(pieces), devices=len(pieces))
                out, _ = combine_partials(parts, q.device, q.dtype)
                outs.append(out[:, None])
            else:
                outs.append(partials[0].to(q.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)

    # -- mamba -----------------------------------------------------------------
    def _state_index(self, name: str, l: int, sh: Shard, part: _Part):
        C = slice(*sh.channels)
        if name == "ssm_h":
            return (slice(l, l + 1), part.rows, C)
        return (slice(l, l + 1), part.rows, ALL, C)

    def _mamba_in(self, x, p, l, sh: Shard, pos, part: _Part, proj_parts):
        """The shard's mixer up to the scan; its x_proj partial into
        ``proj_parts``; serving writes the new conv window. Returns what
        :meth:`_mamba_out` takes."""
        if part.decode:
            conv = self._gather(part.state["ssm_conv"], self._state_index("ssm_conv", l, sh, part),
                                x.device, pos, part)[0]
            xc, z, new_conv, proj = mamba_decode_in(x, conv, p)
            mid = (xc, z)
        else:
            s = x.shape[1]
            xi, z, xpad, proj = mamba_in(x, p)
            new_conv = xpad[:, s: s + p["conv_w"].shape[0] - 1]
            mid = (xi, z)
        if part.state is not None:
            write_slice(part.state["ssm_conv"], self._state_index("ssm_conv", l, sh, part),
                        new_conv[None], pos, part.spread)
        proj_parts.append(proj)
        return mid

    def _mamba_out(self, mid, proj, p, l, sh: Shard, pos, part: _Part):
        """The shard's scan and ``w_out`` partial; serving writes its new
        h."""
        index = self._state_index("ssm_h", l, sh, part)
        if part.decode:
            h0 = self._gather(part.state["ssm_h"], index, proj.device, pos, part)[0]
            out, h = mamba_decode_out(*mid, proj, h0, p, self.cfg)
        else:
            out, h = mamba_out(*mid, proj, p, self.cfg)
        if part.state is not None:
            write_slice(part.state["ssm_h"], index, h[None], pos, part.spread)
        return out

    # -- the FFN ---------------------------------------------------------------
    def _ffn(self, h, params, l: int, ws, part: _Part, route):
        cfg, L = self.cfg, params["layers"]
        if cfg.family != "moe" and "w_gate" not in L:
            return h
        x = rms_norm(h, self._layer_slice(L["ffn_norm"], l, part.home, part.near, part),
                     cfg.norm_eps)
        if cfg.family != "moe":
            xs = self._spread(x, part)
            parts = []
            for t, _, _, dev in self._tensor_shards(part):
                with _on(dev):
                    parts.append(swiglu(xs[t], ws[t]["w_gate"], ws[t]["w_up"], ws[t]["w_down"]))
            return h + self._sum(parts, part.home)
        xt = x.reshape(-1, cfg.d_model)
        w_router = self._layer_slice(L["moe"]["w_router"], l, part.home, part.near, part)
        disp = route_tokens(xt, w_router, n_experts=cfg.n_experts, top_k=cfg.top_k,
                            capacity_factor=cfg.moe_capacity_factor, dropless=part.decode,
                            route=route)
        xts = self._spread(xt, part)
        ye_parts = []
        for t, sh, _, dev in self._tensor_shards(part):
            e0, e1 = sh.experts
            w = ws[t]["moe"]
            with _on(dev):
                ye_parts.append((sh.experts, expert_ffn(
                    xts[t], disp.gather_idx[e0:e1].to(dev), w["w_gate"], w["w_up"],
                    w["w_down"])))
        del xts
        if self.shards[0].experts != (0, cfg.n_experts):  # experts over the shards
            ranges = tuple(r for r, _ in ye_parts)
            ye = _ExpertCat.apply(part.home, cfg.n_experts, self.n_tp, ranges,
                                  *(y for _, y in ye_parts))
        else:  # each expert's d_ff columns over the shards
            ye = self._sum([y for _, y in ye_parts], part.home)
        return h + combine(ye, disp, x.dtype).reshape(h.shape)
