"""Step factories: train_step (grad-accum + remat + AdamW), prefill_step,
decode_step, and the ContiguousKV sparse decode step.

Batches may be numpy arrays or tensors; a train step moves them to the
params' device. Entry points run where the params live: on the card unless
the caller built them on the CPU. ``make_train_step(..., mesh=)`` is the
train step over a device mesh, the counterpart of the JAX package's
``jax.jit(make_train_step(...))`` on inputs laid out by ``param_shardings``;
``make_prefill_step(..., mesh=)``, ``make_decode_step(..., mesh=)`` and
``make_sparse_decode_step(..., mesh=)`` are the serving steps over a mesh,
the counterparts of JAX's jitted serving steps on params, inputs and a
serve state laid out by ``param_shardings``, ``batch_specs`` and
``serve_state_shardings``. All of them split each microbatch's or batch's
rows over the dp axes and heads, d_ff columns, experts, mamba channels and
the vocabulary over the tensor axes, gathering one layer's weight slices at
a time (``launch/tp_compute.py``, whose layer body they share); the train
step differentiates it.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch import roofline as RL
from repro_torch.launch.sharding import ShardedTensor, unshard
from repro_torch.launch.tp_compute import GradSink, MeshServe, attend_chunks, chunk_scores
from repro_torch.models import transformer as T
from repro_torch.models.attention import qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.moe import MoeRoute
from repro_torch.train import compression as GC
from repro_torch.train.optimizer import adamw_update, clip_factor, global_norm_blocks
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map, tree_replace_leaves


def _batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _loss_and_grads(cfg: ModelConfig, params, mb, *, block_q: int, remat, moe_routes=None):
    """(loss, grads in the params' dtypes) of one microbatch."""
    flat = tree_flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_() for _, leaf in flat]
    tracked = tree_replace_leaves(params, leaves)
    with torch.enable_grad():
        loss = T.loss_fn(tracked, mb, cfg, block_q=block_q, remat=remat, moe_routes=moe_routes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (the token embedding of a batch of
    # frame embeddings) gets zeros, as jax.grad gives it
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_replace_leaves(params, grads)


def make_value_and_grad(cfg: ModelConfig, *, grad_accum: int = 1, block_q: int = 512,
                        remat=True):
    """Returns value_and_grad(params, batch) -> (loss, grads), the first half
    of a train step.

    With ``grad_accum`` > 1 the batch's leading dim is cut into that many
    microbatches, each differentiated on its own; the gradients are added in
    float32 accumulators and the losses summed in microbatch order, as the
    JAX package's ``lax.scan`` does, then both divided by ``grad_accum``.
    With ``grad_accum`` 1 the gradients keep the params' dtypes."""

    def one(params, mb):
        return _loss_and_grads(cfg, params, mb, block_q=block_q, remat=remat)

    def value_and_grad(params, batch):
        batch = _batch_on(batch, tree_leaves(params)[0].device)
        if grad_accum == 1:
            return one(params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for i in range(grad_accum):
            mb = {k: v[i * (v.shape[0] // grad_accum): (i + 1) * (v.shape[0] // grad_accum)]
                  for k, v in batch.items()}
            l_i, g_i = one(params, mb)
            # in place: the same float32 sums as acc + g, without a second copy
            tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc, g_i)
            lsum = lsum + l_i
            del g_i
        tree_map(lambda a: a.div_(grad_accum), acc)
        return lsum / grad_accum, acc

    return value_and_grad


def make_train_step(
    cfg: ModelConfig,
    *,
    grad_accum: int = 1,
    block_q: int = 512,
    remat=True,
    lr: float = 3e-4,
    grad_compression: Optional[str] = None,  # None | "int8"
    mesh=None,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics):
    the loss and gradients (``make_value_and_grad``), the int8 numerics if
    asked, then AdamW. ``metrics["loss"]`` stays on the device.

    With a ``mesh`` the step takes and returns trees of ``ShardedTensor``
    (params and moments laid out by ``param_shardings``, the step counter
    replicated); see ``_make_mesh_train_step``."""
    if mesh is not None:
        return _make_mesh_train_step(cfg, mesh, grad_accum=grad_accum, block_q=block_q,
                                     remat=remat, lr=lr, grad_compression=grad_compression)
    value_and_grad = make_value_and_grad(cfg, grad_accum=grad_accum, block_q=block_q,
                                         remat=remat)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch)
        if grad_compression == "int8":
            grads = GC.quantize_dequantize_tree(grads)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
        return new_params, new_opt, {"loss": loss}

    return train_step


# --------------------------------------------------------------------------
# the train step over a mesh
# --------------------------------------------------------------------------
def mesh_update(grads, opt_state, params, *, lr: float, scale: torch.Tensor):
    """AdamW on every mesh position's blocks, on the position's device, with
    the clip factor ``scale`` of the global gradient: ``grads``,
    ``params``, ``opt_state["m"]`` and ``opt_state["v"]`` trees of
    ``ShardedTensor`` laid out alike (a position's gradient block is its
    params block's) and ``opt_state["step"]`` one laid out replicated
    (``P()``). Returns (new params, new state), laid out as they came."""
    p_leaves = tree_leaves(params)
    g_leaves, m_leaves = tree_leaves(grads), tree_leaves(opt_state["m"])
    v_leaves = tree_leaves(opt_state["v"])
    step = opt_state["step"]
    mesh = p_leaves[0].mesh
    grid = mesh.devices.shape
    out = [[np.empty(grid, dtype=object) for _ in p_leaves] for _ in range(3)]
    steps = np.empty(grid, dtype=object)
    for pos in RL.loop(itertools.product(*(range(n) for n in grid)),
                       per_device=1 / mesh.devices.size):
        dev = mesh.devices[pos]
        gs = [g.block_at(pos).to(dev) for g in g_leaves]
        st = {"m": [m.block_at(pos) for m in m_leaves], "v": [v.block_at(pos) for v in v_leaves],
              "step": step.block_at(pos)}
        new_p, new_s = adamw_update(gs, st, [p.block_at(pos) for p in p_leaves], lr=lr,
                                    scale=scale.to(dev))
        del gs
        for i, trio in enumerate(zip(new_p, new_s["m"], new_s["v"])):
            for k in range(3):
                out[k][i][pos] = trio[k]
        steps[pos] = new_s["step"]

    def rebuild(tree, blocks):
        return tree_replace_leaves(tree, [ShardedTensor(x.shape, b.reshape(-1)[0].dtype,
                                                        x.sharding, b)
                                          for x, b in zip(tree_leaves(tree), blocks)])

    return rebuild(params, out[0]), {"m": rebuild(opt_state["m"], out[1]),
                                     "v": rebuild(opt_state["v"], out[2]),
                                     "step": ShardedTensor((), step.dtype, step.sharding, steps)}


def _row_parts(i: int, mb: int, n_dp: int) -> List[tuple]:
    """(dp shard, first row, end row) of microbatch i's parts: its rows
    split over the dp shards in order, or all on shard 0 where they do not
    divide."""
    lo = i * mb
    if mb % n_dp:
        return [(0, lo, lo + mb)]
    r = mb // n_dp
    return [(j, lo + j * r, lo + (j + 1) * r) for j in range(n_dp)]


def _part_weights(batch, parts) -> List[float]:
    """Each part's share of its microbatch's mean loss: its token count, or
    its ``loss_mask`` sum, over the microbatch's (``loss_fn`` divides a
    masked sum by max(mask sum, 1), so max(m_j, 1) / max(M, 1))."""
    if len(parts) == 1:
        return [1.0]
    mask = batch.get("loss_mask")
    if mask is None:
        total = parts[-1][2] - parts[0][1]
        return [(hi - lo) / total for _, lo, hi in parts]
    total = max(float(mask[parts[0][1]: parts[-1][2]].sum()), 1.0)
    return [max(float(mask[lo:hi].sum()), 1.0) / total for _, lo, hi in parts]


def _declare_replica_sums(params) -> None:
    """The gradient all-reduce over each block's replicas (a block held at
    r > 1 positions: a replicated leaf, or one the dp axes do not split),
    to a step analyzer."""
    if RL.active() is None:
        return
    for st in tree_leaves(params):
        blk = st.blocks.flat[0]
        n = st.blocks.size
        r = n * blk.numel() // max(math.prod(st.shape), 1)
        RL.collective("all-reduce", blk.numel() * st.dtype.itemsize, r, devices=n)


def _make_mesh_train_step(cfg: ModelConfig, mesh, *, grad_accum: int, block_q: int, remat,
                          lr: float, grad_compression: Optional[str]):
    """The train step over ``mesh``, per step:

    - microbatches: microbatch i is rows [i mb, (i + 1) mb) of the global
      batch, as in JAX's step, its rows split over the dp shards in order
      (all on the first shard where they do not divide);
    - each dp part's forward through ``tp_compute.MeshServe``'s layer body
      at positions (j, t) for every tensor shard t: each layer's weight
      slices gathered for the layer and freed after it (under ``remat`` the
      layer's gathers and compute checkpointed together, so its backward
      gathers again), heads, d_ff columns, experts, mamba channels and the
      vocabulary over the tensor shards, the loss from the vocabulary
      shards' statistics (no device forms the whole logits); an MoE layer
      routes once, replicated, keeping the microbatch's dispatch
      (``moe.MoeRoute``);
    - each part's backward, weighed by its token count or its ``loss_mask``
      sum, adds its gradient block by block in float32 into one accumulator
      a distinct block of each leaf (``tp_compute.GradSink``): the parts in
      order, the microbatches in order; the losses likewise; then the
      accumulators are divided by ``grad_accum``, or, with ``grad_accum`` 1,
      take the params' dtypes, as the step without a mesh keeps them;
    - the int8 numerics (one absmax scale a leaf, the max over its blocks)
      and AdamW's global-norm clip over the distinct blocks (each element
      once, ``optimizer.global_norm_blocks``); then AdamW on each
      position's blocks on its device (``mesh_update``).

    No device holds a whole param leaf or its gradient.

    Exactness: on a 1 x 1 mesh the step is bit for bit the step without a
    mesh; on a mesh whose tensor axes have size 1 it is bit for bit the
    step without a mesh over one microbatch a dp part (each part weighed by
    an exact 1/2 or 1/4: the same float32 sums); with tensor axes larger
    than 1 it differs by the order of the float32 sums of the joins
    (``tp_compute``'s module docstring), as JAX's GSPMD step differs from
    its unsharded step.

    To a step analyzer (``launch/roofline.py``) the parts of every
    microbatch, each layer's tensor shards and AdamW's mesh positions are
    loops (``roofline.loop``, which may run one item for all); the joins
    declare their collectives forward and backward, and each replicated
    block's gradient an all-reduce over its replicas."""
    model = MeshServe(cfg, mesh, block_q=block_q)
    home = mesh.devices[model.pos(0, 0)]
    moe = cfg.family == "moe"

    def train_step(params, opt_state, batch):
        batch = {k: unshard(v, home) if isinstance(v, ShardedTensor)
                 else torch.as_tensor(v, device=home) for k, v in batch.items()}
        b = next(iter(batch.values())).shape[0]
        mb = b // grad_accum
        units = []  # (microbatch, dp shard, first row, end row, weight, parts)
        for i in range(grad_accum):
            parts = _row_parts(i, mb, model.n_dp)
            units += [(i, j, lo, hi, w, len(parts))
                      for (j, lo, hi), w in zip(parts, _part_weights(batch, parts))]
        sink = GradSink(params)
        lsum = None if grad_accum == 1 and units[0][5] == 1 else torch.zeros(
            (), dtype=torch.float32, device=home)
        offsets, current = None, None
        for i, j, lo, hi, w, n_parts in RL.loop(units, per_device=1 / model.n_dp):
            if i != current:  # a microbatch's first part
                offsets, current = [None] * cfg.n_layers, i
            dev = mesh.devices[model.pos(j, 0)]
            routes = None
            if moe and n_parts > 1:
                tokens = mb * batch["labels"].shape[1]
                routes = [MoeRoute(tokens, None if o is None else o.to(dev)) for o in offsets]
            with torch.enable_grad():
                l_j = model.part_loss(params, batch, j, slice(lo, hi), sink, w, routes,
                                      remat=remat)
                torch.autograd.backward(l_j)
            if routes is not None:
                offsets = [r.counts if o is None else o.to(dev) + r.counts
                           for o, r in zip(offsets, routes)]
            l_j = l_j.detach().to(home)
            if lsum is None:
                lsum = l_j
            else:
                lsum = lsum + (l_j if w == 1.0 else w * l_j)
        _declare_replica_sums(params)
        loss = lsum / grad_accum if grad_accum > 1 else lsum
        if grad_accum > 1:
            grads = sink.finish(lambda st, a: a.div_(grad_accum))
        else:
            grads = sink.finish(lambda st, a: a.to(st.dtype))
        del sink
        distinct = _distinct_blocks(grads)
        if grad_compression == "int8":
            for blocks in distinct:
                for blk, q in zip(blocks, GC.quantize_dequantize_blocks(blocks)):
                    blk.copy_(q)
        scale = clip_factor(global_norm_blocks(distinct))
        new_params, new_opt = mesh_update(grads, opt_state, params, lr=lr, scale=scale)
        return new_params, new_opt, {"loss": loss}

    return train_step


def _distinct_blocks(tree) -> List[List[torch.Tensor]]:
    """Each leaf's distinct blocks, each once, of a tree of ShardedTensor
    whose replicas share their tensors, in the tree's order."""
    return [list({id(blk): blk for blk in st.blocks.flat}.values()) for st in tree_leaves(tree)]


def make_prefill_step(cfg: ModelConfig, *, block_q: int = 512, mesh=None):
    """prefill_step(params, batch, state) -> (first-token logits, state).

    With a ``mesh`` the step runs over it (``tp_compute.MeshServe``): params,
    inputs and state laid out on the mesh as ``ShardedTensor``, the logits
    returned on the mesh's first device."""
    if mesh is not None:
        return MeshServe(cfg, mesh, block_q=block_q).prefill

    def prefill_step(params, batch, state):
        return T.prefill(params, batch, cfg, state, block_q=block_q)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None):
    """decode_step(params, token, state) -> (logits, state); with a
    ``mesh``, over it as ``make_prefill_step``'s."""
    if mesh is not None:
        return MeshServe(cfg, mesh).decode

    def decode_step(params, token, state):
        return T.decode_step(params, token, cfg, state)

    return decode_step


def top_chunks(chunk_scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` highest-scoring chunks of each row of ``chunk_scores`` (b,
    m), highest first, ties to the lower chunk index, as ``lax.top_k``
    breaks them: (b, k) indices. The sparse decode steps pick through this
    function, with a mesh or without."""
    return torch.sort(chunk_scores, dim=-1, descending=True, stable=True).indices[:, :k]


def make_sparse_decode_step(cfg: ModelConfig, *, chunk_tokens: int = 16,
                            budget: float = 0.05, cached_summaries: bool = False, mesh=None):
    """ContiguousKV-sparse decode: one new token attends to only the
    top-(budget) ContiguousChunks of the cached context per layer.

    Per layer, chunk scores of the query against chunk-mean keys pick
    ``max(1, int(budget * m))`` of the m chunks of the serve state's K cache
    (``state["k"]``, (L, b, S, n_kv, d) with S a multiple of
    ``chunk_tokens``; :func:`top_chunks`); attention runs over the picked
    chunks' positions only. The selection and the attend are plain torch,
    as the JAX package computes them outside any kernel.

    ``cached_summaries=True`` keeps the chunk-mean keys in the state
    (``state["kmean"]``, (L, b, m, n_kv, d)) and adds the new key's 1/c share
    to its chunk's mean, so identification never re-reads the K cache. The
    state's buffers are updated in place and the same dict is returned, as
    the port's ``decode_step`` does.

    Without a ``mesh`` the step takes whole tensors. With one it is
    ``tp_compute.MeshServe.sparse_decode`` over it, the counterpart of
    JAX's step jitted on a state laid out by ``serve_state_shardings``
    (``kmean`` on k's spec): params, token and state laid out as
    ``make_decode_step(mesh=)`` takes them, each tensor shard scoring the
    chunks of the cache blocks that hold its kv heads where they lie, the
    scores summed over the shards for one global pick, each block attending
    over the picked chunks it holds."""
    if not cfg.has_attention:
        raise ValueError(f"{cfg.name}: the sparse decode step needs attention layers")
    if mesh is not None:
        return functools.partial(MeshServe(cfg, mesh).sparse_decode, chunk_tokens=chunk_tokens,
                                 budget=budget, cached_summaries=cached_summaries)
    c, n_kv, d = chunk_tokens, cfg.n_kv_heads, cfg.d_head

    def sparse_decode_step(params, token, state):
        h = token.to(cfg.activation_dtype()) if token.dim() == 3 else params["embed"][token]
        b = h.shape[0]
        length = int(state["length"])
        m_chunks = state["k"].shape[2] // c
        k_sel_count = max(1, int(budget * m_chunks))
        dev = h.device
        positions = torch.full((b, 1), length, dtype=torch.long, device=dev)
        cpos = torch.arange(m_chunks, device=dev) * c
        for l in range(cfg.n_layers):
            lp = T.layer_params(params, l)
            xn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = qkv_project(xn, lp, cfg, positions)
            k_cache, v_cache = state["k"][l], state["v"][l]
            k_cache[:, length: length + 1] = k_new
            v_cache[:, length: length + 1] = v_new
            if cached_summaries:
                kmean = state["kmean"][l]
                kmean[:, length // c] += (k_new[:, 0] / c).to(kmean.dtype)
                k_mean = kmean
            else:  # re-reads the whole K cache
                k_mean = k_cache.reshape(b, m_chunks, c, n_kv, d).mean(dim=2)
            scores = torch.where(cpos[None] < length + 1, chunk_scores(q, k_mean),
                                 float("-inf"))
            top_idx = top_chunks(scores, k_sel_count)
            attn = attend_chunks(q, k_cache, v_cache, top_idx, chunk_tokens=c, length=length)
            h = h + T._out_proj(attn, lp, cfg)
            h = T._ffn(h, lp, cfg, dropless=True)
        state["length"] = length + 1
        return T._logits(params, h, cfg), state

    return sparse_decode_step
