"""Tensor-parallel decode over a :class:`repro_torch.launch.mesh.Mesh`.

Two entry points, each splitting the KV over the mesh's shards and merging
the shards' softmax partials with the flash-decode combine:

- :func:`make_sharded_paged_decode`, the serving tier's paged attend (what
  ``RealCompute(tp_mesh=...)`` runs): the pools' page dim is split over the
  mesh's tensor axes, each shard attends to the pages it owns through the
  hand-written ``decode_attention`` kernel, which also returns each row's
  logsumexp, and the partials are combined in float32 on the first device;
- :func:`make_sharded_sparse_decode_step`, ContiguousKV's sparse decode with
  per-shard selection: each sequence shard appends the new token's KV if it
  owns the position, updates its chunk summaries, picks its own top chunks
  and attends over them; plain torch, as the JAX package computes it
  outside any kernel. It takes whole tensors, or params, token and a state
  laid out on the mesh (``ShardedTensor``, the layout
  ``specs.input_specs(..., sparse_summaries=True)`` gives): each shard then
  reads its sequence slice of k, v and kmean from the blocks that hold it,
  where it lies, and the new token's rows are written into every block
  that holds them.

The few tensor ops of each combine stand where the JAX package's ``pmax`` /
``psum`` collectives stand (``src/repro/launch/sharded_sparse.py``). To a
step analyzer (``launch/roofline.py``) the sparse decode step's shards are a
loop (``roofline.loop``), its combine's ``pmax`` and ``psum`` all-reduces
over the shards, and a laid-out input's reads and writes at other positions
all-gathers and collective-permutes (``tp_compute.read_slice`` and
``write_slice``, the steps over a mesh's).
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import Mesh, shard_devices, shard_positions, tp_axes
from repro_torch.launch.sharding import ShardedTensor
from repro_torch.models import transformer as T
from repro_torch.models.attention import qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.tree import tree_map

NEG_INF = -1e30
NAMES = ("k", "v", "kmean")  # the sparse decode state's per-position leaves
# bytes of pages the paged attend has copied onto shards' devices other than
# the pool's since the count was last set to 0
page_copy_bytes = 0
# a logsumexp at or below this is a row the shard had nothing to attend in:
# the kernel gives -inf there, the plain version a finite value near NEG_INF
MASKED_LSE = -1e29


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def combine_partials(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                     device: torch.device, dtype: torch.dtype):
    """Merge shards' (out, mass, lse) partials of one attend over disjoint
    page sets into (out in ``dtype``, mass float32), in float32 on
    ``device``: ``w_s = exp(lse_s - logsumexp_s lse_s)`` (a softmax over the
    shards), ``out = sum_s w_s out_s`` rounded once, ``mass = sum_s w_s
    mass_s``. A shard whose row had nothing to attend (lse -inf, NaN or at
    most MASKED_LSE) weighs exactly 0 and its out and mass are never read
    (``torch.where``, not a product), so a row no shard can see comes out 0.
    At one shard ``w`` is 1 and the result is the partial's bits. A mass of
    None (an attend that computes none, ``launch/tp_compute.py``) gives a
    mass of None."""
    out_s, lse = (_stack([p[i].to(device) for p in parts]) for i in (0, 2))
    ok = lse > MASKED_LSE  # (k, b, n_q); False for -inf and NaN
    w = torch.where(ok, torch.softmax(torch.where(ok, lse, float("-inf")), dim=0), 0.0)
    ok, w = ok[..., None], w[..., None]
    out = torch.where(ok, w * out_s.to(torch.float32), 0.0).sum(dim=0)
    if parts[0][1] is None:
        return out.to(dtype), None
    mass = torch.where(ok, w * _stack([p[1].to(device) for p in parts]), 0.0).sum(dim=0)
    return out.to(dtype), mass


def _shard_tables(table: torch.Tensor, local: int, n_shards: int) -> torch.Tensor:
    """Every shard's page table at once, (n_shards, b, n_active): slot j
    kept where shard s owns its page (``page // local == s``), -1 elsewhere
    (a pad slot's -1 // local is -1: no shard's). Each shard's table starts
    on a 16-byte boundary, as the kernel takes it."""
    b, n = table.shape
    stride = -(-b * n // 4) * 4
    flat = torch.nn.functional.pad(table.reshape(-1), (0, stride - b * n), value=-1)
    shard = torch.arange(n_shards, dtype=torch.int32, device=table.device)[:, None]
    owned = torch.where(torch.div(flat, local, rounding_mode="floor") == shard, flat, -1)
    return owned[:, : b * n].unflatten(1, (b, n))


def make_sharded_paged_decode(mesh: Mesh):
    """Tensor-parallel drop-in for ``decode_attention``.

    Returns ``attend(q, k_pool, v_pool, page_table, lengths) -> (out,
    mass)`` with the single-device contract (pad slots weigh exactly 0).
    Shard s owns the physical pages ``[s * local, (s + 1) * local)``, local
    = ceil(n_pages / n_shards) as the JAX package pads; slot positions stay
    logical, so the ``pos < lengths`` mask is the single-device one. Each
    shard runs ``decode_attention(..., return_lse=True)`` on its device
    with the slots it does not own set to -1: on the pool's own device over
    the whole pool (no slice, no copy), on another device over a copy of its
    pages with the table rebased. The partials are combined on the mesh's
    first device (:func:`combine_partials`) and returned on q's device.
    The copies' bytes add to ``page_copy_bytes``."""
    devices = shard_devices(mesh, tp_axes(mesh))
    n_shards = len(devices)

    def attend(q, k_pool, v_pool, page_table, lengths):
        global page_copy_bytes
        n_pages = k_pool.shape[1]
        local = -(-n_pages // n_shards)
        table = page_table.to(torch.int32)
        lengths = lengths.to(torch.int32)
        tables = [table] if n_shards == 1 else _shard_tables(table, local, n_shards)
        parts = []
        for s, dev in enumerate(devices):
            lo = s * local
            if dev == k_pool.device:
                args = (q, k_pool, v_pool, tables[s], lengths)
            else:
                n = max(0, min(n_pages - lo, local))
                blocks = []
                for pool in (k_pool, v_pool):
                    block = pool.new_zeros((pool.shape[0], local) + tuple(pool.shape[2:]),
                                           device=dev)
                    block[:, :n] = pool[:, lo: lo + n]
                    blocks.append(block)
                    page_copy_bytes += block[:, :n].numel() * block.element_size()
                rebased = torch.where(tables[s] >= 0, tables[s] - lo, -1)
                args = (q.to(dev), *blocks, rebased.to(dev), lengths.to(dev))
            with _on(dev):
                parts.append(decode_attention(*args, return_lse=True))
        out, mass = combine_partials(parts, devices[0], q.dtype)
        return out.to(q.device), mass.to(q.device)

    return attend


def _local_sparse_partial(q, k_shard, v_shard, km_shard, k_new, v_new, length: int, base: int,
                          *, chunk_tokens: int, k_sel: int, group: int):
    """One shard's step (JAX's ``_local_sparse_attention`` before its
    collectives): the KV append and chunk-summary update if the shard owns
    position ``length`` (in place), its top-``k_sel`` chunks by the query's
    score against the resident summaries (ties to the lower index), and its
    float32 softmax partial over them at the shard's own max. Returns
    (m (b, n_kv, g, 1, 1), l, o (b, n_kv, g, 1, d))."""
    b, s_local, n_kv, d = k_shard.shape
    c = chunk_tokens
    m_local = s_local // c
    local_pos = length - base
    if 0 <= local_pos < s_local:
        k_shard[:, local_pos] = k_new[:, 0].to(k_shard.dtype)
        v_shard[:, local_pos] = v_new[:, 0].to(v_shard.dtype)
        km_shard[:, local_pos // c] += (k_new[:, 0] / c).to(km_shard.dtype)
    dev = k_shard.device
    qg = q.reshape(b, 1, n_kv, group, d).to(torch.float32)
    s_mean = torch.einsum("bsngd,bmnd->bnsgm", qg, km_shard.to(torch.float32))
    scores = s_mean.sum(dim=(1, 2, 3))  # (b, m_local)
    cpos = base + torch.arange(m_local, device=dev) * c
    scores = torch.where(cpos[None] <= length, scores, float("-inf"))
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k_sel]
    rows = torch.arange(b, device=dev)[:, None]
    kf = k_shard.reshape(b, m_local, c, n_kv, d)[rows, top].reshape(b, k_sel * c, n_kv, d)
    vf = v_shard.reshape(b, m_local, c, n_kv, d)[rows, top].reshape(b, k_sel * c, n_kv, d)
    sel_pos = (base + top[:, :, None] * c + torch.arange(c, device=dev)).reshape(b, -1)
    logits = torch.einsum("bsngd,btnd->bngst", qg, kf.to(torch.float32)) * d ** -0.5
    logits = torch.where((sel_pos <= length)[:, None, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bngst,btnd->bngsd", p,
                                                        vf.to(torch.float32))


def make_sharded_sparse_decode_step(cfg: ModelConfig, mesh: Mesh, *, chunk_tokens: int = 16,
                                    budget: float = 0.05):
    """ContiguousKV sparse decode with per-shard selection.

    Returns ``step(params, token, state) -> (logits, state)`` over the
    port's serve state with chunk summaries (``k`` / ``v`` (L, b, S, n_kv,
    d), ``kmean`` (L, b, S / chunk_tokens, n_kv, d), ``length``): the KV's
    position dim is split over every mesh axis but "pod", each shard picks
    ``max(1, int(budget * m_local))`` of its m_local chunks (at most all of
    them), and the shards' partials merge at the global max, so a shard
    whose selection is all invalid weighs exactly 0. The state's buffers
    are updated in place and the same dict is returned.

    Whole tensors: a shard on another device than the state works on a
    copy of its slice, written back. Laid out on the mesh (``k``, ``v``,
    ``kmean`` as ``ShardedTensor``, and params and token as tensors or
    ``ShardedTensor``): each shard reads its slice at its own mesh position
    (``tp_compute.read_slice``), and the shard that holds position
    ``length`` writes the new token's K / V rows and its chunk's summary
    into every block that holds them (``tp_compute.write_slice``); the
    projections, FFN and logits run on the first shard's device, one
    layer's weights gathered there at a time. Both give the same bits."""
    from repro_torch.launch.tp_compute import read_slice, write_slice  # it imports this module

    if not cfg.has_attention:
        raise ValueError(f"{cfg.name}: the sparse decode step needs attention layers")
    axes = [a for a in mesh.axis_names if a != "pod"]
    devices, places = shard_devices(mesh, axes), shard_positions(mesh, axes)
    n_shards, c = len(devices), chunk_tokens
    group, d_head = cfg.n_heads // cfg.n_kv_heads, cfg.d_head

    def whole(x, index, dev):  # x[index]: a view, or gathered at the first shard's position
        return read_slice(x, index, dev, places[0]) if isinstance(x, ShardedTensor) else x[index]

    def step(params, token, state):
        laid = isinstance(state["k"], ShardedTensor)
        home = devices[0] if isinstance(token, ShardedTensor) else token.device
        token = whole(token, (slice(None),), home)
        if token.dim() == 3:
            h = token.to(cfg.activation_dtype())
        else:
            h = whole(params["embed"], (slice(None),), home)[token]
        b = h.shape[0]
        length = int(state["length"])
        S = state["k"].shape[2]
        if S % (n_shards * c):
            raise ValueError(
                f"sharded sparse decode needs the KV capacity S={S} divisible by "
                f"n_shards*chunk_tokens = {n_shards}*{c} = {n_shards * c} so each shard holds "
                f"whole ContiguousChunks; pad the KV state to a multiple or lower "
                f"chunk_tokens/shard count")
        s_local = S // n_shards
        m_local = s_local // c
        k_sel = min(max(1, int(budget * m_local)), m_local)
        positions = torch.full((b, 1), length, dtype=torch.long, device=h.device)
        for l in range(cfg.n_layers):
            lp = tree_map(lambda x: whole(x, (slice(l, l + 1),), home)[0], params["layers"])
            xn = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = qkv_project(xn, lp, cfg, positions)
            parts: List[tuple] = []
            for s, dev in RL.loop(enumerate(devices), per_device=1 / n_shards):
                seq = slice(s * s_local, (s + 1) * s_local)
                spans = (seq, seq, slice(s * m_local, (s + 1) * m_local))  # k, v, kmean
                if laid:  # the shard's slices where they lie (a view of its own block)
                    kv = tuple(read_slice(state[n], (slice(l, l + 1), slice(None), sl), dev,
                                          places[s])[0] for n, sl in zip(NAMES, spans))
                else:
                    kv = tuple(state[n][l, :, sl] for n, sl in zip(NAMES, spans))
                moved = not laid and dev != kv[0].device
                local = tuple(x.to(dev) for x in kv) if moved else kv
                with _on(dev):
                    part = _local_sparse_partial(
                        q.to(dev), *local, k_new.to(dev), v_new.to(dev), length, s * s_local,
                        chunk_tokens=c, k_sel=k_sel, group=group)
                if moved:
                    for x, y in zip(kv, local):
                        x.copy_(y)
                if laid and 0 <= length - s * s_local < s_local:  # the new rows, everywhere
                    at = length - s * s_local
                    for n, x, i, j in zip(NAMES, local, (length, length, length // c),
                                          (at, at, at // c)):
                        write_slice(state[n], (slice(l, l + 1), slice(None), slice(i, i + 1)),
                                    x[None, :, j: j + 1], places[s])
                parts.append(tuple(x.to(h.device) for x in part))
            for size in (4 * b * cfg.n_heads, 4 * b * cfg.n_heads, 4 * b * cfg.n_heads * d_head):
                RL.collective("all-reduce", size, n_shards, devices=n_shards)  # m, l, o
            m_glob = torch.stack([p[0] for p in parts]).amax(dim=0)
            l_glob = o_glob = None
            for m_s, l_s, o_s in parts:
                corr = torch.exp(m_s - m_glob)
                l_glob = l_s * corr if l_glob is None else l_glob + l_s * corr
                o_glob = o_s * corr if o_glob is None else o_glob + o_s * corr
            out = o_glob / l_glob.clamp_min(1e-30)  # (b, n_kv, g, 1, d)
            out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.n_heads, cfg.d_head)
            h = h + T._out_proj(out.to(q.dtype), lp, cfg)
            h = T._ffn(h, lp, cfg, dropless=True)
            del lp  # one layer's gathered weights at a time
        state["length"] = length + 1
        head = {k: whole(params[k], (slice(None),), home)
                for k in ("final_norm", "embed" if cfg.tie_embeddings else "unembed")}
        return T._logits(head, h, cfg), state

    return step
