"""Serving steps over a device mesh: the port's stand-in for GSPMD.

The JAX package serves over a mesh by jitting ``make_prefill_step`` and
``make_decode_step`` on params laid out by ``param_shardings``, tokens by
``batch_specs`` and the serve state by ``serve_state_shardings``; XLA's SPMD
partitioner (GSPMD) then splits each layer's compute by the params' specs
and inserts the collectives that join the pieces. The port has no
partitioner, as it has no HLO (``launch/roofline.py``'s ``StepAnalyzer``
stands where the HLO parser stands): :class:`MeshServe` runs every mesh
position's share of each layer itself, one process driving every device of
the mesh, and joins the shares with plain tensor ops where GSPMD's
collectives stand.

A position is (dp shard j, tensor shard t): j row-major over the dp axes,
t over the tensor axes (``launch/mesh.py``). Where ``batch_specs`` splits
the batch (batch >= 16) each dp shard computes its rows; otherwise the
whole batch runs on dp shard 0's positions. Per layer, each computing
position:

- gathers its tensor shard's slice of the layer's weights from the blocks
  that hold it: over the dp axes (FSDP), and over the tensor axes too where
  ``param_specs`` fell back to splitting a weight along another dim than the
  one the compute splits (heads, kv heads or the vocabulary that do not
  divide the axis; mamba's ``w_in``, whose x and z columns lie in two
  blocks); it frees them after the layer. Each gather is an all-gather to a
  step analyzer;
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
- the logits by vocabulary columns (split ceil-wise), gathered on the
  mesh's first device.

Row-parallel partials are summed in shard order in float32 and rounded
once: an all-reduce to the analyzer. The new K/V and mamba state are
written into every block that holds them (a collective-permute where the
block lies at another position). The decode step attends each cache block
on its own, where the block lies, and merges a row's blocks with the
flash-decode combine (``sharded_sparse.combine_partials``) in block order.

Exactness: on a 1 x 1 mesh the steps are bit for bit the unsharded steps;
on a k x 1 mesh at batch >= 16, bit for bit the unsharded steps over each
dp shard's rows; elsewhere they differ by the order of the sums above.

To a step analyzer, the dp shards, the tensor shards and the cache blocks
are loops (``roofline.loop``) with their share of a device, and each sum,
gather and write above a declared collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import Mesh, dp_axes, tp_axes
from repro_torch.launch.sharded_sparse import _on, combine_partials
from repro_torch.launch.sharding import ShardedTensor, block_pieces, gather_slice
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention_decode, qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import matmul, rms_norm, swiglu
from repro_torch.models.moe import MoeRoute, combine, expert_ffn, route_tokens
from repro_torch.models.ssm import (check_scan_dtype, mamba_decode_in, mamba_decode_out,
                                    mamba_in, mamba_out)

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


@dataclasses.dataclass
class _Part:
    """One dp shard's share of a step call."""

    j: int
    rows: slice
    home: torch.device  # its first tensor shard's device
    near: tuple  # that position
    state: Dict[str, Any]
    length: int  # positions already in the cache (decode)
    decode: bool
    spread: float  # the share of a part's cache blocks one device holds
    positions: Optional[torch.Tensor] = None


class MeshServe:
    """Prefill and decode steps over ``mesh`` (see the module docstring).
    ``prefill(params, batch, state)`` and ``decode(params, token, state)``
    take params as trees of ``ShardedTensor`` laid out by
    ``param_shardings``, inputs as ``ShardedTensor`` (or tensors) laid out
    by ``batch_specs`` / ``decode_token_tree``'s spec, and the state's
    ``k``, ``v``, ``ssm_h`` and ``ssm_conv`` as ``ShardedTensor`` laid out by
    ``serve_state_shardings`` (``length`` a Python int). They return the
    logits on the mesh's first device and the state dict, its blocks
    written in place."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, *, block_q: int = 512):
        self.cfg, self.mesh, self.block_q = cfg, mesh, block_q
        self.dp = tuple(a for a in dp_axes(mesh) if a in mesh.axis_names)
        self.tp = tuple(a for a in tp_axes(mesh) if a in mesh.axis_names)
        self.n_dp = math.prod(mesh.shape[a] for a in self.dp)
        self.n_tp = math.prod(mesh.shape[a] for a in self.tp)
        self.shards = plan_shards(cfg, self.n_tp)
        self.first = mesh.devices.flat[0]

    # -- positions and movement ------------------------------------------------
    def pos(self, j: int, t: int) -> tuple:
        """The mesh position of dp shard j's tensor shard t."""
        coord = dict.fromkeys(self.mesh.axis_names, 0)
        for axes, i in ((self.dp, j), (self.tp, t)):
            for a in reversed(axes):
                coord[a], i = i % self.mesh.shape[a], i // self.mesh.shape[a]
        return tuple(coord[a] for a in self.mesh.axis_names)

    def _gather(self, st: ShardedTensor, index, device, near) -> torch.Tensor:
        """``st[index]`` on ``device`` for the position ``near``, declared as
        an all-gather over the blocks read (a permute from one block
        elsewhere)."""
        out, n_blocks, remote = gather_slice(st, index, device, near)
        if remote:
            RL.collective("all-gather" if n_blocks > 1 else "collective-permute",
                          _nbytes(out), max(n_blocks, 2))
        return out

    def _layer_slice(self, st: ShardedTensor, l: int, device, near, *index) -> torch.Tensor:
        return self._gather(st, (slice(l, l + 1),) + index, device, near)[0]

    def _write(self, st: ShardedTensor, index, value: torch.Tensor, near, spread: float):
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

    def _sum(self, parts: List[torch.Tensor], home) -> torch.Tensor:
        """Row-parallel partials summed in shard order on ``home`` in
        float32, rounded once (one partial is returned as it is): an
        all-reduce over the tensor shards."""
        RL.collective("all-reduce", _nbytes(parts[0]), self.n_tp, devices=self.n_tp)
        if len(parts) == 1:
            return parts[0].to(home)
        acc = parts[0].to(device=home, dtype=torch.float32)
        for p in parts[1:]:
            acc += p.to(device=home, dtype=torch.float32)
        return acc.to(parts[0].dtype)

    def _tensor_shards(self, part: _Part):
        """(t, shard, position, device) of each tensor shard, as a loop."""
        for t in RL.loop(range(self.n_tp), per_device=1 / self.n_tp):
            pos = self.pos(part.j, t)
            yield t, self.shards[t], pos, self.mesh.devices[pos]

    # -- weights ---------------------------------------------------------------
    def _weights(self, params, l: int, sh: Shard, dev, near) -> Dict[str, Any]:
        """Shard ``sh``'s slice of layer l's weights on ``dev``, in the shapes
        the model code takes."""
        cfg, L = self.cfg, params["layers"]

        def get(name, *index, tree=L):
            return self._layer_slice(tree[name], l, dev, near, *index)

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

    # -- the steps -------------------------------------------------------------
    def prefill(self, params, batch, state):
        if self.cfg.family in T.STATE_FAMILIES:
            check_scan_dtype(self.cfg)
        inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
        return self._run(params, inputs, state, decode=False)

    def decode(self, params, token, state):
        return self._run(params, token, state, decode=True)

    def _parts(self, b: int) -> List[Tuple[int, int, int]]:
        """(dp shard, first row, end row) of each computing dp shard."""
        if b < 16 or self.n_dp == 1:
            return [(0, 0, b)]
        if b % self.n_dp:
            raise ValueError(f"a batch of {b} rows does not split over {self.n_dp} dp shards")
        r = b // self.n_dp
        return [(j, j * r, (j + 1) * r) for j in range(self.n_dp)]

    def _run(self, params, inputs, state, *, decode: bool):
        cfg = self.cfg
        b, s = inputs.shape[:2]
        length = int(state["length"]) if decode else 0
        parts = self._parts(b)
        logits = torch.empty((b, 1, cfg.vocab_size), dtype=torch.float32, device=self.first)
        offsets = [None] * cfg.n_layers  # MoE: each expert's assignments in earlier parts
        for j, lo, hi in RL.loop(parts, per_device=1 / len(parts)):
            near = self.pos(j, 0)
            part = _Part(j, slice(lo, hi), self.mesh.devices[near], near, state, length,
                         decode, len(parts) / self.n_dp)
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
            x = self._gather(inputs, (part.rows,), part.home, part.near)
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

    def _embed(self, params, tokens, part: _Part):
        """Each tensor shard looks its vocabulary rows up (zeros for a token
        outside them); the rows are summed, which adds zeros alone."""
        parts = []
        V = self.cfg.vocab_size
        for _, sh, pos, dev in self._tensor_shards(part):
            v0, v1 = sh.vocab
            if v1 == v0:
                continue
            table = self._gather(params["embed"], (slice(v0, v1),), dev, pos)
            idx = tokens.to(dev)
            if (v0, v1) == (0, V):
                parts.append(table[idx])
            else:
                idx = idx - v0
                ok = (idx >= 0) & (idx < v1 - v0)
                parts.append(torch.where(ok[..., None], table[idx.clamp(0, v1 - v0 - 1)], 0))
            del table
        return self._sum(parts, part.home)

    def _logits(self, params, h, part: _Part, out):
        """Each tensor shard's vocabulary columns of the logits, into
        ``out`` on the mesh's first device."""
        cfg = self.cfg
        norm = self._gather(params["final_norm"], (ALL,), part.home, part.near)
        h = rms_norm(h, norm, cfg.norm_eps)
        for _, sh, pos, dev in self._tensor_shards(part):
            v0, v1 = sh.vocab
            if v1 == v0:
                continue
            if cfg.tie_embeddings:
                w = self._gather(params["embed"], (slice(v0, v1),), dev, pos).T
            else:
                w = self._gather(params["unembed"], (ALL, slice(v0, v1)), dev, pos)
            with _on(dev):
                out[..., v0:v1] = matmul(h.to(dev), w).to(torch.float32).to(self.first)
            del w
        RL.collective("all-gather", _nbytes(out), self.n_tp)

    def _layer(self, params, l: int, h, part: _Part, route):
        cfg, L = self.cfg, params["layers"]
        home, near = part.home, part.near
        window = int(cfg.window_sizes()[l]) if cfg.has_attention else 0
        x = rms_norm(h, self._layer_slice(L["attn_norm"], l, home, near), cfg.norm_eps)
        ws, qs, ssm_mids, a_parts, proj_parts = {}, {}, {}, [], []
        for t, sh, pos, dev in self._tensor_shards(part):
            ws[t] = self._weights(params, l, sh, dev, pos)
            xt = x.to(dev)
            with _on(dev):
                if "wq" in ws[t]:
                    qs[t] = self._attention_in(xt, ws[t], l, sh, pos, part, window, a_parts)
                if "mamba" in ws[t]:
                    ssm_mids[t] = self._mamba_in(xt, ws[t]["mamba"], l, sh, pos, part,
                                                 proj_parts)
        if part.decode and cfg.has_attention:
            for t, sh, pos, dev in self._tensor_shards(part):
                if t in qs:
                    with _on(dev):
                        attn = self._attend(qs[t], l, sh, pos, part, window)
                        a_parts.append(T._out_proj(attn, ws[t], cfg))
        a_out = self._sum(a_parts, home) if a_parts else None
        s_out = None
        if cfg.family in T.STATE_FAMILIES:
            proj = self._sum(proj_parts, home)
            s_parts = []
            for t, sh, pos, dev in self._tensor_shards(part):
                with _on(dev):
                    s_parts.append(self._mamba_out(ssm_mids[t], proj.to(dev), ws[t]["mamba"],
                                                   l, sh, pos, part))
            s_out = self._sum(s_parts, home)
        del qs, ssm_mids, a_parts, proj_parts
        h = h + T.mixer_out(cfg, a_out, s_out)
        return self._ffn(h, params, l, ws, part, route)  # ws, the gathered layer, dies here

    # -- attention -------------------------------------------------------------
    def _attention_in(self, x, w, l, sh: Shard, pos, part: _Part, window, a_parts):
        """Prefill: the shard's attention partial into ``a_parts``; decode:
        its q. Both write the shard's new K/V."""
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
        seq = slice(part.length, part.length + k.shape[1])
        for name, val in (("k", k), ("v", v)):
            self._write(part.state[name], (slice(l, l + 1), part.rows, seq, slice(*sh.kv)),
                        val[None], pos, part.spread)
        return q

    def _attend(self, q, l, sh: Shard, pos, part: _Part, window):
        """The decode attend of the shard's q heads over the cache blocks
        that hold their kv heads, each block where it lies, the blocks of
        one row and kv heads merged by the flash-decode combine in block
        order. Returns (b, 1, heads, d) on the shard's device."""
        cfg = self.cfg
        g = cfg.n_heads // cfg.n_kv_heads
        (h0, h1), (kv0, kv1) = sh.heads, sh.kv
        kst, vst = part.state["k"], part.state["v"]
        index = (slice(l, l + 1), part.rows, ALL, slice(kv0, kv1))
        groups: Dict[Tuple[int, int], list] = {}
        for piece in block_pieces(kst, index, pos):
            rows, heads = piece[1][1], piece[1][3]
            if (rows.start, rows.stop) != (0, part.rows.stop - part.rows.start):
                raise ValueError("the cache splits a dp shard's rows: not a serve-state layout")
            groups.setdefault((heads.start, heads.stop), []).append(piece)
        outs = []
        for (a, b), pieces in sorted(groups.items()):
            ka, kb = kv0 + a, kv0 + b
            qa, qb = max(h0, ka * g), min(h1, kb * g)
            q_sub = q[:, :, qa - h0: qb - h0]
            idx = kv_index(qa, qb, g, ka)
            pieces.sort(key=lambda p: p[1][2].start)
            combined = len(pieces) > 1
            partials = []
            for bpos, out_sl, blk_sl in RL.loop(pieces, per_device=part.spread):
                dev = self.mesh.devices[bpos]
                kb_, vb_ = kst.block_at(bpos)[blk_sl][0], vst.block_at(bpos)[blk_sl][0]
                if idx is not None:
                    kb_, vb_ = kb_[:, :, list(idx)], vb_[:, :, list(idx)]
                with _on(dev):
                    partials.append(attention_decode(
                        q_sub.to(dev), kb_, vb_, length=part.length + 1, window=window,
                        pos0=out_sl[2].start, return_lse=combined))
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
        ``proj_parts``; the new conv window written. Returns what
        :meth:`_mamba_out` takes."""
        if part.decode:
            conv = self._gather(part.state["ssm_conv"], self._state_index("ssm_conv", l, sh, part),
                                x.device, pos)[0]
            xc, z, new_conv, proj = mamba_decode_in(x, conv, p)
            mid = (xc, z)
        else:
            s = x.shape[1]
            xi, z, xpad, proj = mamba_in(x, p)
            new_conv = xpad[:, s: s + p["conv_w"].shape[0] - 1]
            mid = (xi, z)
        self._write(part.state["ssm_conv"], self._state_index("ssm_conv", l, sh, part),
                    new_conv[None], pos, part.spread)
        proj_parts.append(proj)
        return mid

    def _mamba_out(self, mid, proj, p, l, sh: Shard, pos, part: _Part):
        """The shard's scan and ``w_out`` partial; its new h written."""
        index = self._state_index("ssm_h", l, sh, part)
        if part.decode:
            h0 = self._gather(part.state["ssm_h"], index, proj.device, pos)[0]
            out, h = mamba_decode_out(*mid, proj, h0, p, self.cfg)
        else:
            out, h = mamba_out(*mid, proj, p, self.cfg)
        self._write(part.state["ssm_h"], index, h[None], pos, part.spread)
        return out

    # -- the FFN ---------------------------------------------------------------
    def _ffn(self, h, params, l: int, ws, part: _Part, route):
        cfg, L = self.cfg, params["layers"]
        if cfg.family != "moe" and "w_gate" not in L:
            return h
        x = rms_norm(h, self._layer_slice(L["ffn_norm"], l, part.home, part.near), cfg.norm_eps)
        if cfg.family != "moe":
            parts = []
            for t, _, _, dev in self._tensor_shards(part):
                with _on(dev):
                    parts.append(swiglu(x.to(dev), ws[t]["w_gate"], ws[t]["w_up"],
                                        ws[t]["w_down"]))
            return h + self._sum(parts, part.home)
        xt = x.reshape(-1, cfg.d_model)
        w_router = self._layer_slice(L["moe"]["w_router"], l, part.home, part.near)
        disp = route_tokens(xt, w_router, n_experts=cfg.n_experts, top_k=cfg.top_k,
                            capacity_factor=cfg.moe_capacity_factor, dropless=part.decode,
                            route=route)
        ye_parts = []
        for t, sh, _, dev in self._tensor_shards(part):
            e0, e1 = sh.experts
            w = ws[t]["moe"]
            with _on(dev):
                ye_parts.append((sh.experts, expert_ffn(
                    xt.to(dev), disp.gather_idx[e0:e1].to(dev), w["w_gate"], w["w_up"],
                    w["w_down"])))
        if self.shards[0].experts != (0, cfg.n_experts):  # experts over the shards
            ye = torch.empty((cfg.n_experts, disp.cap, cfg.d_model), dtype=x.dtype,
                             device=part.home)
            for (e0, e1), y in ye_parts:
                ye[e0:e1] = y.to(part.home)
            RL.collective("all-to-all", _nbytes(ye), self.n_tp, devices=self.n_tp)
        else:  # each expert's d_ff columns over the shards
            ye = self._sum([y for _, y in ye_parts], part.home)
        return h + combine(ye, disp, x.dtype).reshape(h.shape)
