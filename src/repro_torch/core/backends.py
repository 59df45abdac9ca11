"""Compute backends: the Re-Prefill engine's and the state-space engine's,
real mode, and the sim mode's workload-driven ``SimCompute``.

RealCompute runs the model layer by layer on one device (the card unless the
caller asks for the CPU). Its three attention steps go through the port's
kernels: identify through ``chunk_score`` (the baselines' token scores too,
at one token a chunk), part B through ``chunk_attention`` (one request over
its gathered chunks; a scheduler's batched part B, ``part_b_batch``, over b
requests' same-layer final prefill chunks in one launch of the kernel's
indexed form) and decode through ``decode_attention``: one request's
step over its pool stacked as a batch of one, a scheduler's batched step
(``decode_step_batch``) over b requests' own pools through the kernel's
pools form, with no pad-and-stack copy. Given a tensor-parallel mesh
(``tp_mesh``), both decode paths run the sharded attend instead
(``launch.sharded_sparse.make_sharded_paged_decode``): the pool's pages split
over the mesh's shards, each shard through ``decode_attention`` with its
logsumexp, the partials combined; the batched step then stacks its pools
first, as the JAX backend does. StateCompute
runs the SSM and hybrid families' serve path (``transformer.prefill`` and
``decode_step``): their prefill attention goes through ``flash_attention``
and every mamba recurrence through ``selective_scan``; a scheduler's batched
step (``decode_step_batch``) stacks b requests' states and runs one step at
batch b, one scan launch per layer for all of them. For tensors on the CPU
the kernels' wrappers run their plain versions.

An MoE model's part B and decode run their FFN dropless, as the JAX
backend's do; the ingest and ``recompute_prefix_kv`` (``transformer.forward``)
keep the config's capacity.

dtypes follow the JAX package, which promotes where torch would refuse:
part B joins float16 store chunks with the suffix KV in float32, so the
hidden state is float32 from the first layer's part B on, and every later
projection multiplies float32 activations by the model's weights in float32
(``models.layers.matmul``). Decode starts from a fresh embedding and stays
in the model dtype.

SimCompute stands in for RealCompute on a simulated executor: it computes
nothing and allocates no tensor, and its token scores, chunk scores and
per-chunk mass come from a ``session.SyntheticWorkload``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_attention.ops import chunk_attention, chunk_attention_indexed
from repro_torch.kernels.chunk_score.ops import chunk_score
from repro_torch.kernels.decode_attention.ops import (PoolPointers, decode_attention,
                                                      decode_attention_pools, pool_pointers)
from repro_torch.kernels.decode_attention.ref import stack_pool_buffers
from repro_torch.models.attention import qkv_project
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import matmul, rms_norm
from repro_torch.models import transformer as T
from repro_torch.models.transformer import _ffn, _logits, layer_params


class TailPool:
    """Preallocated paged KV pool for one (request, layer)'s decode phase.

    Layout: ``[n_res resident unit pages | tail capacity pages]`` in one
    fixed-size buffer of shape ``(n_pages, page, n_kv, d)``. The
    cache-resident unit pages and the prefill suffix KV are paged in once at
    construction; each decode step writes its token's K/V into the next tail
    slot in place. The buffer, the page table (``table()``: active pages
    first, pad slots marked ``-1``) and ``lengths`` keep a fixed shape while
    the tail grows.

    This base class keeps its pages in host memory and uploads them to
    ``device`` on every attend; :class:`DeviceTailPool` keeps the same layout
    in device memory and is what the engine uses by default.
    """

    __slots__ = ("page", "n_res", "cap_pages", "k", "v", "t", "device")
    is_device = False

    def __init__(self, k_res: np.ndarray, v_res: np.ndarray, kv_suffix,
                 page: int, extra_tokens: int, dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        """k_res/v_res: (n_res, page, n_kv, d) float16 resident unit pages;
        kv_suffix: (k, v) tensors each (1, s, n_kv, d) from prefill, or None;
        extra_tokens: decode-token capacity to preallocate past the suffix;
        device: where the attention runs. With ``kv_suffix=None``, pass the
        model compute dtype — appended tail KV must not be silently cast to
        the storage dtype."""
        if page < 1 or extra_tokens < 0:
            raise ValueError(f"page {page} and extra_tokens {extra_tokens}")
        self.page = page
        self.device = resolve_device(device)
        home = self.device if self.is_device else torch.device("cpu")
        self.n_res = int(k_res.shape[0])
        k_suf = None if kv_suffix is None else kv_suffix[0][0]
        v_suf = None if kv_suffix is None else kv_suffix[1][0]
        s = 0 if k_suf is None else k_suf.shape[0]
        self.cap_pages = max(1, -(-(s + extra_tokens) // page))
        n_kv, d = k_res.shape[2], k_res.shape[3]
        # the pool dtype follows the tail KV (model compute dtype)
        if dtype is None:
            dtype = torch.float16 if k_suf is None else k_suf.dtype
        shape = (self.n_res + self.cap_pages, page, n_kv, d)
        self.k = torch.zeros(shape, dtype=dtype, device=home)
        self.v = torch.zeros(shape, dtype=dtype, device=home)
        self.k[: self.n_res] = torch.from_numpy(np.ascontiguousarray(k_res)).to(home)
        self.v[: self.n_res] = torch.from_numpy(np.ascontiguousarray(v_res)).to(home)
        self.t = 0  # valid tail tokens (suffix + decoded so far)
        if s:
            self._write(k_suf, v_suf)

    def _check_capacity(self, n: int):
        if self.t + n > self.cap_pages * self.page:
            raise ValueError(
                f"TailPool overflow: {self.t} + {n} tokens exceed capacity "
                f"{self.cap_pages * self.page}")

    def _write(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write (n, n_kv, d) rows at the tail cursor, in place (an indexed
        assignment into a flat view; it casts to the pool dtype)."""
        n = k_new.shape[0]
        self._check_capacity(n)
        self.k[self.n_res:].view(-1, *self.k.shape[2:])[self.t: self.t + n] = k_new
        self.v[self.n_res:].view(-1, *self.v.shape[2:])[self.t: self.t + n] = v_new
        self.t += n

    def append(self, k_tok: torch.Tensor, v_tok: torch.Tensor):
        """Write one decode position's KV ((1, 1, n_kv, d)) into its page slot."""
        self._write(k_tok.reshape(1, *self.k.shape[2:]),
                    v_tok.reshape(1, *self.v.shape[2:]))

    @property
    def n_tail_pages(self) -> int:
        return -(-self.t // self.page)

    @property
    def n_active(self) -> int:
        """Pages carrying valid tokens: resident + filled tail pages."""
        return self.n_res + self.n_tail_pages

    @property
    def valid_tokens(self) -> int:
        return self.n_res * self.page + self.t

    def table(self, width: int = 0) -> np.ndarray:
        """Page table padded with -1 to ``width`` (default: the full capacity):
        active pages, then pad slots."""
        width = width or (self.n_res + self.cap_pages)
        if width < self.n_active:
            raise ValueError(f"table width {width} < {self.n_active} active pages")
        tbl = np.full(width, -1, np.int32)
        tbl[: self.n_active] = np.arange(self.n_active, dtype=np.int32)
        return tbl

    def _lengths(self) -> torch.Tensor:
        return torch.tensor([self.valid_tokens], dtype=torch.int32, device=self.device)

    def attend_args(self):
        """(k_pool, v_pool, table, lengths) for a b=1 decode_attention call.

        Host pool: the full fixed-size buffer is uploaded on every call."""
        return (self.k[None].to(self.device), self.v[None].to(self.device),
                torch.from_numpy(self.table()[None]).to(self.device),
                self._lengths())

    @property
    def is_resident(self) -> bool:
        return True

    def swap_out(self) -> int:
        """Snapshot the pool to host memory; returns the bytes moved. The
        host pool lives there already: 0 (only :class:`DeviceTailPool`
        pays)."""
        return 0

    def swap_in(self) -> int:
        """Restore the pool after :meth:`swap_out`; returns the bytes moved."""
        return 0


class DeviceTailPool(TailPool):
    """Device-resident TailPool: one upload at decode start, none after.

    The page buffers live on ``device``. The resident unit pages are uploaded
    once at construction and the prefill suffix KV, already on the device, is
    copied in place; each decode step's token KV lands in its slot through an
    indexed assignment, so no pool bytes cross PCIe again. The attend hands
    the kernel the buffers themselves (``k[None]`` is a view), re-uploads the
    page table only when ``n_active`` changes, and sends the 4-byte length.
    ``swap_out`` / ``swap_in`` move the buffers to host memory and back (a
    preemption frees the device memory this way) and restore them bit for
    bit; the buffers come back at new addresses.
    """

    __slots__ = ("_tbl_dev", "_tbl_n", "_resident")
    is_device = True

    def __init__(self, k_res, v_res, kv_suffix, page: int, extra_tokens: int,
                 dtype=None, device="cuda"):
        super().__init__(k_res, v_res, kv_suffix, page, extra_tokens,
                         dtype=dtype, device=device)
        self._tbl_dev = None
        self._tbl_n = -1
        self._resident = True

    def slot(self) -> Tuple[int, int]:
        """(page, offset) the next appended token lands in."""
        p, s = divmod(self.t, self.page)
        return self.n_res + p, s

    def device_table(self) -> torch.Tensor:
        """Device page table (1, width), uploaded again only when a page
        boundary crossing changes ``n_active``."""
        if self._tbl_n != self.n_active:
            self._tbl_n = self.n_active
            self._tbl_dev = torch.from_numpy(self.table()[None]).to(self.device)
        return self._tbl_dev

    def attend_args(self):
        return self.k[None], self.v[None], self.device_table(), self._lengths()

    @property
    def is_resident(self) -> bool:
        """False while swapped out to host memory."""
        return self._resident

    @property
    def nbytes(self) -> int:
        return 2 * self.k.numel() * self.k.element_size()

    def swap_out(self) -> int:
        """Move K and V to host memory (the device copies go with their last
        reference); returns the bytes moved."""
        if not self._resident:
            raise RuntimeError("pool already swapped out")
        self.k = self.k.to("cpu", copy=True)
        self.v = self.v.to("cpu", copy=True)
        self._resident = False
        self._tbl_dev, self._tbl_n = None, -1
        return self.nbytes

    def swap_in(self) -> int:
        """Move K and V back to the device; returns the bytes moved."""
        if self._resident:
            raise RuntimeError("pool is not swapped out")
        self.k = self.k.to(self.device, copy=True)
        self.v = self.v.to(self.device, copy=True)
        self._resident = True
        return self.nbytes


def stack_tail_pools(pools: List[TailPool]):
    """Pack b requests' pools into one ragged decode_attention batch:
    (k_pool, v_pool, table, lengths), the buffers zero-padded to the common
    page count, the tables padded with -1 to the widest capacity. Host pools
    stack in host memory (the caller uploads), device pools on their device.
    The batched decode step does not stack device pools: it hands them to the
    kernel's pools form."""
    p0 = pools[0]
    if not all(p.k.shape[1:] == p0.k.shape[1:] and p.k.dtype == p0.k.dtype
               and p.is_device == p0.is_device and p.is_resident for p in pools):
        raise ValueError("a ragged batch must share one page geometry, dtype and "
                         "residency, and every pool must be resident")
    width = max(p.n_res + p.cap_pages for p in pools)
    table = np.stack([p.table(width) for p in pools])
    lengths = np.array([p.valid_tokens for p in pools], np.int32)
    home = p0.k.device
    k, v = stack_pool_buffers([p.k for p in pools], [p.v for p in pools])
    return (k, v, torch.from_numpy(table).to(home), torch.from_numpy(lengths).to(home))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pools_control(pools: List[List["DeviceTailPool"]], device):
    """Every layer's kernel control data for one batched decode step in one
    upload: [(PoolPointers, table (b, width) int32, lengths (b,) int32)] per
    layer, the width being that layer's widest pool capacity. Built from the
    pools' current buffer addresses (a swap-in moves them), after this step's
    token is counted into each pool."""
    host = []
    offsets = []
    size = 0
    for ps in pools:
        width = max(p.n_res + p.cap_pages for p in ps)
        parts = (pool_pointers([p.k for p in ps], [p.v for p in ps]),
                 np.stack([p.table(width) for p in ps]),
                 np.array([p.valid_tokens for p in ps], np.int32))
        host.append(parts)
        for a in parts:
            offsets.append(size)
            size += _align16(a.nbytes)
    block = np.zeros(size, np.uint8)
    it = iter(offsets)
    for parts in host:
        for a in parts:
            o = next(it)
            block[o: o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(block).to(device)  # the step's one upload
    out = []
    it = iter(offsets)
    for ptrs, table, lengths in host:
        views = []
        for a, dt in ((ptrs, torch.int64), (table, torch.int32), (lengths, torch.int32)):
            o = next(it)
            views.append(dev[o: o + a.nbytes].view(dt).view(a.shape))
        out.append((PoolPointers(ptrs, views[0]), views[1], views[2]))
    return out


class RealCompute:
    """Real-model execution on one device; batch = 1 request.

    ``params`` is the port's params dict (``transformer.init_params`` or
    ``bridge.params_from_numpy``) on ``device``. ``tp_mesh`` (a
    ``launch.mesh.Mesh``, optional) routes ``decode_attend`` and
    ``decode_step_batch`` through the tensor-parallel paged attend, a
    drop-in with the same per-page mass contract."""

    def __init__(self, cfg: ModelConfig, params, *, device="cuda", tp_mesh=None):
        if not cfg.has_attention:
            raise ValueError("Re-Prefill engine needs attention KV")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the backend on {self.device}")
        self.params = params
        self._tp_attend = None
        if tp_mesh is not None:
            # imported here: core's modules import nothing of launch at load
            from repro_torch.launch.sharded_sparse import make_sharded_paged_decode

            self._tp_attend = make_sharded_paged_decode(tp_mesh)

    def embed(self, suffix_tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(np.asarray(suffix_tokens), device=self.device)
        return self.params["embed"][toks][None]

    def part_a(self, layer: int, h: torch.Tensor, prefix_len: int):
        """Pre-attention: norm + QKV for the suffix (positions offset by prefix)."""
        b, s, _ = h.shape
        positions = prefix_len + torch.arange(s, device=self.device).expand(b, s)
        return self.part_a_at(layer, h, positions)

    def part_a_at(self, layer: int, h: torch.Tensor, positions):
        """part_a at explicit (b, s) positions (decode steps)."""
        lp = layer_params(self.params, layer)
        x = rms_norm(h, lp["attn_norm"], self.cfg.norm_eps)
        q, k, v = qkv_project(x, lp, self.cfg,
                              torch.as_tensor(positions, device=self.device))
        return x, q, k, v

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def chunk_scores(self, q, k_probe: np.ndarray, layer: int,
                     chunk_tokens: int) -> np.ndarray:
        """(ceil(n / c),) float32 chunk scores (Eq. 1) by the chunk_score kernel."""
        return chunk_score(q[0], self._upload(k_probe), chunk_tokens).cpu().numpy()

    def token_scores(self, q, k_probe: np.ndarray, layer: int) -> np.ndarray:
        """(n,) float32 token scores a_t (the baselines' H2O selection): the
        chunk_score kernel at ``chunk_tokens=1``, whose chunk scores are then
        the token scores. k_probe: (n, n_kv, d_probe) float16. Partial keys
        (IMPRESS, d_probe < d_head) take q's first d_probe dims, so the scale
        is d_probe^-0.5, as the JAX backend's ``probe_token_scores`` of the
        truncated q takes it."""
        qq = q[0]
        if k_probe.shape[-1] != self.cfg.d_head:
            qq = qq[..., : k_probe.shape[-1]].contiguous()
        return chunk_score(qq, self._upload(k_probe), 1).cpu().numpy()

    def part_b(self, layer: int, h, q, k_suf, v_suf,
               k_sel: np.ndarray, v_sel: np.ndarray, sel_valid: np.ndarray,
               chunk_tokens: int) -> Tuple[torch.Tensor, np.ndarray]:
        """Attention over [selected chunks ; suffix] + out-proj + FFN."""
        n_valid = int(np.count_nonzero(sel_valid))
        if not np.all(sel_valid[:n_valid]):
            raise ValueError("valid chunks must be a prefix of the bucket")
        if k_sel.shape[1] != chunk_tokens:
            raise ValueError(f"chunks of {k_sel.shape[1]} tokens, expected {chunk_tokens}")
        out, mass = chunk_attention(q[0], self._upload(k_sel), self._upload(v_sel),
                                    n_valid, k_suf[0], v_suf[0])
        lp = layer_params(self.params, layer)
        s = out.shape[0]
        h = h + matmul(out.reshape(1, s, -1), lp["wo"].reshape(-1, self.cfg.d_model))
        h = _ffn(h, lp, self.cfg, dropless=True)
        return h, mass.cpu().numpy()

    def part_b_batch(self, ctxs) -> List[Tuple[torch.Tensor, np.ndarray]]:
        """b plans' same-layer final prefill chunks in one batched pass.

        ``ctxs`` are :class:`repro_torch.core.stepplan.PrefillChunkCtx`
        handles of identical shapes (the batch former groups on
        ``shape_key()``). The members' gathered chunks are stacked on the
        host into one pool and go up with the kernel's control block (each
        member's chunk indices into the pool and its valid count) in one
        copy, from pinned memory on the card so the stream does not wait on
        it; one launch of chunk_attention's indexed form attends for all b,
        and the out-projection and FFN run once over the stacked (b, s)
        rows, so the layer's weights stream once for the batch. Returns one
        (h (1, s, d_model), A_j (nb,)) per ctx, in order: what each plan's
        single-request ``part_b`` returns."""
        cfg, b = self.cfg, len(ctxs)
        c0 = ctxs[0]
        nb, c = c0.k_sel.shape[:2]
        if c != c0.chunk_tokens:
            raise ValueError(f"chunks of {c} tokens, expected {c0.chunk_tokens}")
        n_valid = np.array([np.count_nonzero(x.valid) for x in ctxs], np.int32)
        for x, n in zip(ctxs, n_valid):
            if not np.all(np.asarray(x.valid)[:n]):
                raise ValueError("valid chunks must be a prefix of the bucket")
        # one host block: K and V of every member's chunks, then the control
        # block (chunk_idx (b, nb): member i's chunks are rows i nb .. of the
        # pool; n_valid (b,))
        kv_bytes = 2 * b * c0.k_sel.nbytes
        block = torch.empty(kv_bytes + _align16(b * nb * 4) + _align16(b * 4), dtype=torch.uint8,
                            pin_memory=self.device.type == "cuda")
        kv = block[:kv_bytes].view(torch.float16).view(2, b * nb, *c0.k_sel.shape[1:])
        for i, x in enumerate(ctxs):
            kv[0, i * nb: (i + 1) * nb] = torch.from_numpy(np.asarray(x.k_sel))
            kv[1, i * nb: (i + 1) * nb] = torch.from_numpy(np.asarray(x.v_sel))
        idx_at = kv_bytes + _align16(b * nb * 4)
        block[kv_bytes: kv_bytes + b * nb * 4].view(torch.int32)[:] = torch.arange(
            b * nb, dtype=torch.int32)
        block[idx_at: idx_at + b * 4].view(torch.int32)[:] = torch.from_numpy(n_valid)
        dev = block.to(self.device, non_blocking=True)  # the pass's one upload
        pools = dev[:kv_bytes].view(torch.float16).view(2, b * nb, *c0.k_sel.shape[1:])
        chunk_idx = dev[kv_bytes: kv_bytes + b * nb * 4].view(torch.int32).view(b, nb)
        valid = dev[idx_at: idx_at + b * 4].view(torch.int32)
        q = torch.cat([x.q for x in ctxs])
        k_suf = torch.cat([x.k_suf for x in ctxs])
        v_suf = torch.cat([x.v_suf for x in ctxs])
        out, mass = chunk_attention_indexed(q, pools[0], pools[1], chunk_idx, valid, k_suf, v_suf)
        lp = layer_params(self.params, c0.layer)
        s = out.shape[1]
        h = torch.cat([x.h for x in ctxs])
        h = h + matmul(out.reshape(b, s, -1), lp["wo"].reshape(-1, cfg.d_model))
        h = _ffn(h, lp, cfg, dropless=True)
        mass_host = mass.cpu().numpy()
        return [(h[i: i + 1], mass_host[i]) for i in range(b)]

    def recompute_prefix_kv(self, prefix_tokens: np.ndarray, end: int,
                            block_q: int) -> Tuple[np.ndarray, np.ndarray]:
        """KV of the prefix head ``[0, end)``, recomputed from its tokens.

        The ingest's causal forward (``transformer.forward`` with
        ``return_kv=True``, on the card through flash_attention) over the
        first ``end`` tokens: causal attention over a head never sees the
        tail, so each position's KV is the ingested one up to the rounding
        of GEMMs over ``end`` rows instead of the prefix's. The tokens go up
        through ``torch.as_tensor(device=)``, a door the H2D meter counts.
        Returns (k, v), each (L, end, n_kv, d) float16 on the host."""
        toks = torch.as_tensor(np.asarray(prefix_tokens[:end]), device=self.device)[None]
        _, (k, v) = T.forward(self.params, {"tokens": toks}, self.cfg, block_q=block_q,
                              logits_positions="last", return_kv=True)
        return (k[:, 0].to(torch.float16).cpu().numpy(),
                v[:, 0].to(torch.float16).cpu().numpy())

    def logits(self, h) -> np.ndarray:
        return _logits(self.params, h[:, -1:], self.cfg).cpu().numpy()

    def decode_step_batch(self, ctxs) -> List[Tuple[np.ndarray, Dict[int, np.ndarray]]]:
        """One decode position for b requests in one batched pass.

        ``ctxs`` are the :class:`repro_torch.core.stepplan.DecodeBatchCtx`
        handles the engines stamp on their decode ops: input token, absolute
        position and per-layer pools. Each layer runs one part A, one paged
        decode attention and one FFN for the whole ragged batch (the tables
        padded with -1 to the layer's widest pool, ``lengths`` masking the
        rest), streaming the weights once. Device pools take each request's
        token KV by an indexed write in place and go to the kernel's pools
        form as they are; the step uploads one control block (every layer's
        tables, lengths and pool pointers) and brings the logits and masses
        back in one copy. Host pools append on the host, stack there and
        upload, as :class:`TailPool` does for one request. With a
        ``tp_mesh`` the layer's pools are stacked on the device (device pools)
        or the host and go through the sharded attend. Returns one
        (logits (1, 1, vocab), {layer: resident-page mass}) per ctx, in
        order: what each plan's single-request step returns."""
        cfg = self.cfg
        b = len(ctxs)
        pools = [[c.pools[l] for c in ctxs] for l in range(cfg.n_layers)]
        p0 = pools[0][0]
        if not all(p.k.shape[1:] == p0.k.shape[1:] and p.k.dtype == p0.k.dtype
                   and p.is_device == p0.is_device and p.is_resident
                   for ps in pools for p in ps):
            raise ValueError("a batched decode step takes resident pools of one page "
                             "geometry, dtype and residency")
        toks = torch.as_tensor(np.array([c.token for c in ctxs], np.int64), device=self.device)
        h = self.params["embed"][toks][:, None]  # (b, 1, d_model)
        positions = np.array([[c.pos] for c in ctxs], np.int64)
        control = slots = None
        if p0.is_device:
            for ps in pools:
                for p in ps:
                    p._check_capacity(1)
            slots = [[p.slot() for p in ps] for ps in pools]
            for ps in pools:
                for p in ps:
                    p.t += 1  # the slot is written below, in the layer's turn
            control = _pools_control(pools, self.device)
        masses = []
        for l in range(cfg.n_layers):
            _, q, k_cur, v_cur = self.part_a_at(l, h, positions)
            if control is not None:
                for i, p in enumerate(pools[l]):
                    pg, off = slots[l][i]
                    p.k[pg, off] = k_cur[i, 0]
                    p.v[pg, off] = v_cur[i, 0]
                pointers, table, lengths = control[l]
                ks, vs = [p.k for p in pools[l]], [p.v for p in pools[l]]
                if self._tp_attend is None:
                    out, page_mass = decode_attention_pools(q[:, 0], ks, vs, table, lengths,
                                                            pointers)
                else:  # the sharded attend takes one stacked pool, as JAX's does
                    out, page_mass = self._tp_attend(q[:, 0], *stack_pool_buffers(ks, vs),
                                                     table, lengths)
            else:
                k_host, v_host = k_cur.cpu(), v_cur.cpu()
                for i, p in enumerate(pools[l]):
                    p.append(k_host[i], v_host[i])
                k_pool, v_pool, table, lengths = stack_tail_pools(pools[l])
                out, page_mass = (self._tp_attend or decode_attention)(
                    q[:, 0], k_pool.to(self.device), v_pool.to(self.device),
                    table.to(self.device), lengths.to(self.device))
            lp = layer_params(self.params, l)
            h = h + matmul(out.reshape(b, 1, -1), lp["wo"].reshape(-1, cfg.d_model))
            h = _ffn(h, lp, cfg, dropless=True)
            masses.append(page_mass.mean(dim=1))  # (b, width): head-averaged
        logits = _logits(self.params, h[:, -1:], cfg)  # (b, 1, vocab)
        host = torch.cat([logits.reshape(-1)] + [m.reshape(-1) for m in masses]).cpu().numpy()
        logits_h = host[: logits.numel()].reshape(logits.shape)
        at = logits.numel()
        per_layer = []
        for m in masses:
            per_layer.append(host[at: at + m.numel()].reshape(m.shape))
            at += m.numel()
        return [(logits_h[i: i + 1],
                 {l: per_layer[l][i, : pools[l][i].n_res] for l in range(cfg.n_layers)})
                for i in range(b)]

    def decode_attend(self, layer: int, h, q, tail: TailPool):
        """One decode position's sparse attention over `tail`'s paged pool.

        The pool already holds the cache-resident unit pages, the suffix KV
        and every decoded position including the current one. Returns
        (h_out, mass) where mass is the head-averaged per-resident-page
        attention probability (AGC's A_j) from the kernel's online softmax
        (with a ``tp_mesh``, from the sharded attend's combine).
        """
        cfg = self.cfg
        out, page_mass = (self._tp_attend or decode_attention)(q[:, 0], *tail.attend_args())
        lp = layer_params(self.params, layer)
        h = h + matmul(out.reshape(1, 1, -1), lp["wo"].reshape(-1, cfg.d_model))
        h = _ffn(h, lp, cfg, dropless=True)
        mass = page_mass[0].mean(dim=0)[: tail.n_res]  # head-avg, resident
        return h, mass.cpu().numpy()


class SimCompute:
    """Paper-scale simulation: no arrays, selection from a workload model.

    ``workload`` provides ``token_scores(request, layer)``,
    ``decode_token_scores(request, step)`` and ``chunk_mass``; the request
    is the one the engine bound last (``new_request``)."""

    def __init__(self, cfg: ModelConfig, workload):
        self.cfg = cfg
        self.workload = workload
        self._request_id = 0

    def new_request(self, request_id: int):
        self._request_id = request_id

    def embed(self, suffix_tokens):
        return None

    def part_a(self, layer, h, prefix_len):
        return None, None, None, None

    def token_scores(self, q, k_probe, layer: int) -> np.ndarray:
        return self.workload.token_scores(self._request_id, layer)

    def chunk_scores(self, q, k_probe, layer: int, chunk_tokens: int) -> np.ndarray:
        """(m,) chunk scores: the token field zero-padded to whole chunks and
        summed chunk by chunk in float64, as the JAX engine reduces the
        token scores it gets from a backend."""
        tok = self.token_scores(q, k_probe, layer)
        span = -(-len(tok) // chunk_tokens) * chunk_tokens
        return np.asarray(np.add.reduceat(np.pad(tok, (0, span - len(tok))),
                                          np.arange(0, span, chunk_tokens)))

    def part_b(self, layer, h, q, k_suf, v_suf, k_sel, v_sel, sel_valid, chunk_tokens):
        return None, self.workload.chunk_mass(self._request_id, layer, sel_valid)

    def logits(self, h):
        return None

    def decode_scores(self, request_id: int, step: int) -> np.ndarray:
        """Token-importance field for decode position `step`."""
        return self.workload.decode_token_scores(request_id, step)

    def decode_mass(self, request_id: int, layer: int, n_units: int) -> np.ndarray:
        """Per-attended-unit attention mass for the decode-time cache updates."""
        return self.workload.chunk_mass(request_id, layer, np.ones(n_units, bool))


class StatePool:
    """One request's fixed-size serve state for SSM/hybrid decode.

    Instead of a growing paged KV tail, the pool owns the request's whole
    serve-state dict from :func:`transformer.prefill`: the per-layer float32
    recurrence ``ssm_h`` and conv window ``ssm_conv`` (plus the attention KV
    buffers ``k``/``v`` for hybrid models, preallocated to the decode
    capacity). A decode step rewrites the state in place, so ``nbytes`` never
    grows with the decoded length.

    It speaks the preemption contract of :class:`DeviceTailPool`:
    ``swap_out`` moves every tensor to host memory and returns the bytes
    moved, ``swap_in`` restores them bit for bit to the pool's home device
    (where the state was when the pool was built) and returns the same
    count. ``is_device`` says whether the pool is a device pool and does not
    change while it is swapped out, so the scheduler's batch former keys it
    the same; by default it is a device pool when its state lives on a CUDA
    device. A host pool (``device=False``) moves 0 bytes, as in the JAX
    package. Both legs go through ``Tensor.to``, one of the transfer doors
    that :mod:`repro_torch.storage.h2d_meter` counts."""

    __slots__ = ("state", "home", "is_device", "_resident")

    def __init__(self, state: Dict, *, device: Optional[bool] = None):
        """``state``: keys length, ssm_h, ssm_conv[, k, v]."""
        self.state = state
        self.home = state["ssm_h"].device
        self.is_device = self.home.type == "cuda" if device is None else bool(device)
        self._resident = True

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.state.values()
                   if isinstance(t, torch.Tensor))

    @property
    def valid_tokens(self) -> int:
        return int(self.state["length"])

    @property
    def is_resident(self) -> bool:
        """False while swapped out to host memory."""
        return self._resident

    def _move(self, device) -> int:
        for key, t in self.state.items():
            if isinstance(t, torch.Tensor):
                self.state[key] = t.to(device, copy=True)
        return self.nbytes

    def swap_out(self) -> int:
        """Move the state to host memory (the device copies go with their
        last reference); returns the bytes moved."""
        if not self._resident:
            raise RuntimeError("state pool already swapped out")
        self._resident = False
        return self._move("cpu") if self.is_device else 0

    def swap_in(self) -> int:
        """Move the state back to its home device; returns the bytes moved."""
        if self._resident:
            raise RuntimeError("state pool is not swapped out")
        self._resident = True
        return self._move(self.home) if self.is_device else 0


def _stack_states(states: List[Dict]) -> Dict:
    """Stack per-request serve states along the batch axis (axis 1 of every
    tensor; ``length`` is shared and must already agree)."""
    return {key: (states[0][key] if key == "length"
                  else torch.cat([st[key] for st in states], dim=1))
            for key in states[0]}


class StateCompute:
    """Real whole-model backend for the SSM/hybrid families.

    :class:`RealCompute` decomposes attention models into part-A/part-B passes
    around a paged KV pool; the state-space families instead run the serve
    path of :mod:`repro_torch.models.transformer` directly: ``prefill`` fills
    a fixed-size serve state (per-layer float32 recurrence and conv window,
    plus attention KV for hybrid) wrapped in a :class:`StatePool`, and each
    ``decode_step`` advances that state in place, every layer's recurrence
    through the selective_scan kernel. ``decode_step_batch`` is the fleet's
    batching surface: members whose states share one geometry and length
    stack along the batch axis and run one step, one scan launch per layer
    for all of them."""

    def __init__(self, cfg: ModelConfig, params, *, device="cuda"):
        if cfg.family not in T.STATE_FAMILIES:
            raise ValueError("StateCompute serves the state-space families; use "
                             "RealCompute for attention models")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the backend on {self.device}")
        self.params = params

    def new_request(self, request_id: int):
        """Interface parity with the JAX backend (stateless between requests)."""

    def prefill(self, tokens, extra_tokens: int = 0) -> Tuple[np.ndarray, StatePool]:
        """Run the whole prompt; returns (first-token logits (1, 1, vocab),
        StatePool). ``extra_tokens`` preallocates decode capacity in the
        hybrid KV buffers (pure SSM state is length-independent)."""
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)[None]
        state = T.init_serve_state(self.cfg, 1, toks.shape[1] + int(extra_tokens),
                                   device=self.device)
        logits, state = T.prefill(self.params, {"tokens": toks}, self.cfg, state)
        return logits.cpu().numpy(), StatePool(state)

    def decode_step(self, token: int, state) -> Tuple[np.ndarray, Dict]:
        """One greedy decode position; returns (logits, state). The state is
        advanced in place and returned."""
        tok = torch.tensor([[int(token)]], device=self.device)
        logits, state = T.decode_step(self.params, tok, self.cfg, state)
        return logits.cpu().numpy(), state

    def decode_step_batch(self, ctxs) -> List[np.ndarray]:
        """One batched decode pass over ``ctxs``' StatePools; returns one
        (1, 1, vocab) logits array per ctx.

        States that share every tensor's shape and the length stack along
        the batch axis into one ``decode_step``; a ragged batch falls back to
        per-request steps (still one scheduler iteration). JAX hands each
        member a slice of the new stacked state; here each member's slice is
        copied back into its own tensors instead, so the pools keep their
        dicts, tensors and storage (a view would keep the whole stack alive
        and tie the members together: swapping one out would free nothing)."""
        states = [c.pools[0].state for c in ctxs]
        lengths = {int(st["length"]) for st in states}
        shapes = {tuple((k, tuple(v.shape)) for k, v in sorted(st.items()) if k != "length")
                  for st in states}
        if len(lengths) > 1 or len(shapes) > 1:
            return [self.decode_step(c.token, c.pools[0].state)[0] for c in ctxs]
        toks = torch.tensor([[int(c.token)] for c in ctxs], device=self.device)
        logits, stacked = T.decode_step(self.params, toks, self.cfg, _stack_states(states))
        for i, st in enumerate(states):
            for key, t in stacked.items():
                if key == "length":
                    st[key] = t
                else:
                    st[key].copy_(t[:, i: i + 1])
        logits = logits.cpu().numpy()
        return [logits[i: i + 1] for i in range(len(ctxs))]
