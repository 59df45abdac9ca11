"""Compute backends, real mode: the Re-Prefill engine's and the state-space
engine's.

RealCompute runs the model layer by layer on one device (the card unless the
caller asks for the CPU). Its three attention steps go through the port's
kernels: identify through ``chunk_score`` (the baselines' token scores too,
at one token a chunk), part B through
``chunk_attention`` and decode through ``decode_attention``. StateCompute
runs the SSM and hybrid families' serve path (``transformer.prefill`` and
``decode_step``): their prefill attention goes through ``flash_attention``
and every mamba recurrence through ``selective_scan``. For tensors on the
CPU the kernels' wrappers run their plain versions.

dtypes follow the JAX package, which promotes where torch would refuse:
part B joins float16 store chunks with the suffix KV in float32, so the
hidden state is float32 from the first layer's part B on, and every later
projection multiplies float32 activations by the model's weights in float32
(``models.layers.matmul``). Decode starts from a fresh embedding and stays
in the model dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_attention.ops import chunk_attention
from repro_torch.kernels.chunk_score.ops import chunk_score
from repro_torch.kernels.decode_attention.ops import decode_attention
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

    def table(self) -> np.ndarray:
        """Page table over the full capacity: active pages, then -1 pad slots."""
        tbl = np.full(self.n_res + self.cap_pages, -1, np.int32)
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


class DeviceTailPool(TailPool):
    """Device-resident TailPool: one upload at decode start, none after.

    The page buffers live on ``device``. The resident unit pages are uploaded
    once at construction and the prefill suffix KV, already on the device, is
    copied in place; each decode step's token KV lands in its slot through an
    indexed assignment, so no pool bytes cross PCIe again. The attend hands
    the kernel the buffers themselves (``k[None]`` is a view), re-uploads the
    page table only when ``n_active`` changes, and sends the 4-byte length.
    """

    __slots__ = ("_tbl_dev", "_tbl_n")
    is_device = True

    def __init__(self, k_res, v_res, kv_suffix, page: int, extra_tokens: int,
                 dtype=None, device="cuda"):
        super().__init__(k_res, v_res, kv_suffix, page, extra_tokens,
                         dtype=dtype, device=device)
        self._tbl_dev = None
        self._tbl_n = -1

    def device_table(self) -> torch.Tensor:
        """Device page table (1, width), uploaded again only when a page
        boundary crossing changes ``n_active``."""
        if self._tbl_n != self.n_active:
            self._tbl_n = self.n_active
            self._tbl_dev = torch.from_numpy(self.table()[None]).to(self.device)
        return self._tbl_dev

    def attend_args(self):
        return self.k[None], self.v[None], self.device_table(), self._lengths()


class RealCompute:
    """Real-model execution on one device; batch = 1 request.

    ``params`` is the port's params dict (``transformer.init_params`` or
    ``bridge.params_from_numpy``) on ``device``."""

    def __init__(self, cfg: ModelConfig, params, *, device="cuda"):
        if not cfg.has_attention:
            raise ValueError("Re-Prefill engine needs attention KV")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the backend on {self.device}")
        self.params = params

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
        h = _ffn(h, lp, self.cfg)
        return h, mass.cpu().numpy()

    def logits(self, h) -> np.ndarray:
        return _logits(self.params, h[:, -1:], self.cfg).cpu().numpy()

    def decode_attend(self, layer: int, h, q, tail: TailPool):
        """One decode position's sparse attention over `tail`'s paged pool.

        The pool already holds the cache-resident unit pages, the suffix KV
        and every decoded position including the current one. Returns
        (h_out, mass) where mass is the head-averaged per-resident-page
        attention probability (AGC's A_j) from the kernel's online softmax.
        """
        cfg = self.cfg
        out, page_mass = decode_attention(q[:, 0], *tail.attend_args())
        lp = layer_params(self.params, layer)
        h = h + matmul(out.reshape(1, 1, -1), lp["wo"].reshape(-1, cfg.d_model))
        h = _ffn(h, lp, cfg)
        mass = page_mass[0].mean(dim=0)[: tail.n_res]  # head-avg, resident
        return h, mass.cpu().numpy()


class StatePool:
    """One request's fixed-size serve state for SSM/hybrid decode.

    Instead of a growing paged KV tail, the pool owns the request's whole
    serve-state dict from :func:`transformer.prefill`: the per-layer float32
    recurrence ``ssm_h`` and conv window ``ssm_conv`` (plus the attention KV
    buffers ``k``/``v`` for hybrid models, preallocated to the decode
    capacity). A decode step rewrites the state in place, so ``nbytes`` never
    grows with the decoded length. The state stays where it was made; swapping
    it to the host comes with the serving scheduler."""

    __slots__ = ("state",)

    def __init__(self, state: Dict):
        """``state``: keys length, ssm_h, ssm_conv[, k, v]."""
        self.state = state

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.state.values()
                   if isinstance(t, torch.Tensor))

    @property
    def valid_tokens(self) -> int:
        return int(self.state["length"])

    @property
    def is_device(self) -> bool:
        return self.state["ssm_h"].device.type == "cuda"

    @property
    def is_resident(self) -> bool:
        return True


class StateCompute:
    """Real whole-model backend for the SSM/hybrid families; batch = 1 request.

    :class:`RealCompute` decomposes attention models into part-A/part-B passes
    around a paged KV pool; the state-space families instead run the serve
    path of :mod:`repro_torch.models.transformer` directly: ``prefill`` fills
    a fixed-size serve state (per-layer float32 recurrence and conv window,
    plus attention KV for hybrid) wrapped in a :class:`StatePool`, and each
    ``decode_step`` advances that state in place, every layer's recurrence
    through the selective_scan kernel."""

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
