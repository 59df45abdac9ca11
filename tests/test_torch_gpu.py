"""The port's CUDA kernels against their plain versions, on the card.

Imports neither jax nor repro, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips. Tolerances: the kernels and the plain
versions compute in float32 and sum in other orders (1e-5 relative);
bfloat16 outputs are each one float32 result rounded once (one ulp). The
bfloat16/float16 flash_attention multiplies P, rounded to the input dtype,
on the tensor cores: 2^-7 of the largest output, about one bfloat16 ulp.
chunk_attention runs its products as split-TF32 terms on the tensor cores
(below 2^-22 of each product, inside the same 1e-5), and is also held to
ref.chunk_attention_split_ref, which repeats those terms in plain torch;
chunk_score runs its products as split float16 terms of power-of-two scaled
query rows (the same 2^-22), inside the same 1e-5.
decode_attention's pools form (per-request buffers by base pointer) is held
to its plain version at the same tolerances and, bit for bit, to the
stacked form on the zero-padded stack at the same table width; likewise
chunk_attention's indexed form (b members reading one pool by index), each
member bit for bit the gathered form on its own chunks.
The chunked selective_scan re-associates the recurrence's sums, so a scan
resumed from its carried state is bit-identical to the whole scan only at
a cut on a chunk boundary; elsewhere it agrees within the same 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention.ref import (chunk_attention_indexed_ref,
                                                     chunk_attention_ref,
                                                     chunk_attention_split_ref)
from repro_torch.kernels.chunk_score import ops as cs_ops
from repro_torch.kernels.chunk_score.ref import chunk_score_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_chunked_ref, selective_scan_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, seed, shape, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def _close(a, b, rel=1e-5):
    err = (a.float() - b.float()).abs().max().item()
    assert err <= rel * b.float().abs().max().item() + 1e-6, err


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,nq,nkv,n,d,c", [
    (20, 8, 2, 100, 32, 16), (64, 28, 4, 1030, 128, 16),
    (5, 2, 2, 37, 64, 1),          # group 1, c = 1, n under one key tile
    (64, 28, 4, 4100, 128, 16),    # the main path's shape, ragged: a split more
    (16, 4, 4, 3000, 128, 64),     # group 1, c = 64
    (33, 14, 2, 20000, 128, 16),   # group 7, ~32 splits of 10 key tiles
    (8, 7, 1, 5000, 40, 1),        # group 7, c = 1: a split per key tile, d padded
    (12, 4, 2, 500, 32, 24),       # c not dividing the 64-key tile
    (64, 28, 4, 4096, 128, 1),     # the token baselines' token scores (AS-H2O)
    (64, 28, 4, 4096, 16, 1),      # IMPRESS's partial keys: d 16, one k-step
    (16, 4, 1, 100, 2, 1),         # the reduced model's IMPRESS probe: 2 dims, element loads
    (24, 14, 2, 700, 44, 16),      # d not a multiple of 8 over two 32-dim groups
])
def test_chunk_score(dev, qdtype, s, nq, nkv, n, d, c):
    q, k = _rand(dev, 0, (s, nq, d), qdtype), _rand(dev, 1, (n, nkv, d), torch.float16)
    before = cs_ops.launches
    got = cs_ops.chunk_score(q, k, c)
    assert cs_ops.launches == before + 1
    _close(got, chunk_score_ref(q, k, c))
    assert torch.equal(got, cs_ops.chunk_score(q, k, c))  # no atomics: reproducible


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16, torch.float16])
def test_chunk_score_wide_row_range(dev, qdtype):
    """The kernel scales each query row by a power of two (its largest |q|
    to [2^14, 2^15)) before its float16 products: rows of magnitude 2^0,
    2^-12 and 2^-30, each of whose elements fall from its largest to 2^-40 of
    it (float16 subnormals and zeros after the scaling), still meet 1e-5."""
    s, nq, nkv, n, d, c = 24, 8, 2, 1030, 128, 16
    elem = torch.exp2(-torch.linspace(0.0, 40.0, d, device=dev))
    row = torch.exp2(-torch.tensor([0.0, 12.0, 30.0], device=dev)).repeat(s // 3)
    q = (_rand(dev, 0, (s, nq, d)) * elem * row[:, None, None]).to(qdtype)
    k = _rand(dev, 1, (n, nkv, d), torch.float16)
    got = cs_ops.chunk_score(q, k, c)
    _close(got, chunk_score_ref(q, k, c))
    assert torch.equal(got, cs_ops.chunk_score(q, k, c))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_valid", [1, 5, 8])
def test_chunk_attention(dev, qdtype, n_valid):
    s, nq, nkv, nb, c, d = 20, 8, 2, 8, 16, 32
    q = _rand(dev, 0, (s, nq, d), qdtype)
    ks, vs = (_rand(dev, i, (nb, c, nkv, d), torch.float16) for i in (1, 2))
    kf, vf = (_rand(dev, i, (s, nkv, d), qdtype) for i in (3, 4))
    o, m = ca_ops.chunk_attention(q, ks, vs, n_valid, kf, vf)
    o2, m2 = chunk_attention_ref(q, ks, vs, n_valid, kf, vf)
    assert o.dtype == o2.dtype == torch.float32
    _close(o, o2)
    _close(m, m2)
    if n_valid < nb:
        assert m[n_valid:].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_pad_slots_and_partial_page(dev, dtype):
    b, nq, nkv, d, page, n_pages = 2, 8, 2, 32, 16, 9
    q = _rand(dev, 0, (b, nq, d), dtype)
    kp, vp = (_rand(dev, i, (b, n_pages, page, nkv, d), dtype) for i in (1, 2))
    tight = torch.tensor([[0, 1, 2, 3, 4, 5, 6], [3, 1, 0, 2, -1, -1, -1]],
                         dtype=torch.int32, device=dev)
    lens = torch.tensor([6 * page + 5, 3 * page + 9], dtype=torch.int32, device=dev)
    o, m = da_ops.decode_attention(q, kp, vp, tight, lens)
    o2, m2 = decode_attention_ref(q, kp, vp, tight, lens)
    _close(o, o2, rel=1e-5 if dtype == torch.float32 else 2.0 ** -7)
    _close(m, m2)
    wide = torch.cat([tight, torch.full((b, 5), -1, dtype=torch.int32, device=dev)], dim=1)
    ow, mw = da_ops.decode_attention(q, kp, vp, wide, lens)
    assert torch.equal(o, ow) and torch.equal(m, mw[..., : tight.shape[1]])
    assert mw[..., tight.shape[1]:].abs().max().item() == 0.0
    assert m[1, :, 4:].abs().max().item() == 0.0


def _all_zero(t):
    return t.numel() == 0 or t.abs().max().item() == 0.0


def _decode_case(dev, dtype, b, nq, nkv, d, page, n_pages, n_active, lens, seed=10):
    """Inputs of a decode call: request i's table names pages in a shuffled
    order, then -1 pad slots up to the widest request."""
    q = _rand(dev, seed, (b, nq, d), dtype)
    kp, vp = (_rand(dev, seed + i, (b, n_pages, page, nkv, d), dtype) for i in (1, 2))
    width = max(n_active)
    tbl = np.full((b, width), -1, np.int32)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(n_active):
        tbl[i, :n] = rng.permutation(n_pages)[:n]
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _check_decode(q, kp, vp, tbl, lens):
    """One launch per call, the plain version's results within tolerance,
    two runs bit-identical, and a pad slot appended to every table changing
    nothing of the real slots."""
    before = da_ops.launches
    o, m = da_ops.decode_attention(q, kp, vp, tbl, lens)
    assert da_ops.launches == before + 1 and o.dtype == q.dtype
    o2, m2 = decode_attention_ref(q, kp, vp, tbl, lens)
    _close(o, o2, rel=1e-5 if q.dtype == torch.float32 else 2.0 ** -7)
    _close(m, m2)
    assert _all_zero(m[tbl[:, None, :].expand_as(m) < 0])
    o3, m3 = da_ops.decode_attention(q, kp, vp, tbl, lens)
    assert torch.equal(o, o3) and torch.equal(m, m3)
    wide = torch.cat([tbl, torch.full((tbl.shape[0], 1), -1, dtype=torch.int32,
                                      device=tbl.device)], dim=1)
    ow, mw = da_ops.decode_attention(q, kp, vp, wide, lens)
    assert torch.equal(o, ow) and torch.equal(m, mw[..., :-1])
    assert mw[..., -1].abs().max().item() == 0.0


@pytest.mark.parametrize("page", [1, 8, 16, 24, 48, 64])
@pytest.mark.parametrize("group,d", [(1, 64), (5, 128), (7, 128), (8, 64)])
def test_decode_attention_edges(dev, page, group, d):
    """b = 2 with different lengths, partial last pages and pad slots, at
    every page size and group the kernel's split and tile layouts turn on
    (pages of 24 and 48 tokens: splits of 48 keys, not 64)."""
    nkv = 2
    n_active = [max(3, 200 // page), max(2, 90 // page)]
    lens = [(n_active[0] - 1) * page + max(1, page // 2), (n_active[1] - 1) * page + 1]
    _check_decode(*_decode_case(dev, torch.bfloat16, 2, group * nkv, nkv, d, page,
                                n_active[0] + 3, n_active, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_decode_attention_split_boundaries(dev, dtype, page, delta):
    """Tables that end one page before, on and one page past a split's end."""
    pps = 64 // page  # the kernel's splits: as many whole pages as fit 64 keys
    n = 3 * pps + delta
    _check_decode(*_decode_case(dev, dtype, 1, 28, 4, 128, page, n + 2, [n],
                                [(n - 1) * page + 3], seed=20))


@pytest.mark.parametrize("page,n_active", [(1, 700), (16, 130), (64, 40)])
def test_decode_attention_many_splits(dev, page, n_active):
    """Many splits: 11 of 64 one-token pages, then 33 and 40, more than the
    24 the merge loads in one batch; a ragged last split and a second
    request of a third of the length."""
    lens = [(n_active - 1) * page + 1, (n_active // 3) * page]
    _check_decode(*_decode_case(dev, torch.bfloat16, 2, 28, 4, 128, page, n_active + 3,
                                [n_active, n_active // 3], lens, seed=60))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,n_valid", [(1, 0), (1, 1), (1, 8), (37, 0), (37, 1), (37, 8),
                                       (64, 5), (130, 8)])
def test_chunk_attention_edges(dev, qdtype, s, n_valid):
    """n_valid 0, 1 and nb; s of 1, not a multiple of the 64-row tile, and
    past one suffix key tile; the main path's heads and d."""
    nq, nkv, nb, c, d = 28, 4, 8, 16, 128
    q = _rand(dev, 30, (s, nq, d), qdtype)
    ks, vs = (_rand(dev, i, (nb, c, nkv, d), torch.float16) for i in (31, 32))
    kf, vf = (_rand(dev, i, (s, nkv, d), qdtype) for i in (33, 34))
    before = ca_ops.launches
    o, m = ca_ops.chunk_attention(q, ks, vs, n_valid, kf, vf)
    assert ca_ops.launches == before + 1 and o.dtype == torch.float32
    for ref in (chunk_attention_ref, chunk_attention_split_ref):
        o2, m2 = ref(q, ks, vs, n_valid, kf, vf)
        _close(o, o2)
        _close(m, m2)
    assert _all_zero(m[n_valid:])
    o3, m3 = ca_ops.chunk_attention(q, ks, vs, n_valid, kf, vf)
    assert torch.equal(o, o3) and torch.equal(m, m3)


@pytest.mark.parametrize("c,group,d,nb", [(24, 5, 64, 7), (64, 1, 128, 64), (5, 7, 32, 7),
                                          (64, 7, 128, 64), (1, 7, 128, 1024)])
def test_chunk_attention_chunk_sizes_and_splits(dev, c, group, d, nb):
    """Chunk sizes that do not divide the 64-key tile, narrow heads, and the
    split layouts the kernel picks: one key tile for each of 64 splits (a
    single row tile), and three tiles per split with a ragged last one; and
    the token baselines' part B, a token a chunk over 1023 valid of 1024."""
    s, nkv = 40, 2
    q = _rand(dev, 40, (s, group * nkv, d))
    ks, vs = (_rand(dev, i, (nb, c, nkv, d), torch.float16) for i in (41, 42))
    kf, vf = (_rand(dev, i, (s, nkv, d)) for i in (43, 44))
    o, m = ca_ops.chunk_attention(q, ks, vs, nb - 1, kf, vf)
    o2, m2 = chunk_attention_ref(q, ks, vs, nb - 1, kf, vf)
    _close(o, o2)
    _close(m, m2)


def _device_kernels(fn, calls=10):
    """{device kernel name: launches per call} over ``calls`` calls of fn
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("ckv::")[-1].split("<")[0].split("(")[0]: e.count / calls
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def test_device_kernels_per_call(dev):
    """decode_attention is one device kernel per call, chunk_attention two
    (the attention pass and the merge, no mass pass), chunk_score two (the
    split pass and the merge) and the scan's decode step one."""
    q, kp, vp, tbl, lens = _decode_case(dev, torch.bfloat16, 1, 28, 4, 128, 16, 70, [69],
                                        [68 * 16 + 5])
    kern = _device_kernels(lambda: da_ops.decode_attention(q, kp, vp, tbl, lens))
    assert kern == {"decode_kernel": 1.0}, kern
    qa = _rand(dev, 50, (64, 28, 128))
    ks, vs = (_rand(dev, i, (64, 16, 4, 128), torch.float16) for i in (51, 52))
    kf, vf = (_rand(dev, i, (64, 4, 128)) for i in (53, 54))
    kern = _device_kernels(lambda: ca_ops.chunk_attention(qa, ks, vs, 64, kf, vf))
    assert kern == {"chunk_attn_kernel": 1.0, "chunk_merge_kernel": 1.0}, kern
    kc = _rand(dev, 55, (4096, 4, 128), torch.float16)
    kern = _device_kernels(lambda: cs_ops.chunk_score(qa, kc, 16))
    assert kern == {"chunk_score_kernel": 1.0, "chunk_score_merge_kernel": 1.0}, kern
    x, dt, A, Bm, Cm = _scan_args(dev, 1, 1, 3200, 16, torch.bfloat16, seed=56)
    h0 = _rand(dev, 60, (1, 3200, 16))
    kern = _device_kernels(lambda: ss_ops.selective_scan(x, dt, A, Bm, Cm, h0))
    assert kern == {"selective_scan_step_kernel": 1.0}, kern


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = _rand(dev, 0, (4, 4, 32))
    with pytest.raises(TypeError):
        cs_ops.chunk_score(q, _rand(dev, 1, (40, 2, 32)), 16)  # keys must be float16
    with pytest.raises(ValueError):  # d past 128
        cs_ops.chunk_score(_rand(dev, 0, (4, 4, 136)), _rand(dev, 1, (40, 2, 136), torch.float16),
                           16)
    flat = _rand(dev, 1, (40 * 2 * 32 + 1,), torch.float16)
    with pytest.raises(ValueError):  # one element off a 16-byte boundary
        cs_ops.chunk_score(q, flat[1:].view(40, 2, 32), 16)


def test_engine_on_the_card_matches_the_cpu(dev):
    """The whole slice at reduced float32 size: the engine on the card, through
    the three kernels, selects the same chunks and decodes the same tokens as
    on the CPU through their plain versions."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.models.transformer import init_params
    from repro_torch.storage.timing import RealExecutor

    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=4), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prefix, suffix = rng.integers(0, cfg.vocab_size, 100), rng.integers(0, cfg.vocab_size, 16)
    runs = {}
    for device in ("cpu", "cuda"):
        p = params if device == "cpu" else {
            k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}
        sess = build_real_session(cfg, p, prefix, in_memory=True, device=device)
        eng = ContiguousKVEngine(sess, RealCompute(cfg, p, device=device), RealExecutor(),
                                 budget=0.25, period=2, subperiod=1)
        counts = (cs_ops.launches, ca_ops.launches, da_ops.launches)
        runs[device] = eng.reprefill(suffix, decode_tokens=8)
        counts = tuple(after - before for after, before in
                       zip((cs_ops.launches, ca_ops.launches, da_ops.launches), counts))
        assert counts == ((0, 0, 0) if device == "cpu" else (2, 4, 32))
    (lc, tc), (lg, tg) = runs["cpu"], runs["cuda"]
    for l, sel in tc.selected_per_layer.items():
        np.testing.assert_array_equal(tg.selected_per_layer[l], sel)
    assert tg.decode_tokens_out == tc.decode_tokens_out
    np.testing.assert_allclose(lg, lc, rtol=0, atol=1e-3 * np.abs(lc).max())


@pytest.mark.parametrize("name", ["as_lru", "as_h2o_lfu", "impress"])
def test_baseline_engines_on_the_card_match_the_cpu(dev, name):
    """The baselines at reduced float32 size on a coarse session of 32-token
    blocks: on the card, through chunk_score at one token a chunk (IMPRESS's
    2-dim partial keys included), chunk_attention at one token or one block a
    chunk and decode_attention over the resident blocks, each engine selects
    the same tokens and decodes the same greedy tokens as on the CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ASH2OEngine, ASLRUEngine, IMPRESSEngine
    from repro_torch.core.session import build_real_session
    from repro_torch.models.transformer import init_params
    from repro_torch.storage.timing import RealExecutor

    cls = {"as_lru": ASLRUEngine, "as_h2o_lfu": ASH2OEngine, "impress": IMPRESSEngine}[name]
    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=4), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prefix, suffix = rng.integers(0, cfg.vocab_size, 100), rng.integers(0, cfg.vocab_size, 16)
    runs = {}
    for device in ("cpu", "cuda"):
        p = params if device == "cpu" else {
            k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}
        sess = build_real_session(cfg, p, prefix, coarse_blocks=True, block_tokens=32,
                                  in_memory=True, device=device)
        eng = cls(sess, RealCompute(cfg, p, device=device), RealExecutor())
        counts = (cs_ops.launches, ca_ops.launches, da_ops.launches)
        runs[device] = eng.reprefill(suffix, decode_tokens=8)
        counts = tuple(after - before for after, before in
                       zip((cs_ops.launches, ca_ops.launches, da_ops.launches), counts))
        expect = (0 if name == "as_lru" else 4, 4, 32)
        assert counts == ((0, 0, 0) if device == "cpu" else expect)
    (lc, tc), (lg, tg) = runs["cpu"], runs["cuda"]
    assert sorted(tg.selected_per_layer) == sorted(tc.selected_per_layer)
    for l, sel in tc.selected_per_layer.items():
        np.testing.assert_array_equal(tg.selected_per_layer[l], sel)
    assert tg.read_amplification == tc.read_amplification
    assert tg.decode_tokens_out == tc.decode_tokens_out
    np.testing.assert_allclose(lg, lc, rtol=0, atol=1e-3 * np.abs(lc).max())


FLASH_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,nq,nkv,s_q,s_k,d,causal,window,q_offset", [
    (1, 10, 2, 130, 130, 64, True, 0, 0),     # group 5, ragged s
    (2, 4, 1, 70, 70, 128, True, 0, 0),
    (1, 10, 2, 200, 200, 64, True, 48, 0),    # sliding window
    (1, 8, 2, 37, 157, 64, True, 0, 120),     # suffix after a prefix
    (1, 6, 3, 65, 90, 32, False, 0, 0),
    (1, 4, 2, 40, 40, 16, True, 0, 0),
])
def test_flash_attention(dev, dtype, b, nq, nkv, s_q, s_k, d, causal, window, q_offset):
    if dtype == torch.float32 and d == 16:
        d = 20  # float32 takes any multiple of 4
    # the model's (b, s, n, d) projections, read through transposed views
    q = _rand(dev, 0, (b, s_q, nq, d), dtype).transpose(1, 2)
    k = _rand(dev, 1, (b, s_k, nkv, d), dtype).transpose(1, 2)
    v = _rand(dev, 2, (b, s_k, nkv, d), dtype).transpose(1, 2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    variant = fa_ops.variant_for(dtype, d)
    assert variant == ("cuda_core_f32" if dtype == torch.float32 else
                       "wgmma" if d in (64, 128) else "mma_sync")
    before, by_variant = fa_ops.launches, fa_ops.launches_by_variant[variant]
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches == before + 1 and got.dtype == dtype
    assert fa_ops.launches_by_variant[variant] == by_variant + 1
    assert got.stride() == q.stride()
    ref = flash_attention_ref(q, k, v, **kw)
    _close(got, ref, rel=FLASH_REL[dtype])
    _close(fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw), ref,
           rel=FLASH_REL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d_in,n", [
    (2, 70, 100, 8), (1, 33, 64, 16), (1, 5, 48, 4),
    # decode steps (the step kernel, s < 16): d_in not a multiple of its
    # 128 channels per CTA, every n it is compiled for
    (1, 1, 3201, 16), (2, 1, 100, 2), (1, 2, 96, 32), (2, 15, 3201, 8),
    (2, 1, 3200, 16), (1, 15, 104, 32), (2, 2, 8192, 4),
    (1, 1, 8192, 16), (2, 1, 8192, 16),  # falcon-mamba's decode step, b 1 and 2
])
def test_selective_scan(dev, dtype, b, s, d_in, n):
    x = _rand(dev, 0, (b, s, d_in), dtype)
    dt = torch.nn.functional.softplus(_rand(dev, 1, (b, s)))
    A = -torch.exp(_rand(dev, 2, (d_in, n)))
    proj = _rand(dev, 3, (b, s, 2 * n + 1), dtype)  # B and C as slices, as the block has them
    Bm, Cm = proj[..., :n], proj[..., n: 2 * n]
    h0 = _rand(dev, 4, (b, d_in, n))
    for seed in (None, h0):
        before = ss_ops.launches
        y, h = ss_ops.selective_scan(x, dt, A, Bm, Cm, seed)
        assert ss_ops.launches == before + 1
        yr, hr = selective_scan_ref(x, dt, A, Bm, Cm, seed)
        _close(y, yr)
        _close(h, hr)
    # resuming from the carried state at a ragged cut: the chunked scan
    # re-associates its sums around the cut, so the resumed run agrees with
    # the whole one within rounding (bit for bit only at a chunk boundary,
    # test_selective_scan_resume_at_a_chunk_boundary); one position has no cut
    if s < 2:
        return
    k = s // 2
    y_full, h_full = ss_ops.selective_scan(x, dt, A, Bm, Cm)
    _, h_mid = ss_ops.selective_scan(x[:, :k].contiguous(), dt[:, :k], A, Bm[:, :k], Cm[:, :k])
    y_res, h_res = ss_ops.selective_scan(x[:, k:].contiguous(), dt[:, k:], A, Bm[:, k:],
                                         Cm[:, k:], h_mid)
    _close(y_res, y_full[:, k:])
    _close(h_res, h_full)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,nq,nkv,s_q,s_k,d,window,q_offset", [
    (1, 10, 2, 700, 700, 64, 0, 0),      # group 5, six key tiles through 3 stages
    (1, 14, 2, 700, 700, 128, 0, 0),     # group 7, six key tiles through 2 stages
    (1, 10, 2, 520, 520, 128, 0, 0),     # group 5 at d 128
    (1, 14, 2, 400, 400, 64, 0, 0),      # group 7 at d 64
    (2, 10, 2, 600, 600, 64, 200, 0),    # b = 2 with a window
    (2, 4, 1, 300, 300, 128, 130, 0),
    (1, 10, 2, 37, 421, 64, 0, 384),     # s_q under one tile after a prefix
    (1, 10, 2, 37, 421, 128, 100, 384),
    (1, 10, 2, 129, 129, 64, 0, 0),      # s one past a tile boundary
    (1, 4, 2, 257, 257, 128, 0, 0),
])
def test_flash_attention_wgmma_edges(dev, dtype, b, nq, nkv, s_q, s_k, d, window, q_offset):
    q = _rand(dev, 5, (b, s_q, nq, d), dtype).transpose(1, 2)
    k = _rand(dev, 6, (b, s_k, nkv, d), dtype).transpose(1, 2)
    v = _rand(dev, 7, (b, s_k, nkv, d), dtype).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = fa_ops.launches_by_variant["wgmma"]
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches_by_variant["wgmma"] == before + 1
    _close(got, flash_attention_ref(q, k, v, **kw), rel=FLASH_REL[dtype])


def _scan_args(dev, b, s, d_in, n, dtype, seed=0):
    x = _rand(dev, seed, (b, s, d_in), dtype)
    dt = torch.nn.functional.softplus(_rand(dev, seed + 1, (b, s)))
    A = -torch.exp(_rand(dev, seed + 2, (d_in, n)))
    proj = _rand(dev, seed + 3, (b, s, 2 * n + 1), dtype)
    return x, dt, A, proj[..., :n], proj[..., n: 2 * n]


CHUNK = ss_ops.CHUNK


@pytest.mark.parametrize("s", [1, ss_ops.CHUNKED_MIN_S - 1, ss_ops.CHUNKED_MIN_S, CHUNK,
                               CHUNK + 1, 3 * CHUNK + 5])
@pytest.mark.parametrize("d_in,n", [(40, 16), (64, 4), (24, 8)])
def test_selective_scan_chunk_edges(dev, s, d_in, n):
    """Every length the variants split on, d_in not a multiple of the
    chunked kernel's 16 channels per CTA, b = 2 seeded with h0."""
    b = 2
    args = _scan_args(dev, b, s, d_in, n, torch.bfloat16)
    h0 = _rand(dev, 9, (b, d_in, n))
    variant = "chunked" if s >= ss_ops.CHUNKED_MIN_S else "sequential"
    before = ss_ops.launches_by_variant[variant]
    y, h = ss_ops.selective_scan(*args, h0)
    assert ss_ops.launches_by_variant[variant] == before + 1
    yr, hr = selective_scan_ref(*args, h0)
    _close(y, yr)
    _close(h, hr)
    if variant == "chunked":  # the decomposition it runs, in plain torch
        yc, hc = selective_scan_chunked_ref(*args, h0, chunk=CHUNK, run=ss_ops.RUN)
        _close(y, yc)
        _close(h, hc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_resume_at_a_chunk_boundary(dev, dtype):
    """Cut on a chunk boundary, the resumed scan runs the same chunks on the
    same inputs and carries as the whole one: bit-identical."""
    s, k = 2 * CHUNK + 70, CHUNK
    assert s - k >= ss_ops.CHUNKED_MIN_S  # both parts take the chunked kernel
    x, dt, A, Bm, Cm = _scan_args(dev, 1, s, 48, 16, dtype, seed=20)
    y_full, h_full = ss_ops.selective_scan(x, dt, A, Bm, Cm)
    _, h_mid = ss_ops.selective_scan(x[:, :k].contiguous(), dt[:, :k], A, Bm[:, :k], Cm[:, :k])
    y_res, h_res = ss_ops.selective_scan(x[:, k:].contiguous(), dt[:, k:], A, Bm[:, k:],
                                         Cm[:, k:], h_mid)
    assert torch.equal(y_res, y_full[:, k:]) and torch.equal(h_res, h_full)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = _rand(dev, 0, (1, 4, 8, 48), torch.bfloat16)
    with pytest.raises(ValueError):  # no tensor-core tile for d = 48
        fa_ops.flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, q.float(), q.float())
    x = _rand(dev, 0, (1, 4, 32))
    with pytest.raises(ValueError):  # n must be a power of two
        ss_ops.selective_scan(x, _rand(dev, 1, (1, 4)), _rand(dev, 2, (32, 3)),
                              _rand(dev, 3, (1, 4, 3)), _rand(dev, 4, (1, 4, 3)))
    with pytest.raises(TypeError):  # B and C must have x's dtype
        ss_ops.selective_scan(x, _rand(dev, 1, (1, 4)), _rand(dev, 2, (32, 4)),
                              _rand(dev, 3, (1, 4, 4), torch.bfloat16),
                              _rand(dev, 4, (1, 4, 4), torch.bfloat16))


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev))


@pytest.mark.parametrize("name", ["hymba-1.5b", "falcon-mamba-7b"])
def test_state_engine_on_the_card_matches_the_cpu(dev, name):
    """The state-space path at reduced float32 size: on the card, through
    flash_attention and selective_scan, the same greedy tokens and logits as
    on the CPU through the plain versions."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import StateCompute
    from repro_torch.core.engine import StateSpaceEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.storage.timing import RealExecutor

    cfg = dataclasses.replace(reduced_config(name, n_layers=3), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prefix, suffix = rng.integers(0, cfg.vocab_size, 90), rng.integers(0, cfg.vocab_size, 13)
    runs = {}
    for device in ("cpu", "cuda"):
        p = params if device == "cpu" else _to(params, dev)
        eng = StateSpaceEngine(cfg, StateCompute(cfg, p, device=device), RealExecutor(),
                               prefix_tokens=prefix)
        counts = (fa_ops.launches, ss_ops.launches)
        runs[device] = eng.reprefill(suffix, decode_tokens=8)
        counts = (fa_ops.launches - counts[0], ss_ops.launches - counts[1])
        L = cfg.n_layers
        assert counts == ((0, 0) if device == "cpu" else
                          (L if cfg.has_attention else 0, L + 8 * L))
    (lc, tc), (lg, tg) = runs["cpu"], runs["cuda"]
    assert tg.decode_tokens_out == tc.decode_tokens_out
    np.testing.assert_allclose(lg, lc, rtol=0, atol=1e-3 * np.abs(lc).max())


# -- decode_attention over per-request pools ----------------------------------
def _pools_case(dev, dtype, page, n_pages, n_active, nq=8, nkv=2, d=64, seed=70):
    """b = len(n_pages) ragged pools of their own page counts, request i's
    table naming n_active[i] of its pages in a shuffled order, then -1 up to
    the widest request; lengths end inside each table's last page."""
    b = len(n_pages)
    q = _rand(dev, seed, (b, nq, d), dtype)
    ks = [_rand(dev, seed + 1 + i, (n, page, nkv, d), dtype) for i, n in enumerate(n_pages)]
    vs = [_rand(dev, seed + 11 + i, (n, page, nkv, d), dtype) for i, n in enumerate(n_pages)]
    width = max(n_active)
    tbl = np.full((b, width), -1, np.int32)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(n_active):
        tbl[i, :n] = rng.permutation(n_pages[i])[:n]
    lens = [(n - 1) * page + 1 + (3 * i) % page for i, n in enumerate(n_active)]
    return (q, ks, vs, torch.from_numpy(tbl).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
def test_decode_attention_pools(dev, dtype, page, b):
    """Ragged pools, some with fewer pages than the table is wide: the plain
    version's results within the file's tolerances, and bit for bit the
    stacked kernel's on the zero-padded stack at the same table width, one
    launch counted by form each."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_pools_ref
    from repro_torch.kernels.decode_attention.ref import stack_pool_buffers

    n_pages = [max(2, (70 if page == 16 else 20) - 7 * i) for i in range(b)]
    n_active = [n - i % 2 for i, n in enumerate(n_pages)]
    q, ks, vs, tbl, lens = _pools_case(dev, dtype, page, n_pages, n_active, seed=70 + b)
    before = dict(da_ops.launches_by_variant)
    o, m = da_ops.decode_attention_pools(q, ks, vs, tbl, lens)
    assert da_ops.launches_by_variant["pools"] == before["pools"] + 1
    o2, m2 = decode_attention_pools_ref(q, ks, vs, tbl, lens)
    _close(o, o2, rel=1e-5 if dtype == torch.float32 else 2.0 ** -7)
    _close(m, m2)
    assert _all_zero(m[tbl[:, None, :].expand_as(m) < 0])
    kp, vp = stack_pool_buffers(ks, vs)
    os_, ms_ = da_ops.decode_attention(q, kp, vp, tbl, lens)
    assert da_ops.launches_by_variant["stacked"] == before["stacked"] + 1
    assert torch.equal(o, os_) and torch.equal(m, ms_)
    o3, m3 = da_ops.decode_attention_pools(q, ks, vs, tbl, lens)
    assert torch.equal(o, o3) and torch.equal(m, m3)


def test_decode_attention_pools_after_a_swap(dev):
    """Device pools swapped out to the host and back land at new addresses:
    a pointer block made before the swap is refused, a new one gives the
    same results bit for bit."""
    from repro_torch.core.backends import DeviceTailPool

    rng = np.random.default_rng(80)
    pools = []
    for n_res in (5, 2, 4):
        kr, vr = (rng.standard_normal((n_res, 16, 2, 64)).astype(np.float16) for _ in range(2))
        suf = tuple(torch.from_numpy(rng.standard_normal((1, 20, 2, 64)).astype(np.float32))
                    .to(dev).to(torch.bfloat16) for _ in range(2))
        pools.append(DeviceTailPool(kr, vr, suf, 16, 8, device=dev))
    width = max(p.n_res + p.cap_pages for p in pools)
    tbl = torch.from_numpy(np.stack([p.table(width) for p in pools])).to(dev)
    lens = torch.tensor([p.valid_tokens for p in pools], dtype=torch.int32, device=dev)
    q = _rand(dev, 81, (3, 8, 64), torch.bfloat16)
    stale = da_ops.PoolPointers(da_ops.pool_pointers([p.k for p in pools], [p.v for p in pools]),
                                torch.zeros(3, 3, dtype=torch.int64, device=dev))
    o, m = da_ops.decode_attention_pools(q, [p.k for p in pools], [p.v for p in pools], tbl, lens)
    before = [p.k.data_ptr() for p in pools]
    for p in pools:
        p.swap_out()
    with pytest.raises(ValueError, match="swapped out"):
        da_ops.decode_attention_pools(q, [p.k for p in pools], [p.v for p in pools], tbl, lens)
    blockers = [torch.empty(p.k.numel() * 4, dtype=p.k.dtype, device=dev) for p in pools]
    for p in pools:
        p.swap_in()
    assert [p.k.data_ptr() for p in pools] != before
    with pytest.raises(ValueError, match="moved"):
        da_ops.decode_attention_pools(q, [p.k for p in pools], [p.v for p in pools], tbl, lens,
                                      stale)
    o2, m2 = da_ops.decode_attention_pools(q, [p.k for p in pools], [p.v for p in pools], tbl,
                                           lens)
    assert torch.equal(o, o2) and torch.equal(m, m2)
    del blockers


def test_decode_attention_pools_raises(dev):
    """Mismatched page geometry, dtype, device or residency, or a batch that
    does not match the pools: refused before any launch."""
    q, ks, vs, tbl, lens = _pools_case(dev, torch.bfloat16, 16, [4, 3], [4, 3])
    before = da_ops.launches
    with pytest.raises(ValueError):  # another page size
        da_ops.decode_attention_pools(q, [ks[0], ks[1][:, :8].contiguous()],
                                      [vs[0], vs[1][:, :8].contiguous()], tbl, lens)
    with pytest.raises(TypeError):  # a pool in another dtype than q
        da_ops.decode_attention_pools(q, [ks[0], ks[1].half()], [vs[0], vs[1].half()], tbl, lens)
    with pytest.raises(ValueError, match="swapped out"):  # a pool on the host
        da_ops.decode_attention_pools(q, [ks[0], ks[1].cpu()], [vs[0], vs[1].cpu()], tbl, lens)
    with pytest.raises(ValueError):  # three pools for a batch of two
        da_ops.decode_attention_pools(q, ks + ks[:1], vs + vs[:1], tbl, lens)
    with pytest.raises(ValueError):  # K and V of different shapes
        da_ops.decode_attention_pools(q, ks, [vs[0], vs[1][:2].contiguous()], tbl, lens)
    assert da_ops.launches == before


def test_decode_step_batch_on_the_card(dev):
    """RealCompute.decode_step_batch at reduced float32 size: device pools
    (the pools form) bit for bit the host pools (the stacked form) on the
    card, both within 1e-4 of the logits' scale of the CPU's plain versions
    (float32 products on both, summed in other orders), two steps."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import DeviceTailPool, RealCompute, TailPool
    from repro_torch.core.stepplan import DecodeBatchCtx
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(9)
    data = [(7 * i + 1, 100 + i, [
        tuple(rng.standard_normal((n, 16, cfg.n_kv_heads, cfg.d_head)).astype(np.float16)
              for _ in range(2))
        + tuple(torch.from_numpy(rng.standard_normal((1, 10 + i, cfg.n_kv_heads, cfg.d_head))
                                 .astype(np.float32)) for _ in range(2))
        for _ in range(cfg.n_layers)]) for i, n in enumerate((3, 1, 2))]

    def run(device, pool_cls):
        p = params if device == "cpu" else _to(params, dev)
        be = RealCompute(cfg, p, device=device)
        ctxs = [DecodeBatchCtx(be, tok, pos, {
            l: pool_cls(kr, vr, (ks.to(device), vs.to(device)), 16, 6, device=device)
            for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]
        outs = []
        for _ in range(2):
            outs.append(be.decode_step_batch(ctxs))
            for c in ctxs:
                c.pos += 1
        return outs

    before = dict(da_ops.launches_by_variant)
    dev_pools, host_pools, cpu = run("cuda", DeviceTailPool), run("cuda", TailPool), run(
        "cpu", DeviceTailPool)
    assert da_ops.launches_by_variant["pools"] - before["pools"] == 2 * cfg.n_layers
    assert da_ops.launches_by_variant["stacked"] - before["stacked"] == 2 * cfg.n_layers
    for step_d, step_h, step_c in zip(dev_pools, host_pools, cpu):
        for (ld, md), (lh, mh), (lc, mc) in zip(step_d, step_h, step_c):
            np.testing.assert_array_equal(ld, lh)
            np.testing.assert_allclose(ld, lc, rtol=0, atol=1e-4 * np.abs(lc).max())
            for l in mc:
                np.testing.assert_array_equal(md[l], mh[l])
                np.testing.assert_allclose(md[l], mc[l], rtol=0, atol=1e-4)


def _indexed_case(dev, seed, b, s, nq, nkv, m, c, d, n_sel, qdtype):
    rng = np.random.default_rng(seed)
    q = _rand(dev, seed, (b, s, nq, d), qdtype)
    kp, vp = (_rand(dev, seed + i, (m, c, nkv, d), torch.float16) for i in (1, 2))
    kf, vf = (_rand(dev, seed + i, (b, s, nkv, d), qdtype) for i in (3, 4))
    idx = torch.from_numpy(np.stack([rng.permutation(m)[:n_sel] for _ in range(b)])
                           .astype(np.int32)).to(dev)
    return q, kp, vp, idx, kf, vf


def _check_indexed(q, kp, vp, idx, nv, kf, vf, plain=True):
    """The indexed call against its plain version and, member by member, bit
    for bit against the gathered call on pool[chunk_idx[i]]."""
    before = dict(ca_ops.launches_by_variant)
    o, m = ca_ops.chunk_attention_indexed(q, kp, vp, idx, nv, kf, vf)
    assert ca_ops.launches_by_variant["indexed"] == before["indexed"] + 1
    assert o.dtype == m.dtype == torch.float32
    if plain:
        o2, m2 = chunk_attention_indexed_ref(q, kp, vp, idx, nv, kf, vf)
        _close(o, o2)
        _close(m, m2)
    for i in range(q.shape[0]):
        n = int(nv[i])
        go, gm = ca_ops.chunk_attention(q[i], kp[idx[i].long()], vp[idx[i].long()], n, kf[i],
                                        vf[i])
        assert torch.equal(o[i], go) and torch.equal(m[i], gm), i
        assert _all_zero(m[i, n:])
    return o, m


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("group,nkv,d,c,m,n_sel", [(7, 4, 128, 16, 256, 64),
                                                    (4, 2, 64, 24, 20, 7),
                                                    (7, 4, 128, 1, 1500, 1024)])
def test_chunk_attention_indexed(dev, qdtype, b, group, nkv, d, c, m, n_sel):
    """The indexed form at b 1, 2 and 4: the main path's heads and d over a
    whole layer's pool of 256 chunks with unsorted indices, a generic d with
    chunks that do not divide the key tile, and a token a chunk; ragged
    n_valid (all, one short, a third, none)."""
    s = 40
    q, kp, vp, idx, kf, vf = _indexed_case(dev, 80, b, s, group * nkv, nkv, m, c, d, n_sel,
                                           qdtype)
    nv = torch.tensor([n_sel, n_sel - 1, n_sel // 3, 0][:b], dtype=torch.int32, device=dev)
    _check_indexed(q, kp, vp, idx, nv, kf, vf)


def test_chunk_attention_indexed_alternating_b(dev):
    """Calls at b 4, 1, 3, 1, 4, 2 in alternating dtypes and chunk counts on
    one kept workspace: a counter a call left non-zero, or too small a
    scratch, would break a later call's A_j or output."""
    nq, nkv, d, c, m = 28, 4, 128, 16, 96
    for k, b in enumerate((4, 1, 3, 1, 4, 2)):
        qdtype = (torch.float32, torch.bfloat16)[k % 2]
        n_sel = (64, 8, 33)[k % 3]
        q, kp, vp, idx, kf, vf = _indexed_case(dev, 90 + k, b, 64, nq, nkv, m, c, d, n_sel,
                                               qdtype)
        nv = torch.tensor([n_sel - i for i in range(b)], dtype=torch.int32, device=dev)
        _check_indexed(q, kp, vp, idx, nv, kf, vf, plain=k < 2)
    torch.cuda.synchronize()


def test_chunk_attention_indexed_device_kernels(dev):
    """The indexed form is the same two device kernels as the gathered one,
    one launch of each for the whole batch."""
    q, kp, vp, idx, kf, vf = _indexed_case(dev, 95, 4, 64, 28, 4, 256, 16, 128, 64,
                                           torch.float32)
    nv = torch.full((4,), 64, dtype=torch.int32, device=dev)
    kern = _device_kernels(lambda: ca_ops.chunk_attention_indexed(q, kp, vp, idx, nv, kf, vf))
    assert kern == {"chunk_attn_kernel": 1.0, "chunk_merge_kernel": 1.0}, kern


def test_chunk_attention_indexed_raises(dev):
    """Shapes and types the kernel does not take raise on the card, and
    nothing runs in their place."""
    q, kp, vp, idx, kf, vf = _indexed_case(dev, 96, 2, 8, 8, 2, 12, 16, 32, 4, torch.float32)
    nv = torch.full((2,), 4, dtype=torch.int32, device=dev)
    before = (ca_ops.launches, dict(ca_ops.launches_by_variant))
    bad = [
        (ValueError, (q, kp, vp, idx[:1], nv, kf, vf)),  # chunk_idx for another batch
        (ValueError, (q, kp[:, :, :1].contiguous(), vp[:, :, :1].contiguous(), idx, nv, kf,
                      vf)),  # pools with another kv head count than the suffix
        (TypeError, (q, kp.float(), vp.float(), idx, nv, kf, vf)),  # pools must be float16
        (TypeError, (q, kp, vp, idx.long(), nv, kf, vf)),  # indices must be int32
        (ValueError, (_rand(dev, 97, (2, 8, 8, 136)), _rand(dev, 98, (12, 16, 2, 136),
                                                            torch.float16),
                      _rand(dev, 99, (12, 16, 2, 136), torch.float16), idx, nv,
                      _rand(dev, 100, (2, 8, 2, 136)), _rand(dev, 101, (2, 8, 2, 136)))),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            ca_ops.chunk_attention_indexed(*args)
    assert (ca_ops.launches, ca_ops.launches_by_variant) == before


def test_part_b_batch_on_the_card(dev):
    """RealCompute.part_b_batch at reduced float32 size: one launch of the
    indexed form for b = 3, each member's A_j bit for bit its single part B's
    (the gathered form), h within 1e-5 of it (the batched projections may
    take other cuBLAS algorithms), and both within 1e-4 of the CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.stepplan import PrefillChunkCtx
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(12)
    s, nb, c, d, nkv = 16, 8, 16, cfg.d_head, cfg.n_kv_heads
    data = []
    for n in (8, 3, 6):
        t = [rng.standard_normal(shape).astype(np.float32) for shape in (
            (1, s, cfg.d_model), (1, s, cfg.n_heads, d), (1, s, nkv, d), (1, s, nkv, d))]
        sel = [rng.standard_normal((nb, c, nkv, d)).astype(np.float16) for _ in range(2)]
        data.append((t, sel, np.arange(nb) < n))
    outs = {}
    for device in ("cpu", "cuda"):
        p = params if device == "cpu" else _to(params, dev)
        be = RealCompute(cfg, p, device=device)
        ctxs = [PrefillChunkCtx(be, 1, *(torch.from_numpy(x).to(device) for x in t), *sel,
                                valid, c) for t, sel, valid in data]
        before = dict(ca_ops.launches_by_variant)
        batched = be.part_b_batch(ctxs)
        if device == "cuda":
            assert ca_ops.launches_by_variant["indexed"] == before["indexed"] + 1
        single = [be.part_b(1, x.h, x.q, x.k_suf, x.v_suf, x.k_sel, x.v_sel, x.valid, c)
                  for x in ctxs]
        outs[device] = (batched, single)
    for dev_out, cpu_out in zip(outs["cuda"], outs["cpu"]):
        for (h, m), (hc, mc) in zip(dev_out, cpu_out):
            np.testing.assert_allclose(h.cpu().numpy(), hc.numpy(), rtol=0,
                                       atol=1e-4 * hc.abs().max().item())
            np.testing.assert_allclose(m, mc, rtol=0, atol=1e-4)
    for (h, m), (hs, ms) in zip(*outs["cuda"]):
        np.testing.assert_array_equal(m, ms)
        _close(h, hs)


# -- the state-space batched decode step and StatePool swap -------------------
def _state_members(dev, name, dtype, b=3):
    """A reduced state-space backend on the card and b requests' pools of one
    length, each with the greedy token its prefill gives."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import StateCompute
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced_config(name, n_layers=3), dtype=dtype)
    be = StateCompute(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev),
                      device=dev)
    rng = np.random.default_rng(5)
    members = []
    for _ in range(b):
        logits, pool = be.prefill(rng.integers(0, cfg.vocab_size, 70), extra_tokens=4)
        members.append((int(np.argmax(logits[0, -1])), pool))
    return cfg, be, members


def _clone_state(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in state.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["hymba-1.5b", "falcon-mamba-7b"])
def test_state_decode_step_batch_on_the_card(dev, name, dtype):
    """StateCompute.decode_step_batch at b = 3 on the card: one step kernel
    launch per layer for the batch, each member's logits against its own
    single step (bfloat16: within 0.1 of the largest logit and cosine 0.998,
    the state-space decode's bfloat16 limits; float32: 1e-4 of the scale),
    each member's state in its own tensors."""
    from repro_torch.core.stepplan import DecodeBatchCtx

    cfg, be, members = _state_members(dev, name, dtype)
    singles = [be.decode_step(tok, _clone_state(pool.state)) for tok, pool in members]
    ptrs = [{k: v.untyped_storage().data_ptr() for k, v in pool.state.items()
             if isinstance(v, torch.Tensor)} for _, pool in members]
    ctxs = [DecodeBatchCtx(be, tok, pool.valid_tokens, {0: pool}) for tok, pool in members]
    before = dict(ss_ops.launches_by_variant)
    outs = be.decode_step_batch(ctxs)
    assert ss_ops.launches_by_variant["sequential"] - before["sequential"] == cfg.n_layers
    for out, (lg, st), (_, pool), ptr in zip(outs, singles, members, ptrs):
        assert out.shape == lg.shape == (1, 1, cfg.vocab_size)
        a, r = out[0, -1].astype(np.float64), lg[0, -1].astype(np.float64)
        if dtype == "bfloat16":
            cos = a @ r / (np.linalg.norm(a) * np.linalg.norm(r))
            assert np.abs(a - r).max() <= 0.1 * np.abs(r).max() and cos >= 0.998
        else:
            np.testing.assert_allclose(a, r, rtol=0, atol=1e-4 * np.abs(r).max())
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    _close(pool.state[k], v, rel=1e-4)
        assert pool.valid_tokens == st["length"]
        assert {k: v.untyped_storage().data_ptr() for k, v in pool.state.items()
                if isinstance(v, torch.Tensor)} == ptr


@pytest.mark.parametrize("name", ["hymba-1.5b", "falcon-mamba-7b"])
def test_state_pool_swap_on_the_card(dev, name):
    """A CUDA state's swap round trip: nbytes each leg, the state on the host
    between them, back on the card bit for bit, the meter seeing the
    swap-in, and the next step as without the swap."""
    from repro_torch.storage.h2d_meter import H2DMeter

    _, be, [(tok, pool)] = _state_members(dev, name, "bfloat16", b=1)
    ref = be.decode_step(tok, _clone_state(pool.state))[0]
    before = _clone_state(pool.state)
    assert pool.is_device and pool.home.type == "cuda"
    n = pool.swap_out()
    assert n == pool.nbytes > 0 and not pool.is_resident and pool.is_device
    assert all(v.device.type == "cpu" for v in pool.state.values()
               if isinstance(v, torch.Tensor))
    with H2DMeter(dev) as meter:
        assert pool.swap_in() == n
    assert meter.total == n and pool.is_resident
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert pool.state[k].device == pool.home and torch.equal(pool.state[k], v)
    np.testing.assert_array_equal(be.decode_step(tok, pool.state)[0], ref)
