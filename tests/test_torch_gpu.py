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
ref.chunk_attention_split_ref, which repeats those terms in plain torch.
The chunked selective_scan re-associates the recurrence's sums, so a scan
resumed from its carried state is bit-identical to the whole scan only at
a cut on a chunk boundary; elsewhere it agrees within the same 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention.ref import (chunk_attention_ref,
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


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,nq,nkv,n,d,c", [(20, 8, 2, 100, 32, 16), (64, 28, 4, 1030, 128, 16)])
def test_chunk_score(dev, qdtype, s, nq, nkv, n, d, c):
    q, k = _rand(dev, 0, (s, nq, d), qdtype), _rand(dev, 1, (n, nkv, d), torch.float16)
    before = cs_ops.launches
    got = cs_ops.chunk_score(q, k, c)
    assert cs_ops.launches == before + 1
    _close(got, chunk_score_ref(q, k, c))
    assert torch.equal(got, cs_ops.chunk_score(q, k, c))  # no atomics: reproducible


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
                                          (64, 7, 128, 64)])
def test_chunk_attention_chunk_sizes_and_splits(dev, c, group, d, nb):
    """Chunk sizes that do not divide the 64-key tile, narrow heads, and the
    split layouts the kernel picks: one key tile for each of 64 splits (a
    single row tile), and three tiles per split with a ragged last one."""
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
    (the attention pass and the merge, no mass pass)."""
    q, kp, vp, tbl, lens = _decode_case(dev, torch.bfloat16, 1, 28, 4, 128, 16, 70, [69],
                                        [68 * 16 + 5])
    kern = _device_kernels(lambda: da_ops.decode_attention(q, kp, vp, tbl, lens))
    assert kern == {"decode_kernel": 1.0}, kern
    qa = _rand(dev, 50, (64, 28, 128))
    ks, vs = (_rand(dev, i, (64, 16, 4, 128), torch.float16) for i in (51, 52))
    kf, vf = (_rand(dev, i, (64, 4, 128)) for i in (53, 54))
    kern = _device_kernels(lambda: ca_ops.chunk_attention(qa, ks, vs, 64, kf, vf))
    assert kern == {"chunk_attn_kernel": 1.0, "chunk_merge_kernel": 1.0}, kern


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = _rand(dev, 0, (4, 4, 32))
    with pytest.raises(TypeError):
        cs_ops.chunk_score(q, _rand(dev, 1, (40, 2, 32)), 16)  # keys must be float16
    with pytest.raises(ValueError):
        cs_ops.chunk_score(q[:, :, :30].contiguous(), _rand(dev, 1, (40, 2, 30), torch.float16), 16)
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
@pytest.mark.parametrize("b,s,d_in,n", [(2, 70, 100, 8), (1, 33, 64, 16), (1, 5, 48, 4)])
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
    # test_selective_scan_resume_at_a_chunk_boundary)
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
