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
from repro_torch.kernels.flash_attention.ref import flash_attention_lse_ref, flash_attention_ref
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import (selective_scan_bwd_chunked_ref,
                                                   selective_scan_bwd_ref,
                                                   selective_scan_chunked_ref, selective_scan_ref)

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
    (64, 8, 4, 1024, 256, 16),     # gemma3-4b's heads: the 256-wide instance, c = 16
    (20, 6, 2, 300, 200, 24),      # a d past 128 padded to 256, c not dividing the tile
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


PROFILER_PAD_S, PROFILER_SESSIONS = 0.02, 3


def _device_kernels(fn, calls=10):
    """{device kernel name: launches per call} over ``calls`` calls of fn
    (torch.profiler).

    A bare session of 10 calls lasts about a millisecond, its kernels
    within ~0.2 ms of its end by the two clocks, and the profiler drops
    kernels near that edge: scripts/check_profiler_window.py saw one bare
    session of 500 keep none and another keep 9 of its 10. The session
    therefore idles PROFILER_PAD_S after it starts and before it stops
    (every padded session kept all its kernels), and a session that still
    kept no device event, or in which some kernel's launches over
    ``calls`` are not a whole number, is run again, up to PROFILER_SESSIONS
    in all: fn launches the same kernels on every call, so only a lost or
    cut trace is empty or fractional, and a wrapper that launches nothing,
    or another set of kernels, reads so every time.

    A session also loses the first kernel records it takes: after the
    suite's earlier tests, a diagnostic session lost its first two or three
    records (a spin kernel, then the scan backward's pack and its backward
    kernel), while fn's outputs, held bit for bit under inputs alternating
    from call to call, showed every pack ran. So each session first launches a spin kernel (``torch.cuda._sleep``)
    and calls fn once, which take those losses, synchronizes, then launches
    a second spin kernel as a marker and calls fn ``calls`` times; only the
    device events that start after the marker count. A session whose marker
    was lost is run again."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        events = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        marks = [t for t, name in events if "spin_kernel" in name]
        if not marks:
            continue
        got = {}
        for t, name in events:
            if t > marks[-1]:
                # the kernel's name: its parameter types may name ckv:: types too
                key = name.split("(")[0].split("ckv::")[-1].split("<")[0]
                got[key] = got.get(key, 0) + 1
        got = {k: n / calls for k, n in got.items()}
        if got and all(float(n).is_integer() for n in got.values()):
            return got
    return got


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
    with pytest.raises(ValueError):  # d past 256
        cs_ops.chunk_score(_rand(dev, 0, (4, 4, 264)), _rand(dev, 1, (40, 2, 264), torch.float16),
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


def _reduced_session_on_card(dev, n_layers=4, prefix_len=128):
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.session import build_real_session
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=n_layers), dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prefix = np.random.default_rng(0).integers(0, cfg.vocab_size, prefix_len)
    return cfg, params, build_real_session(cfg, params, prefix, in_memory=True, device=dev)


@pytest.mark.parametrize("end", [16, 64, 128])
def test_recompute_prefix_kv_on_the_card(dev, end):
    """The compute-or-load recompute on the card: one flash_attention launch
    a layer at s = end, and KV within one float16 rounding of the ingested
    store (GEMMs over end rows may round otherwise than over the prefix's)."""
    from repro_torch.core.backends import RealCompute

    cfg, params, sess = _reduced_session_on_card(dev)
    be = RealCompute(cfg, params, device=dev)
    before = fa_ops.launches
    k, v = be.recompute_prefix_kv(sess.tokens, end, block_q=128)
    assert fa_ops.launches - before == cfg.n_layers
    assert k.shape == v.shape == (cfg.n_layers, end, cfg.n_kv_heads, cfg.d_head)
    assert k.dtype == v.dtype == np.float16
    c = sess.meta.chunk_tokens
    for l in range(cfg.n_layers):
        recs = sess.store.read_units(l, list(range(end // c)))
        stored = np.concatenate([recs[u] for u in range(end // c)])  # (end, 2, n_kv, d)
        for got, ref in ((k[l], stored[:, 0]), (v[l], stored[:, 1])):
            np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32),
                                       rtol=2.0 ** -10, atol=2.0 ** -14)


def test_force_compute_on_the_card_matches_no_planner(dev):
    """ContiguousKV with a force-compute planner on the card: the head of the
    prefix recomputed through flash_attention (a launch a layer), the same
    selections and greedy tokens as without a planner, logits within 1e-3 of
    their scale, fewer SSD bytes."""
    from repro_torch.core.backends import RealCompute
    from repro_torch.core.engine import ContiguousKVEngine
    from repro_torch.core.hybrid import HybridPlanner
    from repro_torch.storage.timing import RealExecutor

    cfg, params, sess = _reduced_session_on_card(dev)
    suffix = np.random.default_rng(1).integers(0, cfg.vocab_size, 16)
    runs = {}
    for mode in (None, "force-compute"):
        eng = ContiguousKVEngine(sess, RealCompute(cfg, params, device=dev), RealExecutor(),
                                 budget=0.25, period=2, subperiod=1,
                                 hybrid=HybridPlanner(mode) if mode else None)
        before = fa_ops.launches
        runs[mode] = eng.reprefill(suffix, decode_tokens=8)
        assert fa_ops.launches - before == (cfg.n_layers if mode else 0)
    (l0, t0), (l1, t1) = runs[None], runs["force-compute"]
    assert t1.recompute_units > 0 and t1.ssd_bytes < t0.ssd_bytes
    for l, sel in t0.selected_per_layer.items():
        np.testing.assert_array_equal(t1.selected_per_layer[l], sel)
    assert t1.decode_tokens_out == t0.decode_tokens_out
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-3 * np.abs(l0).max())


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
                       "wgmma" if d in (64, 128, 256) else "mma_sync")
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
    # d 256 (64-key tiles through 2 stages, 128-row CTAs): s off the tiles
    (1, 2, 2, 37, 37, 256, 0, 0),        # group 1, under one tile
    (2, 4, 2, 70, 70, 256, 0, 0),        # group 2, b = 2
    (1, 8, 4, 300, 300, 256, 100, 0),    # gemma3-4b's group, a window cutting tiles
    (1, 8, 4, 1000, 1000, 256, 0, 0),
    (2, 2, 2, 300, 421, 256, 0, 121),    # queries after a prefix
    (1, 8, 4, 70, 1094, 256, 1024, 1024),  # a suffix past the window after a prefix
])
def test_flash_attention_wgmma_edges(dev, dtype, b, nq, nkv, s_q, s_k, d, window, q_offset):
    """The wgmma kernel at the edges of its tiles, on transposed (b, s, n,
    d) views, within FLASH_REL of its plain version; two runs the same bits."""
    q = _rand(dev, 5, (b, s_q, nq, d), dtype).transpose(1, 2)
    k = _rand(dev, 6, (b, s_k, nkv, d), dtype).transpose(1, 2)
    v = _rand(dev, 7, (b, s_k, nkv, d), dtype).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = fa_ops.launches_by_variant["wgmma"]
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches_by_variant["wgmma"] == before + 1
    _close(got, flash_attention_ref(q, k, v, **kw), rel=FLASH_REL[dtype])
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, **kw))


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
                                                    (7, 4, 128, 1, 1500, 1024),
                                                    (2, 4, 256, 16, 256, 64)])
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


def test_chunk_attention_indexed_member_scratch_alignment(dev):
    """A member scratch that is not a multiple of 4 floats (here its partial
    A_j, 2 kv heads x 5 merge CTAs x 7 chunks = 70 floats, left member 1's
    split partials 8 bytes off a 16-byte boundary): the layout rounds it,
    so the merge's float4 reads stay aligned (this shape faulted with a
    misaligned address before)."""
    q, kp, vp, idx, kf, vf = _indexed_case(dev, 240, 2, 20, 8, 2, 20, 16, 32, 7, torch.float32)
    nv = torch.tensor([7, 3], dtype=torch.int32, device=dev)
    _check_indexed(q, kp, vp, idx, nv, kf, vf)
    torch.cuda.synchronize()


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


# ---------------------------------------------------------------------------
# head dim 256 (gemma3-4b: 8 query heads over 4 kv heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,window,q_offset", [(1100, 0, 0), (1100, 1024, 0), (70, 1024, 1050)])
def test_flash_attention_head_dim_256(dev, dtype, s, window, q_offset):
    """d = 256 with gemma3-4b's group, whole causal and under its 1024-token
    window, and a suffix past the window after a prefix: the wgmma kernel's
    d-256 instance (float32: the CUDA-core one)."""
    nq, nkv, d = 8, 4, 256
    s_k = s + q_offset
    q = _rand(dev, 110, (1, s, nq, d), dtype).transpose(1, 2)
    k = _rand(dev, 111, (1, s_k, nkv, d), dtype).transpose(1, 2)
    v = _rand(dev, 112, (1, s_k, nkv, d), dtype).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    variant = fa_ops.variant_for(dtype, d)
    assert variant == ("cuda_core_f32" if dtype == torch.float32 else "wgmma")
    before = fa_ops.launches_by_variant[variant]
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches_by_variant[variant] == before + 1
    _close(got, flash_attention_ref(q, k, v, **kw), rel=FLASH_REL[dtype])
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,n_valid", [(64, 64), (37, 5), (130, 0)])
def test_chunk_attention_head_dim_256(dev, qdtype, s, n_valid):
    """The gathered form at d = 256: the main path's 64 chunks of 16 tokens
    under a 64-token suffix, a ragged suffix over a few chunks, and a suffix
    past one key tile alone; held to both plain versions, bit for bit
    reproducible."""
    nq, nkv, nb, c, d = 8, 4, 64, 16, 256
    q = _rand(dev, 120, (s, nq, d), qdtype)
    ks, vs = (_rand(dev, i, (nb, c, nkv, d), torch.float16) for i in (121, 122))
    kf, vf = (_rand(dev, i, (s, nkv, d), qdtype) for i in (123, 124))
    before = ca_ops.launches_by_variant["gathered"]
    o, m = ca_ops.chunk_attention(q, ks, vs, n_valid, kf, vf)
    assert ca_ops.launches_by_variant["gathered"] == before + 1
    for ref in (chunk_attention_ref, chunk_attention_split_ref):
        o2, m2 = ref(q, ks, vs, n_valid, kf, vf)
        _close(o, o2)
        _close(m, m2)
    assert _all_zero(m[n_valid:])
    o3, m3 = ca_ops.chunk_attention(q, ks, vs, n_valid, kf, vf)
    assert torch.equal(o, o3) and torch.equal(m, m3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
def test_decode_attention_head_dim_256(dev, dtype, page):
    """Both forms at d = 256: the stacked form (pad slots, partial pages,
    bit for bit under a wider table) and the pools form over ragged
    per-request buffers, bit for bit the stacked form on their stack."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_pools_ref
    from repro_torch.kernels.decode_attention.ref import stack_pool_buffers

    n_active = [1100 // page, 300 // page]
    lens = [(n_active[0] - 1) * page + 3, (n_active[1] - 1) * page + page]
    _check_decode(*_decode_case(dev, dtype, 2, 8, 4, 256, page, n_active[0] + 2, n_active, lens,
                                seed=130))
    n_pages = [1100 // page, 700 // page, 130 // page]
    q, ks, vs, tbl, lens = _pools_case(dev, dtype, page, n_pages, [n - 1 for n in n_pages],
                                       nq=8, nkv=4, d=256, seed=140)
    o, m = da_ops.decode_attention_pools(q, ks, vs, tbl, lens)
    o2, m2 = decode_attention_pools_ref(q, ks, vs, tbl, lens)
    _close(o, o2, rel=1e-5 if dtype == torch.float32 else 2.0 ** -7)
    _close(m, m2)
    kp, vp = stack_pool_buffers(ks, vs)
    os_, ms_ = da_ops.decode_attention(q, kp, vp, tbl, lens)
    assert torch.equal(o, os_) and torch.equal(m, ms_)


def test_head_dims_past_the_kernels_raise(dev):
    """Past 256, and for chunk_attention between 128 and 256, the wrappers
    raise before any launch; flash at 16 bits takes no d but its tiles'."""
    before = (cs_ops.launches, ca_ops.launches, da_ops.launches, fa_ops.launches)
    with pytest.raises(ValueError):
        ca_ops.chunk_attention(_rand(dev, 0, (4, 4, 192)),
                               _rand(dev, 1, (2, 16, 2, 192), torch.float16),
                               _rand(dev, 2, (2, 16, 2, 192), torch.float16), 2,
                               _rand(dev, 3, (4, 2, 192)), _rand(dev, 4, (4, 2, 192)))
    with pytest.raises(ValueError):
        q, kp, vp, tbl, lens = _decode_case(dev, torch.bfloat16, 1, 4, 2, 264, 16, 3, [2], [20])
        da_ops.decode_attention(q, kp, vp, tbl, lens)
    with pytest.raises(ValueError):
        x = _rand(dev, 5, (1, 4, 8, 264))
        fa_ops.flash_attention(x, x[:, :2], x[:, :2])
    with pytest.raises(ValueError):
        x = _rand(dev, 6, (1, 4, 8, 192), torch.bfloat16)
        fa_ops.flash_attention(x, x[:, :2], x[:, :2])
    assert (cs_ops.launches, ca_ops.launches, da_ops.launches, fa_ops.launches) == before


# ---------------------------------------------------------------------------
# the MoE FFN (plain torch on the card: gather, batched products, combine)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_on_the_card_matches_the_cpu(dev, dropless):
    """granite-moe-3b-a800m's routing (40 experts, top 8) at capacity factor
    1.25 (assignments dropped) and dropless, bfloat16: the same routing as
    the CPU, outputs within 2e-2 of the largest (bfloat16 products rounded in
    other places), and two runs on the card the same bits (the combine adds
    each token's experts in a fixed order, no atomics)."""
    from repro_torch.models import moe as PM

    T, d, f, E, k = 512, 256, 64, 40, 8
    rng = np.random.default_rng(150)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)).to(torch.bfloat16)
    p = {name: torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))
         .to(torch.bfloat16)
         for name, shape, std in (("w_router", (d, E), d ** -0.5), ("w_gate", (E, d, f), d ** -0.5),
                                  ("w_up", (E, d, f), d ** -0.5), ("w_down", (E, f, d), f ** -0.5))}
    kw = dict(n_experts=E, top_k=k, capacity_factor=1.25, dropless=dropless)
    pd = {name: t.to(dev) for name, t in p.items()}
    got = PM.moe_ffn(x.to(dev), pd, **kw)
    assert torch.equal(got, PM.moe_ffn(x.to(dev), pd, **kw))
    idx_d, _ = PM._router(x.to(dev), pd["w_router"], k)
    idx_c, _ = PM._router(x, p["w_router"], k)
    assert torch.equal(idx_d.cpu(), idx_c)
    want = PM.moe_ffn(x, p, **kw)
    _close(got.cpu(), want, rel=2e-2)


# ---------------------------------------------------------------------------
# training: flash_attention's backward kernel, and no silent graph cut


def _bwd_inputs(dev, dtype, b, nq, nkv, s_q, s_k, d, transposed, seed=200):
    """q, k, v, the forward kernel's output and an output gradient; with
    ``transposed`` the model's (b, s, n, d) tensors read as (b, n, s, d)."""
    if transposed:
        q = _rand(dev, seed, (b, s_q, nq, d), dtype).transpose(1, 2)
        k = _rand(dev, seed + 1, (b, s_k, nkv, d), dtype).transpose(1, 2)
        v = _rand(dev, seed + 2, (b, s_k, nkv, d), dtype).transpose(1, 2)
    else:
        q = _rand(dev, seed, (b, nq, s_q, d), dtype)
        k, v = (_rand(dev, seed + i, (b, nkv, s_k, d), dtype) for i in (1, 2))
    return q, k, v, _rand(dev, seed + 3, (b, nq, s_q, d), dtype)


def _forward_for_bwd(q, k, v, **kw):
    """The forward kernel's output and, where the backward's variant reads
    one (wgmma), the logsumexp it wrote for that backward (None
    otherwise), as FlashAttentionFn saves them."""
    lse = fa_ops.lse_buffer(q) if fa_ops.writes_lse(q.dtype, q.shape[-1]) else None
    return fa_ops.flash_attention(q, k, v, lse=lse, **kw), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("group,window,q_offset,transposed", [
    (1, 0, 0, False), (2, 0, 0, True), (4, 0, 0, False),
    (2, 40, 0, True), (4, 17, 0, False),  # sliding windows
    (2, 0, 50, True), (1, 30, 50, False),  # queries after a prefix
])
def test_flash_attention_bwd(dev, dtype, d, group, window, q_offset, transposed):
    """The backward kernel against its plain version (float32 1e-5 of each
    gradient's largest element: the same float32 sums in other orders; 16-bit
    2^-7: cuda_core_f32 rounds each gradient's float32 result once; wgmma
    also rounds P and dS to the input dtype before its dV, dK and dQ
    products, which at chip_smoke.py's (t1) shapes came to one bfloat16 ulp
    of the largest gradient, 0.45-0.8 of this limit), one launch a call,
    each gradient with its input's dtype and strides, and two runs the same
    bits (no atomics)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, nkv, s_q = 2, 2, 130
    q, k, v, do = _bwd_inputs(dev, dtype, b, group * nkv, nkv, s_q, s_q + q_offset, d,
                              transposed)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = _forward_for_bwd(q, k, v, **kw)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    assert fa_ops.bwd_launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.stride() == x.stride()
        _close(g, w, rel=FLASH_REL[dtype])
    again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_flash_attention_fn_through_attention_prefill(dev):
    """Under grad, attention_prefill on the card runs FlashAttentionFn: one
    forward and one backward launch, gradients within the plain backward's
    tolerance of autograd through the plain forward; under no_grad only the
    forward kernel runs and the output has no graph."""
    from repro_torch.models.attention import attention_prefill

    q = _rand(dev, 210, (2, 70, 8, 64)).requires_grad_()
    k = _rand(dev, 211, (2, 70, 2, 64)).requires_grad_()
    v = _rand(dev, 212, (2, 70, 2, 64)).requires_grad_()
    do = _rand(dev, 213, (2, 70, 8, 64))
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    out = attention_prefill(q, k, v, window=20)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa_ops.launches, fa_ops.bwd_launches) == (f0 + 1, b0 + 1)
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=20)
    want = torch.autograd.grad(ref.transpose(1, 2), (q, k, v), do)
    for g, w in zip(got, want):
        _close(g, w)
    with torch.no_grad():
        assert attention_prefill(q, k, v).grad_fn is None
    assert fa_ops.bwd_launches == b0 + 1


def test_flash_attention_bwd_copies_an_unaligned_dout(dev):
    """An output gradient whose rows the kernel cannot read in place is
    copied once, counted, and gives the same gradients."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 4, 2, 40, 40, 64, False)
    out, lse = _forward_for_bwd(q, k, v)
    want = fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse)
    flat = torch.empty(do.numel() + 1, dtype=do.dtype, device=dev)
    odd = flat[1:].view(do.shape)  # 2 bytes off a 16-byte boundary
    odd.copy_(do)
    before = fa_ops.dout_copies
    got = fa_ops.flash_attention_bwd(q, k, v, out, odd, lse=lse)
    assert fa_ops.dout_copies == before + 1
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_flash_attention_bwd_raises_on_what_it_does_not_take(dev):
    """float32 at d 256 (no backward kernel: the d-256 one is 16-bit), a
    16-bit head dim no backward kernel takes, and the fp32 kernel's other
    head dims raise, before the forward runs under FlashAttentionFn; nothing
    falls back."""
    before = (fa_ops.launches, fa_ops.bwd_launches)
    for d, dtype in ((256, torch.float32), (96, torch.bfloat16), (20, torch.float32)):
        q = _rand(dev, 220, (1, 4, 32, d), dtype).requires_grad_()
        kv = _rand(dev, 221, (1, 2, 32, d), dtype).requires_grad_()
        with pytest.raises(ValueError):
            fa_ops.FlashAttentionFn.apply(q, kv, kv, True, 0, 0)
        with pytest.raises(ValueError):
            fa_ops.flash_attention_bwd(q.detach(), kv.detach(), kv.detach(), q.detach(),
                                       q.detach())
    assert (fa_ops.launches, fa_ops.bwd_launches) == before


# the wgmma forward's logsumexp (log2 units) against its plain version:
# float32 sums in another order, ex2.approx and log2f (an H100 run measured
# 1.9e-6 at s 4096); 2e-5 is a relative 1.4e-5 on each P
LSE_TOL = 2e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s_q,s_k,window,q_offset", [
    (130, 130, 0, 0),  # a ragged last tile
    (130, 180, 17, 50),  # a window, queries after a prefix
    (130, 40, 20, 0),  # rows 59 on see no key
])
def test_flash_attention_lse(dev, dtype, d, s_q, s_k, window, q_offset):
    """The wgmma forward's logsumexp against flash_attention_lse_ref within
    LSE_TOL, 0 on a row that sees no key; the output the same bits with and
    without the lse pointer."""
    q = _rand(dev, 300, (2, s_q, 4, d), dtype).transpose(1, 2)
    k = _rand(dev, 301, (2, s_k, 2, d), dtype).transpose(1, 2)
    v = _rand(dev, 302, (2, s_k, 2, d), dtype).transpose(1, 2)
    kw = dict(window=window, q_offset=q_offset)
    plain = fa_ops.flash_attention(q, k, v, **kw)
    lse = fa_ops.lse_buffer(q)
    before = fa_ops.launches_by_variant["wgmma"]
    out = fa_ops.flash_attention(q, k, v, lse=lse, **kw)
    assert fa_ops.launches_by_variant["wgmma"] == before + 1
    assert torch.equal(out, plain)
    want = flash_attention_lse_ref(q, k, **kw)
    err = (lse[..., :s_q] - want).abs().max().item()
    assert err <= LSE_TOL, err
    if s_k == 40:
        assert (want[..., 59:] == 0).all() and (lse[..., 59:s_q] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("group,s_q,window,q_offset,transposed", [
    (1, 130, 0, 0, False),   # ragged s: two 64-key tiles and a third of 2
    (2, 130, 0, 0, True),
    (2, 200, 40, 0, True),   # a window that cuts 64-key and 32-key tiles
    (1, 150, 100, 0, False),
    (2, 70, 30, 50, True),   # queries after a prefix, under a window
    (1, 100, 0, 37, False),
    (1, 37, 0, 0, True),     # under one tile everywhere
    (2, 300, 0, 0, False),
    (2, 1000, 0, 0, True),   # many query tiles a dK/dV CTA, many key tiles a dQ one
    (1, 1000, 300, 0, True),
    (2, 70, 64, 1100, True),  # a suffix past the window after a prefix
])
def test_flash_attention_bwd_head_dim_256(dev, dtype, group, s_q, window, q_offset, transposed):
    """The wgmma backward at d 256 (gemma3-4b's heads) against its plain
    version within FLASH_REL (P and dS rounded to 16 bits before their
    products), fed by the wgmma forward's lse; one call counted under wgmma,
    each gradient with its input's dtype and strides, and two runs the same
    bits (no atomics)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    b, nkv, d = 2, 2, 256
    q, k, v, do = _bwd_inputs(dev, dtype, b, group * nkv, nkv, s_q, s_q + q_offset, d,
                              transposed, seed=270)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = _forward_for_bwd(q, k, v, **kw)
    assert lse is not None
    before = fa_ops.bwd_launches_by_variant["wgmma"]
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    assert fa_ops.bwd_launches_by_variant["wgmma"] == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.stride() == x.stride()
        _close(g, w, rel=FLASH_REL[dtype])
    again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s_q,s_k,window,q_offset", [
    (130, 130, 0, 0),
    (130, 180, 17, 50),
    (130, 40, 20, 0),  # rows 59 on see no key
    (37, 37, 0, 0),
    (1000, 1000, 300, 0),
    (70, 1094, 1024, 1024),  # a suffix past the window after a prefix
])
def test_flash_attention_lse_head_dim_256(dev, dtype, s_q, s_k, window, q_offset):
    """The wgmma forward's logsumexp at d 256 against flash_attention_lse_ref
    within LSE_TOL, 0 on a row that sees no key; the output the same bits
    with and without the lse pointer."""
    q = _rand(dev, 310, (2, s_q, 4, 256), dtype).transpose(1, 2)
    k = _rand(dev, 311, (2, s_k, 2, 256), dtype).transpose(1, 2)
    v = _rand(dev, 312, (2, s_k, 2, 256), dtype).transpose(1, 2)
    kw = dict(window=window, q_offset=q_offset)
    plain = fa_ops.flash_attention(q, k, v, **kw)
    lse = fa_ops.lse_buffer(q)
    before = fa_ops.launches_by_variant["wgmma"]
    out = fa_ops.flash_attention(q, k, v, lse=lse, **kw)
    assert fa_ops.launches_by_variant["wgmma"] == before + 1
    assert torch.equal(out, plain)
    want = flash_attention_lse_ref(q, k, **kw)
    err = (lse[..., :s_q] - want).abs().max().item()
    assert err <= LSE_TOL, err
    if s_k == 40:
        assert (want[..., 59:] == 0).all() and (lse[..., 59:s_q] == 0).all()


def test_flash_attention_fn_head_dim_256(dev):
    """FlashAttentionFn at d 256 in bfloat16: the wgmma forward and the
    wgmma backward, which reads the lse the forward saved (no forward launch
    in the backward), the same bits as flash_attention_bwd handed the lse of
    a forward run apart."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 8, 4, 150, 150, 256, True, seed=280)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    f0 = fa_ops.launches_by_variant["wgmma"]
    b0 = dict(fa_ops.bwd_launches_by_variant)
    out = fa_ops.FlashAttentionFn.apply(*leaves, True, 64, 0)
    assert fa_ops.launches_by_variant["wgmma"] == f0 + 1
    got = torch.autograd.grad(out, leaves, do)
    assert fa_ops.launches_by_variant["wgmma"] == f0 + 1
    after = fa_ops.bwd_launches_by_variant
    assert {n: after[n] - b0[n] for n in after} == {n: int(n == "wgmma") for n in after}
    again, lse = _forward_for_bwd(q, k, v, window=64)
    assert torch.equal(again, out)
    want = fa_ops.flash_attention_bwd(q, k, v, again, do, window=64, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_attention_bwd_variants(dev):
    """bwd_launches_by_variant: bfloat16 at d 128 and 256 and float16 at d 64
    run wgmma, float32 and bfloat16 at d 16 cuda_core_f32, one call counted
    once under its variant; wgmma raises without the forward's lse, and no
    forward or backward of another variant takes one."""
    for dtype, d, variant in ((torch.bfloat16, 128, "wgmma"), (torch.float16, 64, "wgmma"),
                              (torch.bfloat16, 256, "wgmma"),
                              (torch.float32, 128, "cuda_core_f32"),
                              (torch.bfloat16, 16, "cuda_core_f32")):
        q, k, v, do = _bwd_inputs(dev, dtype, 1, 4, 2, 70, 70, d, True)
        out, lse = _forward_for_bwd(q, k, v)
        before = dict(fa_ops.bwd_launches_by_variant)
        fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse)
        after = fa_ops.bwd_launches_by_variant
        assert {n: after[n] - before[n] for n in after} == {n: int(n == variant) for n in after}
        assert fa_ops.bwd_variant_for(dtype, d) == variant
        if variant in fa_ops.LSE_VARIANTS:
            f0, b0 = fa_ops.launches, fa_ops.bwd_launches
            with pytest.raises(ValueError):
                fa_ops.flash_attention_bwd(q, k, v, out, do)
            assert (fa_ops.launches, fa_ops.bwd_launches) == (f0, b0)
        else:
            with pytest.raises(ValueError):
                fa_ops.flash_attention(q, k, v, lse=fa_ops.lse_buffer(q))
            with pytest.raises(ValueError):
                fa_ops.flash_attention_bwd(q, k, v, out, do, lse=fa_ops.lse_buffer(q))


def test_flash_attention_fn_saves_the_lse(dev):
    """FlashAttentionFn saves the wgmma forward's lse: its backward launches
    no forward kernel and gives the same bits as flash_attention_bwd handed
    the lse of a forward run apart."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 2, 8, 2, 100, 100, 128, True)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa_ops.FlashAttentionFn.apply(*leaves, True, 30, 0)
    f0 = fa_ops.launches
    got = torch.autograd.grad(out, leaves, do)
    assert fa_ops.launches == f0
    again, lse = _forward_for_bwd(q, k, v, window=30)
    assert torch.equal(again, out)
    want = fa_ops.flash_attention_bwd(q, k, v, again, do, window=30, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_attention_bwd_device_kernels(dev):
    """One wgmma backward call is three device kernels: the preprocess (D),
    dK/dV and dQ, and no stats pass (at d 256 its own dK/dV and dQ kernels);
    a cuda_core_f32 call is its stats, dK/dV and dQ passes."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 16, 8, 512, 512, 128, True)
    out, lse = _forward_for_bwd(q, k, v)
    kern = _device_kernels(lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse))
    assert kern == {"fa_bwd_pre_kernel": 1.0, "fa_bwd_dkdv_wgmma_kernel": 1.0,
                    "fa_bwd_dq_wgmma_kernel": 1.0}, kern
    q, k, v, do = _bwd_inputs(dev, torch.float32, 1, 4, 2, 128, 128, 16, True)
    out = fa_ops.flash_attention(q, k, v)
    kern = _device_kernels(lambda: fa_ops.flash_attention_bwd(q, k, v, out, do))
    assert kern == {"fa_bwd_stats_kernel": 1.0, "fa_bwd_dkdv_kernel": 1.0,
                    "fa_bwd_dq_kernel": 1.0}, kern
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 8, 4, 256, 256, 256, True)
    out, lse = _forward_for_bwd(q, k, v)
    kern = _device_kernels(lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse))
    assert kern == {"fa_bwd_pre_kernel": 1.0, "fa_bwd_dkdv_wgmma256_kernel": 1.0,
                    "fa_bwd_dq_wgmma256_kernel": 1.0}, kern


def _grad_inputs(*tensors):
    return [t.detach().clone().requires_grad_() if t.is_floating_point() else t
            for t in tensors]


def test_wrappers_refuse_grad(dev):
    """Each kernel without a backward raises for CUDA inputs that require
    grad under grad mode (its output would carry no graph), and launches as
    before under no_grad."""
    cases = {}
    q, k = _rand(dev, 230, (20, 8, 32)), _rand(dev, 231, (100, 2, 32), torch.float16)
    cases["chunk_score"] = (cs_ops.chunk_score, (q, k, 16), (0,))
    ks, vs = (_rand(dev, 232 + i, (8, 16, 2, 32), torch.float16) for i in (0, 1))
    kf, vf = (_rand(dev, 234 + i, (20, 2, 32)) for i in (0, 1))
    cases["chunk_attention"] = (ca_ops.chunk_attention, (q, ks, vs, 5, kf, vf), (0, 4, 5))
    qi, kp, vp, idx, kfi, vfi = _indexed_case(dev, 240, 2, 20, 8, 2, 20, 16, 32, 7,
                                              torch.float32)
    nv = torch.tensor([7, 3], dtype=torch.int32, device=dev)
    cases["chunk_attention_indexed"] = (ca_ops.chunk_attention_indexed,
                                        (qi, kp, vp, idx, nv, kfi, vfi), (0, 5, 6))
    qd, kpd, vpd, tbl, lens = _decode_case(dev, torch.float32, 2, 8, 2, 64, 16, 6, [5, 3],
                                           [70, 40])
    cases["decode_attention"] = (da_ops.decode_attention, (qd, kpd, vpd, tbl, lens), (0, 1, 2))
    qp, kps, vps, tblp, lensp = _pools_case(dev, torch.float32, 16, [6, 4], [5, 3])
    cases["decode_attention_pools"] = (
        lambda q_, k0, k1, v0, v1, t, l: da_ops.decode_attention_pools(q_, [k0, k1], [v0, v1],
                                                                        t, l),
        (qp, kps[0], kps[1], vps[0], vps[1], tblp, lensp), (0, 1, 3))
    x = _rand(dev, 250, (1, 40, 32))
    # the scan's wrapper names the autograd Function that trains through it
    scan = (ss_ops.selective_scan,
            (x, _rand(dev, 251, (1, 40)).abs(), -_rand(dev, 252, (32, 4)).abs(),
             _rand(dev, 253, (1, 40, 4)), _rand(dev, 254, (1, 40, 4))), (0, 1, 3))
    for name, (fn, args, grad_at) in [*cases.items(), ("selective_scan", scan)]:
        for i in grad_at:
            tracked = list(args)
            tracked[i] = _grad_inputs(args[i])[0]
            match = "SelectiveScanFn" if name == "selective_scan" else "no backward"
            with pytest.raises(RuntimeError, match=match):
                fn(*tracked)
            with torch.no_grad():
                fn(*tracked)
        fn(*args)  # inputs that need no grad launch under grad mode too
    q, k, v, _ = _bwd_inputs(dev, torch.bfloat16, 1, 4, 2, 40, 40, 64, False)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        fa_ops.flash_attention(q.requires_grad_(), k, v)


def test_training_on_the_card_matches_the_cpu(dev):
    """make_value_and_grad on reduced float32 qwen3-1.7b (d 16) on the card,
    through both flash kernels: the loss within 1e-5 and every gradient leaf
    within 1e-4 of its largest element of the CPU's (the plain path in
    float32: float32 GEMMs and attention summed in other orders); remat True
    and "dots" (selective checkpointing around FlashAttentionFn) the same
    bits as False; 2 forward and 2 backward launches a step."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.models import transformer as PT
    from repro_torch.tree import tree_flatten_with_path, tree_leaves

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(260)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)}
    want_l, want_g = make_value_and_grad(cfg, remat=False)(params, batch)
    on_card = _to(params, dev)
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    got_l, got_g = make_value_and_grad(cfg, remat=False)(on_card, batch)
    assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (cfg.n_layers, cfg.n_layers)
    assert abs(got_l.item() - want_l.item()) <= 1e-5 * abs(want_l.item())
    for (path, g), w in zip(tree_flatten_with_path(got_g), tree_leaves(want_g)):
        _close(g.cpu(), w, rel=1e-4)
    for remat in (True, "dots"):
        f0, b0 = fa_ops.launches, fa_ops.bwd_launches
        rl, rg = make_value_and_grad(cfg, remat=remat)(on_card, batch)
        # the recomputed forward launches the kernel again
        assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (2 * cfg.n_layers,
                                                                    cfg.n_layers)
        assert torch.equal(rl, got_l)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rg), tree_leaves(got_g)))


# The scan's backward against its plain version: float32 results (dA and
# dh0 always, every output of a float32 call) within 1e-5 of each
# gradient's largest element (the same float32 recurrence and sums in other
# orders); the 16-bit outputs (dx, ddt, dB, dC of bfloat16 / float16 inputs)
# within one ulp of the largest element: each is a float32 result rounded
# once, as the plain version's is, so the two round at most one ulp apart.
SCAN_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")


def _scan_bwd_close(got, want, dtype):
    for name, g, w in zip(SCAN_GRADS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rel = SCAN_BWD_REL[dtype] if name in ("dx", "ddt", "dB", "dC") else 1e-5
        _close(g, w, rel=rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,d_in,n", [
    (1, 1, 40, 16), (2, 5, 24, 8), (1, 15, 100, 4),  # sequential forwards: no carries
    (2, 16, 48, 16), (1, 255, 40, 32), (2, 257, 100, 16),  # one chunk, one past it
    (1, 700, 64, 2), (2, 3 * CHUNK + 5, 200, 16),  # ragged last chunks, d_in of 13 CTAs
    # the backward's own edges: an odd d_in (a warp's second channel dead, x
    # rows copied without 16-byte vectors), d_in under one CTA's 16
    # channels, two whole chunks, n 32 (32 rows of sums, one CTA an SM) and
    # n 2 (four groups of warps with rows of their own) past one chunk
    (2, 40, 33, 16), (1, 2 * CHUNK, 8, 16), (2, 300, 24, 32), (2, CHUNK + 3, 17, 2),
])
@pytest.mark.parametrize("seeded", [False, True])
def test_selective_scan_bwd(dev, dtype, b, s, d_in, n, seeded):
    """The backward kernel against its plain version (and, where the forward
    is chunked, the plain form of its own decomposition: runs of BWD_RUN) at
    ragged s, d_in not a multiple of 16, B and C strided slices of the
    projection, dt in x's dtype as the model passes it, with and without h0
    and dh_final; one call counted; two runs the same bits (no atomics)."""
    x, dt, A, Bm, Cm = _scan_args(dev, b, s, d_in, n, dtype, seed=400)
    dt = dt.to(dtype)
    h0 = _rand(dev, 405, (b, d_in, n)) if seeded else None
    dh = _rand(dev, 406, (b, d_in, n)) if seeded else None
    dy = _rand(dev, 407, (b, s, d_in))
    chunked = ss_ops.variant_for(s) == "chunked"
    carries = ss_ops.carries_buffer(x, n) if chunked else None
    ss_ops.selective_scan(x, dt, A, Bm, Cm, h0, carries=carries)
    before = ss_ops.bwd_launches
    got = ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, carries=carries)
    assert ss_ops.bwd_launches == before + 1
    _scan_bwd_close(got, selective_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh), dtype)
    if chunked:
        _scan_bwd_close(got, selective_scan_bwd_chunked_ref(x, dt, A, Bm, Cm, h0, dy, dh,
                                                            chunk=CHUNK, run=ss_ops.BWD_RUN),
                        dtype)
    again = ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, h0, dy, dh, carries=carries)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [ss_ops.CHUNKED_MIN_S, CHUNK, 2 * CHUNK + 70])
def test_selective_scan_forward_with_carries(dev, dtype, s):
    """The chunked forward with its carries stores is the same bits as
    without them, counted under the same variant; carry k is h0 at k = 0 and
    the h_final of the first k chunks alone (bit for bit: a scan cut on a
    chunk boundary runs the same chunks)."""
    x, dt, A, Bm, Cm = _scan_args(dev, 2, s, 48, 16, dtype, seed=420)
    h0 = _rand(dev, 425, (2, 48, 16))
    y0, hf0 = ss_ops.selective_scan(x, dt, A, Bm, Cm, h0)
    carries = ss_ops.carries_buffer(x, 16)
    before = ss_ops.launches_by_variant["chunked"]
    y1, hf1 = ss_ops.selective_scan(x, dt, A, Bm, Cm, h0, carries=carries)
    assert ss_ops.launches_by_variant["chunked"] == before + 1
    assert torch.equal(y0, y1) and torch.equal(hf0, hf1)
    assert carries.shape == (2, -(-s // CHUNK), 48, 16) and torch.equal(carries[:, 0], h0)
    for k in range(1, carries.shape[1]):
        cut = k * CHUNK
        _, h_cut = ss_ops.selective_scan(x[:, :cut].contiguous(), dt[:, :cut], A, Bm[:, :cut],
                                         Cm[:, :cut], h0)
        assert torch.equal(carries[:, k], h_cut)


def test_selective_scan_fn_against_autograd_of_the_plain_scan(dev):
    """SelectiveScanFn's gradients (x, dt, A, the projection that B and C
    slice, h0) against autograd through selective_scan_ref, for y and
    h_final at once, chunked and sequential; inputs that need no grad get
    None; one forward and one backward call each."""
    for dtype, s in ((torch.float32, 300), (torch.bfloat16, 300), (torch.float32, 7)):
        b, d_in, n = 2, 40, 16
        x, dt, A, _, _ = _scan_args(dev, b, s, d_in, n, dtype, seed=440)
        proj = _rand(dev, 443, (b, s, 2 * n + 1), dtype)
        h0 = _rand(dev, 444, (b, d_in, n))
        dy, dh = _rand(dev, 445, (b, s, d_in)), _rand(dev, 446, (b, d_in, n))

        def run(fn, leaves):
            x_, dt_, A_, p_, h_ = leaves
            return fn(x_, dt_, A_, p_[..., :n], p_[..., n: 2 * n], h_)

        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, proj, h0)]
        f0, b0 = ss_ops.launches, ss_ops.bwd_launches
        got = torch.autograd.grad(run(ss_ops.SelectiveScanFn.apply, leaves), leaves, (dy, dh))
        assert (ss_ops.launches - f0, ss_ops.bwd_launches - b0) == (1, 1)
        ref_leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, proj, h0)]
        want = torch.autograd.grad(run(selective_scan_ref, ref_leaves), ref_leaves, (dy, dh))
        for name, g, w in zip(("x", "dt", "A", "proj", "h0"), got, want):
            rel = SCAN_BWD_REL[dtype] if name in ("x", "proj") else 1e-5
            _close(g, w, rel=rel)
        only_x = [x.detach().clone().requires_grad_(), dt, A, proj, h0]
        (gx,) = torch.autograd.grad(run(ss_ops.SelectiveScanFn.apply, only_x), only_x[:1],
                                    (dy, dh))
        _close(gx, want[0], rel=SCAN_BWD_REL[dtype])


def test_selective_scan_bwd_raises_on_what_it_does_not_take(dev):
    """A sequence past one chunk without the forward's carries, n off the
    compiled sizes, a dy of the wrong dtype: each raises, and
    SelectiveScanFn raises before its forward launches."""
    x, dt, A, Bm, Cm = _scan_args(dev, 1, CHUNK + 1, 32, 4, torch.bfloat16, seed=460)
    dy = _rand(dev, 465, (1, CHUNK + 1, 32))
    with pytest.raises(ValueError, match="carries"):
        ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy)
    with pytest.raises(TypeError):
        ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy.to(torch.bfloat16),
                                  carries=ss_ops.carries_buffer(x, 4))
    with pytest.raises(ValueError):  # the step kernel writes no carries
        ss_ops.selective_scan(x[:, :4].contiguous(), dt[:, :4], A, Bm[:, :4], Cm[:, :4],
                              carries=ss_ops.carries_buffer(x[:, :4], 4))
    x3, dt3, A3, B3, C3 = _scan_args(dev, 1, 40, 32, 3, torch.float32, seed=470)
    before = (ss_ops.launches, ss_ops.bwd_launches)
    with pytest.raises(ValueError):  # n must be a power of two
        ss_ops.SelectiveScanFn.apply(x3.requires_grad_(), dt3, A3, B3, C3)
    assert (ss_ops.launches, ss_ops.bwd_launches) == before


def test_selective_scan_bwd_device_kernels(dev):
    """One backward call is three device kernels: the backward's own pack
    (its chunk image differs from the forward's), the backward and the
    reduction over its CTAs."""
    x, dt, A, Bm, Cm = _scan_args(dev, 1, 600, 3200, 16, torch.bfloat16, seed=480)
    carries = ss_ops.carries_buffer(x, 16)
    ss_ops.selective_scan(x, dt, A, Bm, Cm, carries=carries)
    dy = _rand(dev, 485, (1, 600, 3200))
    kern = _device_kernels(lambda: ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy,
                                                             carries=carries))
    assert kern == {"selective_scan_bwd_pack_kernel": 1.0, "selective_scan_bwd_kernel": 1.0,
                    "selective_scan_bwd_reduce_kernel": 1.0}, kern


def test_selective_scan_bwd_occupancy(dev):
    """The CTAs an SM the backward kernel is built for, as the CUDA
    occupancy calculator gives them: two at the 16-bit training shapes (n
    16: at most 128 registers a thread and ~112 KB of shared memory a CTA),
    and wherever its shared memory allows; one at n 32 and float32 n 16,
    whose chunk images and rows of sums take more."""
    got = {str(dt_).removeprefix("torch."): {n: ss_ops.bwd_ctas_per_sm(n, dt_)
                                              for n in (2, 4, 8, 16, 32)}
           for dt_ in (torch.bfloat16, torch.float16, torch.float32)}
    two = {2: 2, 4: 2, 8: 2, 16: 2, 32: 1}
    assert got == {"bfloat16": two, "float16": two,
                   "float32": {**two, 16: 1}}, got


@pytest.mark.parametrize("name", ["hymba-1.5b", "falcon-mamba-7b"])
def test_state_space_training_on_the_card_matches_the_cpu(dev, name):
    """make_value_and_grad on a reduced float32 state-space model on the
    card, through SelectiveScanFn (and FlashAttentionFn for hymba): the loss
    within 1e-5 and every gradient leaf within 1e-4 of its largest element
    of the CPU's plain path (float32 GEMMs, scans and attention summed in
    other orders); one forward and one backward scan a layer; remat True
    the same bits as none."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.models import transformer as PT
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(reduced_config(name), dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(490)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int32)}
    want_l, want_g = make_value_and_grad(cfg, remat=False)(params, batch)
    on_card = _to(params, dev)
    f0, b0 = ss_ops.launches_by_variant["chunked"], ss_ops.bwd_launches
    got_l, got_g = make_value_and_grad(cfg, remat=False)(on_card, batch)
    assert (ss_ops.launches_by_variant["chunked"] - f0,
            ss_ops.bwd_launches - b0) == (cfg.n_layers, cfg.n_layers)
    assert abs(got_l.item() - want_l.item()) <= 1e-5 * abs(want_l.item())
    for g, w in zip(tree_leaves(got_g), tree_leaves(want_g)):
        _close(g.cpu(), w, rel=1e-4)
    rl, rg = make_value_and_grad(cfg, remat=True)(on_card, batch)
    assert torch.equal(rl, got_l)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rg), tree_leaves(got_g)))


# -- decode_attention's logsumexp and the tensor-parallel attend ------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decode_attention_lse(dev, dtype, page, d, n_split):
    """return_lse at 1 to 8 splits (the merge writes it at every count): lse
    within 1e-5 of the plain version's (float32 sums of the same
    exponentials in another order), counted as stacked_lse, and out and mass
    the same bits as the call without it."""
    pps = 64 // page
    n_active = max(1, pps * n_split - pps // 2)  # a ragged last split where pages allow
    lens = [(n_active - 1) * page + 3, max(1, (n_active // 2) * page - 1)]
    q, kp, vp, tbl, ln = _decode_case(dev, dtype, 2, 28 if d < 256 else 8, 4, d, page,
                                      n_active + 2, [n_active, n_active], lens, seed=700)
    before = dict(da_ops.launches_by_variant)
    o, m, lse = da_ops.decode_attention(q, kp, vp, tbl, ln, return_lse=True)
    assert da_ops.launches_by_variant["stacked_lse"] == before["stacked_lse"] + 1
    assert da_ops.launches_by_variant["stacked"] == before["stacked"]
    _, _, want = decode_attention_ref(q, kp, vp, tbl, ln, return_lse=True)
    assert lse.shape == want.shape == q.shape[:2] and lse.dtype == torch.float32
    _close(lse, want)
    o2, m2 = da_ops.decode_attention(q, kp, vp, tbl, ln)
    assert torch.equal(o, o2) and torch.equal(m, m2)


def test_decode_attention_lse_of_a_row_with_nothing_to_attend(dev):
    """Row 1 has length 0: the kernel gives it out 0, mass 0 and lse -inf;
    row 0 is untouched by it (the same bits as alone)."""
    q, kp, vp, tbl, _ = _decode_case(dev, torch.bfloat16, 2, 28, 4, 128, 16, 12, [10, 10],
                                     [0, 0], seed=710)
    ln = torch.tensor([150, 0], dtype=torch.int32, device=dev)
    o, m, lse = da_ops.decode_attention(q, kp, vp, tbl, ln, return_lse=True)
    assert _all_zero(o[1]) and _all_zero(m[1]) and torch.isneginf(lse[1]).all()
    o0, m0, l0 = da_ops.decode_attention(q[:1], kp[:1], vp[:1], tbl[:1], ln[:1],
                                         return_lse=True)
    assert torch.equal(o[0], o0[0]) and torch.equal(m[0], m0[0]) and torch.equal(lse[0], l0[0])


def _tp_case(dev, dtype, page):
    """The dense decode shape (28 / 4 heads, d 128) over 69 slots a row, one
    of them a pad: row 0 over a shuffled pool of 70 pages, row 1 over 20
    pages that all lie in the pool's first eighth (one shard of 8 sees them),
    row 2 of length 0 (no shard sees anything)."""
    n_pages, width = 70, 69
    q = _rand(dev, 720, (3, 28, 128), dtype)
    kp, vp = (_rand(dev, 721 + i, (3, n_pages, page, 4, 128), dtype) for i in (0, 1))
    rng = np.random.default_rng(722)
    tbl = np.full((3, width), -1, np.int32)
    tbl[0, : width - 1] = rng.permutation(n_pages)[: width - 1]
    tbl[1, :5] = rng.permutation(8)[:5]
    tbl[2, :3] = [0, 40, 69]
    lens = [(width - 2) * page + 5, 4 * page + 1, 0]
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_paged_decode_on_the_card(dev, dtype, page, k):
    """The sharded attend over [cuda] x k against the unsharded kernel: one
    stacked_lse launch a shard and no plain version; float32 within 1e-5,
    bfloat16 out within 2^-7 of the largest (each shard's output and the
    combine's each round once), mass within 1e-5; at one shard the same bits.
    Rows that a shard cannot see, and the row no shard sees, come out as the
    unsharded kernel's (0 for the last)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.sharded_sparse import make_sharded_paged_decode

    args = _tp_case(dev, dtype, page)
    want_o, want_m = da_ops.decode_attention(*args)
    attend = make_sharded_paged_decode(make_serving_mesh(devices=[dev] * k))
    before = dict(da_ops.launches_by_variant)
    o, m = attend(*args)
    assert da_ops.launches_by_variant["stacked_lse"] - before["stacked_lse"] == k
    assert o.dtype == dtype and o.device == args[0].device
    if k == 1:
        assert torch.equal(o, want_o) and torch.equal(m, want_m)
    _close(o, want_o, rel=1e-5 if dtype == torch.float32 else 2.0 ** -7)
    _close(m, want_m)
    assert _all_zero(o[2]) and _all_zero(m[2]) and _all_zero(m[1, :, 5:])


def test_decode_step_batch_on_a_one_shard_mesh_is_bit_for_bit(dev):
    """RealCompute(tp_mesh=[cuda]).decode_step_batch, device and host pools,
    bit for bit the backend without a mesh (the pools form on the same
    pools), two steps; one stacked_lse launch a layer a step."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.core.backends import DeviceTailPool, RealCompute, TailPool
    from repro_torch.core.stepplan import DecodeBatchCtx
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(reduced_config("qwen2.5-7b", n_layers=2), dtype="bfloat16")
    params = _to(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), dev)
    rng = np.random.default_rng(730)
    data = [(7 * i + 1, 100 + i, [
        tuple(rng.standard_normal((n, 16, cfg.n_kv_heads, cfg.d_head)).astype(np.float16)
              for _ in range(2))
        + tuple(torch.from_numpy(rng.standard_normal((1, 10 + i, cfg.n_kv_heads, cfg.d_head))
                                 .astype(np.float32)).to(dev, torch.bfloat16) for _ in range(2))
        for _ in range(cfg.n_layers)]) for i, n in enumerate((3, 1, 2))]

    def run(pool_cls, mesh):
        be = RealCompute(cfg, params, device=dev, tp_mesh=mesh)
        ctxs = [DecodeBatchCtx(be, tok, pos, {
            l: pool_cls(kr, vr, (ks, vs), 16, 6, device=dev)
            for l, (kr, vr, ks, vs) in enumerate(layers)}) for tok, pos, layers in data]
        outs = []
        for _ in range(2):
            outs.append(be.decode_step_batch(ctxs))
            for c in ctxs:
                c.pos += 1
        return outs

    for pool_cls in (DeviceTailPool, TailPool):
        plain = run(pool_cls, None)
        before = da_ops.launches_by_variant["stacked_lse"]
        tp = run(pool_cls, make_serving_mesh(devices=[dev]))
        assert da_ops.launches_by_variant["stacked_lse"] - before == 2 * cfg.n_layers
        for step_p, step_t in zip(plain, tp):
            for (lp, mp), (lt, mt) in zip(step_p, step_t):
                np.testing.assert_array_equal(lp, lt)
                for l in mp:
                    np.testing.assert_array_equal(mp[l], mt[l])


# -- training over a mesh of the card ([cuda] x 4) ------------------------------
def _mesh_setup(dev, arch, data, model, **overrides):
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import NamedSharding, P, param_shardings, shard, shard_tree
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init

    cfg = dataclasses.replace(reduced_config(arch, **overrides), dtype="float32")
    params = _to(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), dev)
    mesh = make_host_mesh(data, model, devices=[dev] * (data * model))
    sh = param_shardings(cfg, mesh, fsdp=True)
    opt = adamw_init(params)
    on_mesh = (shard_tree(params, sh),
               {"m": shard_tree(opt["m"], sh), "v": shard_tree(opt["v"], sh),
                "step": shard(opt["step"], NamedSharding(mesh, P()))})
    rng = np.random.default_rng(300)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)}
    return cfg, params, mesh, on_mesh, batch


@pytest.mark.parametrize("arch,grid", [("qwen3-1.7b", (1, 4)), ("qwen3-1.7b", (2, 2)),
                                       ("qwen3-1.7b", (2, 1)), ("hymba-1.5b", (1, 2))])
def test_mesh_train_step_on_the_card(dev, arch, grid):
    """make_train_step(mesh=) on reduced float32 qwen3-1.7b over [cuda] x k,
    through both flash kernels, against the card's step without a mesh:
    grad_accum 2 on the mesh, the unsharded step over one microbatch a dp
    part (grad_accum 2 on 1 x 4 and 1 x 2, 4 elsewhere). With one tensor
    shard (2 x 1) bit for bit (parts weighed by an exact 1/2); over tensor
    shards (1 x 4: one q head a shard, each kv head computed by the two
    shards that read it; 2 x 2) the loss within 1e-6 and every block within
    1e-5 of its leaf's largest element, leaf by leaf, but for at most 1e-3
    of a params leaf within 2 lr (Adam's first step on a gradient near 0
    takes its sign), the limits ``tests/test_torch_mesh_train.py`` holds
    against JAX; flash launches one a layer, microbatch, dp part and tensor
    shard. hymba-1.5b at 5 q heads over one kv head on 1 x 2, held the
    same way: 3 / 2 heads a shard, the kv head read by both, half the
    mamba channels a shard through the scan's forward and backward, which
    launch as often as flash."""
    from repro_torch.launch.sharding import block_index, unshard
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import tree_leaves

    over = {"n_heads": 5, "n_kv_heads": 1} if arch == "hymba-1.5b" else {}
    cfg, params, mesh, (ps, opt), batch = _mesh_setup(dev, arch, *grid, **over)
    kw = dict(remat=False, lr=1e-3)
    want_p, want_o, want_m = make_train_step(cfg, grad_accum=2 * grid[0], **kw)(
        params, adamw_init(params), batch)
    f0, b0 = fa_ops.launches, fa_ops.bwd_launches
    s0, sb0 = ss_ops.launches, ss_ops.bwd_launches
    got_p, got_o, got_m = make_train_step(cfg, grad_accum=2, mesh=mesh, **kw)(ps, opt, batch)
    calls = 2 * grid[0] * grid[1] * cfg.n_layers
    assert (fa_ops.launches - f0, fa_ops.bwd_launches - b0) == (calls, calls)
    scans = calls if cfg.family == "hybrid" else 0
    assert (ss_ops.launches - s0, ss_ops.bwd_launches - sb0) == (scans, scans)
    exact = grid[1] == 1
    if exact:
        assert torch.equal(got_m["loss"], want_m["loss"])
    else:
        assert abs(got_m["loss"].item() - want_m["loss"].item()) <= 1e-6 * abs(
            want_m["loss"].item())
    for kind, got, want in (("params", got_p, want_p), ("m", got_o["m"], want_o["m"]),
                            ("v", got_o["v"], want_o["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            for pos in g.positions():
                blk, ref = g.block_at(pos), w[block_index(g.shape, g.sharding, pos)]
                assert blk.device.type == "cuda"
                if exact:
                    assert torch.equal(blk, ref)
            if exact:
                continue
            err = (unshard(g, dev) - w).abs()
            limit = 1e-5 * max(w.abs().max().item(), 1e-30)
            if kind == "params":
                assert err.max().item() <= 2 * kw["lr"]
                assert (err > limit + 1e-4 * kw["lr"]).float().mean().item() <= 1e-3
            else:
                assert err.max().item() <= limit


def test_mesh_split_keeps_moe_dispatch_on_the_card(dev, monkeypatch):
    """Reduced float32 mixtral-8x22b at capacity factor 0.5 on a 2 x 2 mesh
    of the card: each microbatch's two parts keep and drop exactly what the
    microbatch's dispatch over their routing, concatenated, does (bit for
    bit), some assignments drop, and the loss is within 1e-5 of the card's
    unsharded step's (its GEMMs over twice the rows may sum in other
    orders)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as PM
    from repro_torch.train.optimizer import adamw_init

    cfg, params, mesh, (ps, opt), batch = _mesh_setup(dev, "mixtral-8x22b", 2, 2,
                                                      moe_capacity_factor=0.5)
    _, _, want_m = make_train_step(cfg, grad_accum=2, remat=False, lr=1e-3)(
        params, adamw_init(params), batch)
    seen = []
    real = PM.dispatch

    def recording(top_idx, cap, n_experts, offset=None):
        out = real(top_idx, cap, n_experts, offset)
        seen.append((top_idx, cap, out[1]))
        return out

    monkeypatch.setattr(PM, "dispatch", recording)
    _, _, got_m = make_train_step(cfg, grad_accum=2, remat=False, lr=1e-3, mesh=mesh)(
        ps, opt, batch)
    L = cfg.n_layers
    assert len(seen) == 2 * 2 * L
    dropped = 0
    for i in range(2):
        for l in range(L):
            parts = [seen[(2 * i + j) * L + l] for j in range(2)]
            keep = torch.cat([p[2] for p in parts])
            whole = real(torch.cat([p[0] for p in parts]), parts[0][1], cfg.n_experts)[1]
            assert parts[0][1] == parts[1][1] and torch.equal(whole, keep)
            dropped += int((~keep).sum())
    assert dropped > 0
    assert abs(got_m["loss"].item() - want_m["loss"].item()) <= 1e-5 * abs(want_m["loss"].item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compressed_psum_on_the_card(dev, dtype):
    """compressed_psum over [cuda] x 4: every participant's sum the same
    bits, bit for bit the CPU's (the same elementwise float32 ops in the same
    order), within sum_i scale_i / 2 of the float32 sum."""
    from repro_torch.train.compression import compressed_psum

    xs = [_rand(dev, 310 + i, (300, 77)) * (10.0 ** (i - 1)) for i in range(4)]
    xs = [x.to(dtype) for x in xs]
    got = compressed_psum(xs)
    want = compressed_psum([x.cpu() for x in xs])
    assert all(g.device.type == "cuda" and g.dtype == dtype for g in got)
    assert all(torch.equal(got[0], g) for g in got[1:])
    assert torch.equal(got[0].cpu(), want[0])
    exact = sum(x.float() for x in xs)
    limit = sum(x.float().abs().max().item() / 127.0 for x in xs) / 2
    if dtype == torch.float32:
        assert (got[0] - exact).abs().max().item() <= limit * (1 + 1e-5)


def _train_counts(cfg, device, batch):
    """StepAnalyzer's count of one make_train_step(grad_accum=2) call on
    ``device`` ("cuda": the kernels launch; "meta": their meta routes): the
    aten products, each kernel's work and the launches by kernel and
    variant."""
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as PT
    from repro_torch.train.optimizer import adamw_init

    gen = torch.Generator(device=device).manual_seed(0) if device == "cuda" else None
    params = PT.init_params(cfg, gen, device=device)
    opt = adamw_init(params)
    batch = {k: v.to(device) if device == "cuda" else torch.empty_like(v, device="meta")
             for k, v in batch.items()}
    step = make_train_step(cfg, grad_accum=2, remat=False)
    with RL.StepAnalyzer() as a:
        step(params, opt, batch)
    if device == "cuda":
        torch.cuda.synchronize()
    return a.aten_flops, a.kernels, a.launches


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b"])
def test_meta_count_equals_the_live_count(dev, arch):
    """A small bfloat16 train step (grad_accum 2, 2 x 64 tokens) counted live
    on the card, its flash forward and backward (and hymba's scan forward
    and backward) launching, and on meta tensors, where the wrappers'
    meta routes launch nothing: the same aten products, the same work of
    each kernel (calls, products, bytes, exponentials) and the same
    launches by kernel and variant."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch, d_head=64)
    seq = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.as_tensor(seq[:, :-1]), "labels": torch.as_tensor(seq[:, 1:])}
    live, meta = _train_counts(cfg, "cuda", batch), _train_counts(cfg, "meta", batch)
    assert live == meta
    flash = {("flash_attention", "wgmma"): 2 * cfg.n_layers,
             ("flash_attention_bwd", "wgmma"): 2 * cfg.n_layers}
    scan = {("selective_scan", "chunked"): 2 * cfg.n_layers,
            ("selective_scan_bwd", "chunked"): 2 * cfg.n_layers} if arch == "hymba-1.5b" else {}
    assert live[2] == {**flash, **scan}
    assert live[0] > 0 and all(k["products"] > 0 for k in live[1].values())


def _serve_mesh_run(cfg, params, tokens, feed, mesh=None):
    """A prefill of ``tokens`` and a decode step on each of ``feed`` (greedy
    where ``feed`` is an int: that many steps): (logits of each call, the
    tokens fed, launches after the prefill and at the end)."""
    from repro_torch.launch.sharding import batch_specs, serve_state_shardings, shard
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    n = feed if isinstance(feed, int) else len(feed)
    state = T.init_serve_state(cfg, b, s + n, device=tokens.device)
    batch, put = {"tokens": tokens}, (lambda t: t)
    if mesh is not None:
        ssh = serve_state_shardings(cfg, mesh, b)
        state = {k: v if k == "length" else shard(v, ssh[k]) for k, v in state.items()}
        batch = {"tokens": shard(tokens, batch_specs(cfg, mesh, b, s, training=False)["tokens"])}
        tsh = decode_token_tree(cfg, mesh, b).sharding
        put = lambda t: shard(t, tsh)  # noqa: E731
    for mod in (fa_ops, ss_ops):
        mod.launches = 0
        mod.launches_by_variant = dict.fromkeys(mod.launches_by_variant, 0)
    logits, state = make_prefill_step(cfg, mesh=mesh)(params, batch, state)
    after_prefill = (fa_ops.launches, dict(ss_ops.launches_by_variant))
    outs, fed = [logits], []
    for i in range(n):
        tok = logits.argmax(-1).to(torch.int32) if isinstance(feed, int) else feed[i]
        fed.append(tok)
        logits, state = make_decode_step(cfg, mesh=mesh)(params, put(tok), state)
        outs.append(logits)
    return outs, fed, after_prefill, dict(ss_ops.launches_by_variant)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b"])
def test_mesh_serve_steps_on_the_card(dev, arch):
    """A reduced bfloat16 config (d_head 64; hymba at 5 / 5 heads, which do
    not divide 2: the ceil split and the fallback gathers) served over a
    1 x 2 mesh of the card, a prefill of 2 x 256 tokens and 4 decode steps
    teacher-forced on the unsharded step's greedy tokens: flash launches once
    a layer and shard in the prefill, hymba's scan once a layer and shard
    in the prefill (chunked) and in each decode step (sequential); the
    logits within chip_smoke.py's limit (SERVE_MESH_FLOOR_X = 2) of the
    unsharded step's: twice the unsharded step's own relative L2 from a
    float32 run of the same weights."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import param_shardings, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    over = dict(n_heads=5, n_kv_heads=5) if arch == "hymba-1.5b" else {}
    cfg = dataclasses.replace(reduced_config(arch, d_head=64, **over), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)),
                             dtype=torch.int32, device=dev)
    want, feed, _, _ = _serve_mesh_run(cfg, params, tokens, 4)
    f32, _, _, _ = _serve_mesh_run(dataclasses.replace(cfg, dtype="float32"),
                                   tree_map(lambda x: x.float(), params), tokens, feed)
    mesh = make_host_mesh(1, 2, devices=[dev] * 2)
    got, _, (fa_prefill, ss_prefill), ss_end = _serve_mesh_run(
        cfg, shard_tree(params, param_shardings(cfg, mesh, fsdp=True)), tokens, feed, mesh)
    assert fa_prefill == 2 * cfg.n_layers
    if arch == "hymba-1.5b":
        assert ss_prefill == {"chunked": 2 * cfg.n_layers, "sequential": 0}
        assert ss_end == {"chunked": 2 * cfg.n_layers, "sequential": 2 * cfg.n_layers * 4}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    floor = max(rel(w, f) for w, f in zip(want, f32))
    worst = max(rel(g, w) for g, w in zip(got, want))
    assert 0 < floor and worst <= 2.0 * floor, (worst, floor)


@pytest.mark.parametrize("cached", [False, True], ids=["kmeans", "summaries"])
def test_mesh_sparse_step_on_the_card(dev, monkeypatch, cached):
    """A reduced float32 qwen3-1.7b (d_head 64) prefilled with 2 x 256
    tokens over a 2 x 2 mesh of the card (``[cuda:0] * 4``: the cache's
    sequence over the data axis, its kv heads over the model axis), then 4
    ContiguousKV sparse decode steps (chunks of 16, budget 0.25) teacher-
    forced on the unsharded sparse step's greedy tokens: flash launches once
    a layer and tensor shard in the prefill and never in the steps; the
    logits within 1e-5 of the unsharded step's largest and every (step,
    layer, row) pick the unsharded step's (float32: the two differ only by
    the order of the float32 sums)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps as PS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (NamedSharding, batch_specs, param_shardings,
                                             serve_state_shardings, shard, shard_tree, unshard)
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b", d_head=64), dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b, s, n, c, cap = 2, 256, 4, 16, 288  # 260 positions rounded up to 2 blocks x 16
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32, device=dev)
    picks, real = [], PS.top_chunks
    monkeypatch.setattr(PS, "top_chunks", lambda x, k: picks.append(real(x, k)) or picks[-1])

    def run(mesh, feed):
        state = T.init_serve_state(cfg, b, cap, device=dev)
        batch, put, ps = {"tokens": tokens}, (lambda t: t), params
        if mesh is not None:
            ssh = serve_state_shardings(cfg, mesh, b)
            state = {k: v if k == "length" else shard(v, ssh[k]) for k, v in state.items()}
            batch = {"tokens": shard(tokens,
                                     batch_specs(cfg, mesh, b, s, training=False)["tokens"])}
            put = lambda t: shard(t, decode_token_tree(cfg, mesh, b).sharding)  # noqa: E731
            ps = shard_tree(params, param_shardings(cfg, mesh, fsdp=True))
        fa_ops.launches = 0
        logits, state = PS.make_prefill_step(cfg, mesh=mesh)(ps, batch, state)
        prefill_launches = fa_ops.launches
        if cached:
            k = state["k"] if mesh is None else unshard(state["k"], dev)
            km = k.reshape(cfg.n_layers, b, cap // c, c, cfg.n_kv_heads, cfg.d_head).mean(dim=3)
            state["kmean"] = km if mesh is None else shard(km, NamedSharding(mesh, ssh["k"].spec))
        step = PS.make_sparse_decode_step(cfg, chunk_tokens=c, budget=0.25,
                                          cached_summaries=cached, mesh=mesh)
        outs, fed = [], []
        for i in range(n):
            tok = logits.argmax(-1).to(torch.int32) if feed is None else feed[i]
            fed.append(tok)
            logits, state = step(ps, put(tok), state)
            outs.append(logits)
        assert fa_ops.launches == prefill_launches
        return outs, fed, prefill_launches

    want, feed, _ = run(None, None)
    want_picks = picks[:]
    picks.clear()
    got, _, launches = run(make_host_mesh(2, 2, devices=[dev] * 4), feed)
    assert launches == 2 * cfg.n_layers
    assert len(picks) == len(want_picks) == n * cfg.n_layers
    assert all(torch.equal(g, w) for g, w in zip(picks, want_picks))
    for g, w in zip(got, want):
        _close(g, w)


# -- four distinct cards ----------------------------------------------------------
@pytest.fixture
def four(dev):
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four CUDA cards, {n} present")
    return [torch.device("cuda", i) for i in range(4)]


FAR_KERNELS = ["chunk_score", "chunk_attention", "chunk_attention_indexed", "decode_attention",
               "decode_attention_pools", "flash_attention", "flash_attention_bwd",
               "selective_scan", "selective_scan_bwd"]


def _far_case(name, d3):
    """(the wrapper's call, its plain version's, the relative limit) on
    tensors of ``d3``, at this file's shapes and limits."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_pools_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    bf = torch.bfloat16
    if name == "chunk_score":
        q, k = _rand(d3, 0, (20, 8, 32)), _rand(d3, 1, (100, 2, 32), torch.float16)
        return lambda: cs_ops.chunk_score(q, k, 16), lambda: chunk_score_ref(q, k, 16), 1e-5
    if name == "chunk_attention":
        q = _rand(d3, 0, (20, 8, 32))
        ks, vs = (_rand(d3, i, (8, 16, 2, 32), torch.float16) for i in (1, 2))
        kf, vf = (_rand(d3, i, (20, 2, 32)) for i in (3, 4))
        return (lambda: ca_ops.chunk_attention(q, ks, vs, 5, kf, vf),
                lambda: chunk_attention_ref(q, ks, vs, 5, kf, vf), 1e-5)
    if name == "chunk_attention_indexed":
        q, kp, vp, idx, kf, vf = _indexed_case(d3, 80, 2, 40, 28, 4, 96, 16, 128, 24,
                                               torch.float32)
        nv = torch.tensor([24, 9], dtype=torch.int32, device=d3)
        return (lambda: ca_ops.chunk_attention_indexed(q, kp, vp, idx, nv, kf, vf),
                lambda: chunk_attention_indexed_ref(q, kp, vp, idx, nv, kf, vf), 1e-5)
    if name == "decode_attention":
        q = _rand(d3, 0, (2, 8, 32), bf)
        kp, vp = (_rand(d3, i, (2, 9, 16, 2, 32), bf) for i in (1, 2))
        tbl = torch.tensor([[0, 1, 2, 3, 4, 5, 6], [3, 1, 0, 2, -1, -1, -1]], dtype=torch.int32,
                           device=d3)
        lens = torch.tensor([6 * 16 + 5, 3 * 16 + 9], dtype=torch.int32, device=d3)
        return (lambda: da_ops.decode_attention(q, kp, vp, tbl, lens),
                lambda: decode_attention_ref(q, kp, vp, tbl, lens), 2.0 ** -7)
    if name == "decode_attention_pools":
        q, ks, vs, tbl, lens = _pools_case(d3, bf, 16, [70, 63, 56], [70, 62, 56], seed=73)
        return (lambda: da_ops.decode_attention_pools(q, ks, vs, tbl, lens),
                lambda: decode_attention_pools_ref(q, ks, vs, tbl, lens), 2.0 ** -7)
    if name == "flash_attention":
        q, k, v, _ = _bwd_inputs(d3, bf, 2, 8, 2, 130, 130, 128, True)
        return (lambda: fa_ops.flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
                FLASH_REL[bf])
    if name == "flash_attention_bwd":
        q, k, v, do = _bwd_inputs(d3, bf, 2, 8, 2, 130, 130, 128, True)
        out, lse = _forward_for_bwd(q, k, v)
        return (lambda: fa_ops.flash_attention_bwd(q, k, v, out, do, lse=lse),
                lambda: flash_attention_bwd_ref(q, k, v, out, do), FLASH_REL[bf])
    x, dt, A, Bm, Cm = _scan_args(d3, 2, 300, 48, 16, torch.float32, seed=400)
    carries = ss_ops.carries_buffer(x, 16)
    if name == "selective_scan":
        return (lambda: ss_ops.selective_scan(x, dt, A, Bm, Cm, carries=carries),
                lambda: selective_scan_ref(x, dt, A, Bm, Cm), 1e-5)
    dy = _rand(d3, 407, (2, 300, 48))
    ss_ops.selective_scan(x, dt, A, Bm, Cm, carries=carries)
    return (lambda: ss_ops.selective_scan_bwd(x, dt, A, Bm, Cm, None, dy, carries=carries),
            lambda: selective_scan_bwd_ref(x, dt, A, Bm, Cm, None, dy), 1e-5)


@pytest.mark.parametrize("name", FAR_KERNELS)
def test_kernel_on_another_card_than_the_current(four, name):
    """Each wrapper's CUDA route called on tensors of cuda:3 while cuda:0 is
    current launches under cuda:3 (``build.on_own_device``): its plain
    version's results within this file's limits, one launch counted, and
    cuda:0 still current after the call."""
    d3 = four[3]
    with torch.cuda.device(four[0]):
        call, plain, rel = _far_case(name, d3)
        mod = {"chunk_score": cs_ops, "chunk_attention": ca_ops, "decode_attention": da_ops,
               "flash_attention": fa_ops, "selective_scan": ss_ops}[
                   name.removesuffix("_bwd").removesuffix("_indexed").removesuffix("_pools")]
        bwd = name.endswith("_bwd")
        before = mod.bwd_launches if bwd else mod.launches
        got = call()
        torch.cuda.synchronize(d3)
        assert torch.cuda.current_device() == 0
        assert (mod.bwd_launches if bwd else mod.launches) == before + 1
        want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if g is None:
            continue
        assert g.device == d3
        _close(g, w, rel=rel)


def _four_card_serve(four, cfg, tokens, data, model, n):
    """The mesh prefill and ``n`` greedy decode steps over cards 0-3, then
    over [cuda:0] x 4 teacher-forced on the first run's tokens, params laid
    out by the laid-out init: [(logits of each call, tokens fed)] x 2."""
    from repro_torch.launch.mesh import make_host_mesh, synchronize
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.models import transformer as T

    runs = []
    for devices in (four, [four[0]] * 4):
        mesh = make_host_mesh(data, model, devices=devices)
        ps = T.init_params(cfg, torch.Generator(device=four[0]).manual_seed(0), four[0],
                           shardings=param_shardings(cfg, mesh, fsdp=True))
        logits, fed, _, _ = _serve_mesh_run(cfg, ps, tokens, runs[0][1] if runs else n, mesh)
        synchronize(mesh)
        runs.append((logits, fed))
    return runs


@pytest.mark.parametrize("arch,grid", [("qwen3-1.7b", (2, 2)), ("qwen3-1.7b", (1, 4)),
                                       ("hymba-1.5b", (1, 4))])
def test_mesh_serve_steps_on_four_cards(four, arch, grid):
    """The mesh serve steps on a reduced bfloat16 config over cards 0-3 are
    bit for bit the same steps over [cuda:0] x 4: the same kernels and
    products on the same shapes in the same order, only the blocks'
    devices differ."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = dataclasses.replace(reduced_config(arch, d_head=64), dtype="bfloat16")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256)),
                             dtype=torch.int32, device=four[0])
    (far, _), (near, _) = _four_card_serve(four, cfg, tokens, *grid, 4)
    for g, w in zip(far, near):
        assert g.device == four[0] and torch.equal(g, w)


@pytest.mark.parametrize("cached", [False, True], ids=["kmeans", "summaries"])
def test_mesh_sparse_step_on_four_cards(four, cached):
    """ContiguousKV's sparse decode over a 2 x 2 mesh of cards 0-3 (reduced
    bfloat16 qwen3-1.7b, 2 x 256 prompt tokens, 4 greedy steps, chunks of
    16, budget 0.25) is bit for bit the same over [cuda:0] x 4: logits,
    picks and every cache block."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps as PS
    from repro_torch.launch.mesh import make_host_mesh, synchronize
    from repro_torch.launch.sharding import (NamedSharding, batch_specs, param_shardings,
                                             serve_state_shardings, shard, unshard)
    from repro_torch.launch.specs import decode_token_tree
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduced_config("qwen3-1.7b", d_head=64), dtype="bfloat16")
    b, s, c, cap = 2, 256, 16, 288
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32, device=four[0])
    runs = []
    for devices in (four, [four[0]] * 4):
        mesh = make_host_mesh(2, 2, devices=devices)
        ps = T.init_params(cfg, torch.Generator(device=four[0]).manual_seed(0), four[0],
                           shardings=param_shardings(cfg, mesh, fsdp=True))
        ssh = serve_state_shardings(cfg, mesh, b)
        state = {k: v if k == "length" else shard(v, ssh[k])
                 for k, v in T.init_serve_state(cfg, b, cap, device=four[0]).items()}
        batch = {"tokens": shard(tokens, batch_specs(cfg, mesh, b, s, training=False)["tokens"])}
        logits, state = PS.make_prefill_step(cfg, mesh=mesh)(ps, batch, state)
        if cached:
            k = unshard(state["k"], four[0])
            km = k.reshape(cfg.n_layers, b, cap // c, c, cfg.n_kv_heads, cfg.d_head).mean(dim=3)
            state["kmean"] = shard(km, NamedSharding(mesh, ssh["k"].spec))
        step = PS.make_sparse_decode_step(cfg, chunk_tokens=c, budget=0.25,
                                          cached_summaries=cached, mesh=mesh)
        outs = []
        for _ in range(4):
            tok = shard(logits.argmax(-1).to(torch.int32), decode_token_tree(cfg, mesh, b).sharding)
            logits, state = step(ps, tok, state)
            outs.append(logits)
        synchronize(mesh)
        runs.append((outs, {k: unshard(v, four[0]) for k, v in state.items() if k != "length"}))
    (far, far_state), (near, near_state) = runs
    assert all(torch.equal(g, w) for g, w in zip(far, near))
    assert all(torch.equal(far_state[k], near_state[k]) for k in near_state)


def test_mesh_train_step_on_four_cards(four):
    """make_train_step(mesh=) on reduced float32 qwen3-1.7b over a 2 x 2 mesh
    of cards 0-3, 2 steps at grad_accum 2, is bit for bit the same step over
    [cuda:0] x 4: params, moments and loss, block by block on the blocks'
    own cards."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import NamedSharding, P, param_shardings, shard, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.tree import tree_leaves

    cfg, params, _, _, batch = _mesh_setup(four[0], "qwen3-1.7b", 2, 2)
    runs = []
    for devices in (four, [four[0]] * 4):
        mesh = make_host_mesh(2, 2, devices=devices)
        sh = param_shardings(cfg, mesh, fsdp=True)
        opt = adamw_init(params)
        ps = shard_tree(params, sh)
        os_ = {"m": shard_tree(opt["m"], sh), "v": shard_tree(opt["v"], sh),
               "step": shard(opt["step"], NamedSharding(mesh, P()))}
        step = make_train_step(cfg, grad_accum=2, mesh=mesh, remat=False, lr=1e-3)
        for _ in range(2):
            ps, os_, metrics = step(ps, os_, batch)
        runs.append((ps, os_, metrics["loss"].to(four[0])))
    (fp, fo, fl), (np_, no, nl) = runs
    assert torch.equal(fl, nl)
    for got, want in ((fp, np_), (fo["m"], no["m"]), (fo["v"], no["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            for pos in g.positions():
                assert g.block_at(pos).device == four[pos[0] * 2 + pos[1]]
                assert torch.equal(g.block_at(pos).to(four[0]), w.block_at(pos))
