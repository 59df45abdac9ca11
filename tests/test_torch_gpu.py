"""The port's CUDA kernels against their plain versions, on the card.

Imports neither jax nor repro, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips. Tolerances: the kernels and the plain
versions compute in float32 and sum in other orders (1e-5 relative);
bfloat16 outputs are each one float32 result rounded once (one ulp).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention.ref import chunk_attention_ref
from repro_torch.kernels.chunk_score import ops as cs_ops
from repro_torch.kernels.chunk_score.ref import chunk_score_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

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
