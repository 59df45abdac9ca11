"""Every config of the registry through the port's model against the JAX
package's, on the CPU (the port's half of tests/test_models_smoke.py and
tests/test_zoo.py; the sim step plan of every config is held event for
event in tests/test_torch_sim.py).

Each reduced config runs on the JAX package's weights
(``bridge.params_from_numpy``), with non-zero norm scales and biases so that
they count: ``forward`` over b = 2 rows of 24 positions, then ``prefill`` of
the first 24 and a ``decode_step`` on the next, tokens or, for the two
frontend families, shared frame / patch embeddings made with numpy.
float32: logits within 1e-4 of the largest and the same greedy tokens (the
frameworks sum in other orders; the state-space families' decode runs the
scan's plain version against JAX's inline recurrence). bfloat16: within
2e-2 of the largest (XLA fuses elementwise ops that torch rounds one by
one; the logits are bfloat16 products, so 2e-2 is about 2.5 ulps of the
largest), 5e-2 for the hybrid family, whose attention and mamba branches
round separately before their bfloat16 mean (the bound
tests/test_torch_ssm.py holds hymba's bfloat16 forward to; it measures
0.021 / 0.014 / 0.025 of the largest here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config, list_configs, reduced_config
from repro_torch.models import transformer as PT
from repro_torch.models.frontends import make_frontend_embeds

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": 1e-4, "bfloat16": 2e-2, "bfloat16-hybrid": 5e-2}
B, S = 2, 24


def _models(name, dtype):
    cfg = dataclasses.replace(jax_reduced_config(name), dtype=dtype)
    pcfg = dataclasses.replace(reduced_config(name), dtype=dtype)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    layers = params["layers"]
    for key in ("bq", "bk", "bv", "attn_norm", "ffn_norm", "q_norm", "k_norm"):
        if key in layers:
            layers[key] = jnp.asarray(0.1 * rng.standard_normal(layers[key].shape),
                                      layers[key].dtype)
    tparams = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def _inputs(cfg, seed):
    """(JAX batch, port batch, JAX decode input, port decode input)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        e = (cfg.d_model ** -0.5 * rng.standard_normal((B, S + 1, cfg.d_model))).astype(
            np.float32)
        je = jnp.asarray(e).astype(cfg.activation_dtype())
        te = bridge.tensor_from_numpy(np.asarray(je), "cpu")
        return ({"embeds": je[:, :S]}, {"embeds": te[:, :S]}, {"embeds": je},
                {"embeds": te}, je[:, S:], te[:, S:])
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    return ({"tokens": jt[:, :S]}, {"tokens": tt[:, :S]}, {"tokens": jt}, {"tokens": tt},
            jt[:, S:], tt[:, S:])


def _close(got, want, dtype, family):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = TOL.get(f"{dtype}-{family}", TOL[dtype])
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(jax_list_configs()))
def test_forward_prefill_decode_match_jax(name, dtype):
    cfg, pcfg, params, tparams = _models(name, dtype)
    jb, tb, jfull, tfull, jnext, tnext = _inputs(cfg, 2)
    fam = cfg.family
    _close(PT.forward(tparams, tfull, pcfg, block_q=8),
           JT.forward(params, jfull, cfg, block_q=8), dtype, fam)
    jstate = JT.init_serve_state(cfg, B, S + 4)
    tstate = PT.init_serve_state(pcfg, B, S + 4, device="cpu")
    jl, jstate = JT.prefill(params, jb, cfg, jstate, block_q=8)
    tl, tstate = PT.prefill(tparams, tb, pcfg, tstate, block_q=8)
    _close(tl, jl, dtype, fam)
    jd, _ = JT.decode_step(params, jnext, cfg, jstate)
    td, tstate = PT.decode_step(tparams, tnext, pcfg, tstate)
    _close(td, jd, dtype, fam)
    assert tstate["length"] == S + 1


@pytest.mark.parametrize("name", [n for n in list_configs() if get_config(n).frontend])
def test_frontend_embeds(name):
    """make_frontend_embeds: (b, s, d_model) in the model dtype at the JAX
    package's scale; prefill + decode_step on them agree with forward."""
    cfg = reduced_config(name)
    g = torch.Generator().manual_seed(0)
    e = make_frontend_embeds(cfg, 2, S + 1, g, device="cpu")
    assert e.shape == (2, S + 1, cfg.d_model) and e.dtype == cfg.activation_dtype()
    assert abs(float(e.float().std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    pcfg = dataclasses.replace(cfg, dtype="float32")
    params = PT.init_params(pcfg, torch.Generator().manual_seed(1), device="cpu")
    e = e.float()
    full = PT.forward(params, {"embeds": e}, pcfg, block_q=8)
    state = PT.init_serve_state(pcfg, 2, S + 4, device="cpu")
    _, state = PT.prefill(params, {"embeds": e[:, :S]}, pcfg, state, block_q=8)
    dec, _ = PT.decode_step(params, e[:, S:], pcfg, state)
    torch.testing.assert_close(dec[:, 0], full[:, S], rtol=0, atol=1e-4 * full.abs().max())
