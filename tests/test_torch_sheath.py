"""The port's MSheath against the JAX MSheath (its XLA scan), and the
port's plain scan against the Pallas ``fused_sheath_scan`` (interpret
mode) at the shapes of tests/test_pallas.py.  Outputs in f32 at rtol
1e-5 (the scan's straight-through forms add one rounding on the JAX
side, hence atol 1e-5); jump actions and jstat counters exactly.  bf16
storage (f32 inside on both sides) to one bf16 rounding: 2e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.models.sheath import MSheath as JMSheath
from asr_model_tpu.ops.pallas.sheath_kernel import fused_sheath_scan

from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.ops.cuda import sheath as ksheath
from asr_model_tpu_torch.weights import from_jax_params

B, T, D, L = 2, 6, 128, 4
VALID = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool)


@pytest.fixture(scope="module")
def pair():
    x = np.random.RandomState(0).randn(B, T, D).astype(np.float32)
    jm = JMSheath(dims=D, head=2, layer=L)
    params = jm.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"]
    tm = MSheath(D, 2, L, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_msheath_matches_jax(pair, use_valid, scale):
    """Two input scales steer the jump policy down different paths."""
    jm, params, tm, x = pair
    x = x * scale
    valid = VALID if use_valid else None
    want, aux_w = jm.apply({"params": params}, jnp.asarray(x),
                           None if valid is None else jnp.asarray(valid))
    got, aux_g = tm(torch.from_numpy(x),
                    None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(aux_g["actions"].numpy(),
                                  np.asarray(aux_w["actions"]))
    np.testing.assert_array_equal(aux_g["jstat"].numpy(),
                                  np.asarray(aux_w["jstat"]))


def _pallas_inputs(params, x, valid):
    """The operands MSheath._fused_scan builds for the Pallas kernel."""
    b, ctx, d = x.shape
    f32 = jnp.float32
    m = jnp.ones((b, ctx), f32) if valid is None else jnp.asarray(valid, f32)
    n_b = jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1.0)
    eye = jnp.eye(b, dtype=f32)
    pool_w = (eye[:, :, None] * (m / n_b)[None]).reshape(b, b * ctx)
    bcast = jnp.repeat(eye, ctx, axis=0)
    pot_w = (m / jnp.maximum(jnp.sum(m), 1.0)).reshape(1, b * ctx)
    p = params
    w = {"ln_scale": p["ln_scale"], "ln_bias": p["ln_bias"],
         "gate_w": p["gate_w"][..., 0], "gate_b": p["gate_b"],
         "mkey": p["mkey"], "mval": p["mval"][..., 0],
         "vmlp1_w": p["vmlp1_w"], "vmlp1_b": p["vmlp1_b"],
         "vmlp2_w": p["vmlp2_w"][..., 0], "vmlp2_b": p["vmlp2_b"],
         "vcat_w": p["vcat_w"][..., 0], "vcat_b": p["vcat_b"],
         "adapt_w": p["adapt_w"], "adapt_b": p["adapt_b"],
         "memgate_w": p["memgate_w"].reshape(1, d),
         "memgate_b": p["memgate_b"].reshape(1, 1)}
    w = {k: jnp.asarray(v, f32) for k, v in w.items()}
    return pool_w, bcast, pot_w, jnp.asarray(p["mem_w"]).reshape(1, d), w


@pytest.mark.parametrize("use_valid,dtype,sampled",
                         [(False, "float32", 2), (True, "float32", 1),
                          (False, "bfloat16", 0)])
def test_plain_scan_matches_pallas_kernel(pair, use_valid, dtype, sampled):
    jm, params, tm, x = pair
    valid = VALID if use_valid else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x2 = x.reshape(B * T, D)
    pool_w, bcast, pot_w, mem0, w = _pallas_inputs(params, x, valid)
    jump_s = np.asarray(params["jump_s"], np.float32)
    want, act_w, js_w = fused_sheath_scan(
        jnp.asarray(x2, jdt), pool_w, bcast, pot_w, mem0,
        jnp.asarray(sampled, jnp.int32), jnp.asarray(jump_s), w, L=L,
        thresh=0.3, interpret=True)
    tw = tm.scan_weights()
    got, act_g, js_g = ksheath.sheath_scan_plain(
        torch.from_numpy(x2).to(tdt), B,
        None if valid is None else torch.from_numpy(valid), tw["mem0"],
        torch.tensor(sampled, dtype=torch.int32), tw["jump_s"],
        {k: tw[k] for k in ksheath.WEIGHT_NAMES}, L, 0.3)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(act_g.numpy(), np.asarray(act_w))
    np.testing.assert_array_equal(js_g.numpy(), np.asarray(js_w))
