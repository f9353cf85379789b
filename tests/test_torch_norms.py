"""The port's AbbyNormal (its kernel's plain version on the CPU) against
the JAX AbbyNormal (XLA route) and the Pallas ``fused_abby`` kernel
(interpret mode).  f32: rtol 1e-5.  bf16 (storage only, both f32
inside): one bf16 rounding of the output, rtol = atol = 1e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.models.norms import AbbyNormal as JAbby
from asr_model_tpu.ops.pallas.abby_kernel import fused_abby as pallas_abby

from asr_model_tpu_torch.models.norms import AbbyNormal
from asr_model_tpu_torch.ops.cuda import abby as kabby
from asr_model_tpu_torch.weights import from_jax_params

SHAPES = {128: (2, 6, 128), 256: (2, 4, 5, 256)}


@pytest.fixture(scope="module", params=[128, 256])
def case(request):
    """(D, x, flax params, port module) with the same weights."""
    d = request.param
    x = np.random.RandomState(d).randn(*SHAPES[d]).astype(np.float32) * 2.0
    jm = JAbby(dims=d)
    params = jax.device_get(jm.init({"params": jax.random.key(0)},
                                    jnp.asarray(x))["params"])
    tm = AbbyNormal(d, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return d, x, jm, params, tm


def test_abby_matches_jax_module(case):
    d, x, jm, params, tm = case
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _pallas_args(params, dt):
    p = params
    return (jnp.asarray(p["router_in"]["kernel"], dt),
            jnp.asarray(p["router_in"]["bias"], dt),
            jnp.asarray(p["router_out"]["kernel"], dt),
            jnp.asarray(p["router_out"]["bias"], dt))


def _plain_args(tm, dt):
    return (tm.router_in.weight.to(dt), tm.router_in.bias.to(dt),
            tm.router_out.weight.to(dt), tm.router_out.bias.to(dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abby_plain_matches_pallas_kernel(case, dtype):
    d, x, jm, params, tm = case
    x2 = x.reshape(-1, d)
    size = kabby.window_size(d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = pallas_abby(jnp.asarray(x2, jdt), *_pallas_args(params, jdt),
                       size=size, alpha=1e-4, k=1.0, beta=0.75,
                       interpret=True)
    got = kabby.abby_plain(torch.from_numpy(x2).to(tdt),
                           *_plain_args(tm, tdt), size, 1e-4, 1.0, 0.75)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_abby_window_sizes():
    """The flagship widths: 512 channels -> 25, a 128-wide head -> 7."""
    assert kabby.window_size(512) == 25
    assert kabby.window_size(128) == 7
    assert kabby.window_size(64) == 3
