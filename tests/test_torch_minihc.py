"""MSheath's mini-HC (r_node, "ranvier") paths against the JAX package's
``MSheath(mini_hc=True)`` on every route: the eval scan (which never
takes the scan kernel: the JAX gate excludes mini-HC), the streaming
scan and its one-position ``stream_step``, and the train scan (forward
and gradients, with and without the slot checkpoints of remat).  The
model's ``ModelConfig.msheath_mini_hc`` is inert in the JAX package (its
``Residual`` builds ``MSheath(d, head, layer)``) and so in the port: the
two build the same leaves.

Tiny dims (16 wide, 3 slots so that both slot parities and a jump run),
float32.  Outputs within rtol 1e-5 / atol 1e-5 of the largest value (f32
sums in other orders), the jump actions and counters exactly, gradients
within rtol 1e-4 / atol 1e-6 of the largest gradient; noise-free train
routes (JAX's gumbel draws zero, the port's generator None).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JModelConfig
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.models.sheath import MSheath as JMSheath

from asr_model_tpu_torch.config import Dimensions, ModelConfig
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.weights import from_jax_params, to_jax_params

D, L, B, T = 16, 3, 2, 7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sheath():
    x = np.random.RandomState(0).randn(B, T, D).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, -2:] = False
    jm = JMSheath(D, 2, L, mini_hc=True)
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x))[
        "params"])
    # the v_gate's mask off on slot 0 (a forced skip: slot 0 jumps to
    # slot 2) and on on slot 2, so a jump and the r_node paths both run
    params["vcat_b"] = params["vcat_b"] + np.array([[-3.0], [0.0], [3.0]],
                                                   np.float32)
    tm = MSheath(D, 2, L, mini_hc=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm, x, valid


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("streaming", [False, True])
def test_eval_scan_matches_jax(sheath, streaming):
    jm, params, tm, x, valid = sheath
    v = jnp.asarray(valid)
    (jy, jaux) = jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, valid=v, streaming=streaming))(params,
                                                         jnp.asarray(x))
    kernels.reset_counts()
    y, aux = tm(torch.from_numpy(x), valid=torch.from_numpy(valid),
                streaming=streaming)
    assert kernels.counts()["fused_sheath_scan"]["plain_calls"] == 0
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(aux["actions"].numpy(),
                                  np.asarray(jaux["actions"]))
    np.testing.assert_array_equal(aux["jstat"].numpy(),
                                  np.asarray(jaux["jstat"]))
    assert int(aux["actions"][0]) > 0        # slot 0 jumps


def test_stream_step_matches_jax(sheath):
    jm, params, tm, x, _ = sheath
    jstep = jax.jit(lambda p, xt, s: jm.apply(
        {"params": p}, xt, s, method=JMSheath.stream_step))
    js = jm.apply({"params": params}, B, method=JMSheath.init_stream_state)
    st = tm.init_stream_state(B, "cpu")
    for t in range(T):
        jy, js = jstep(params, jnp.asarray(x[:, t:t + 1]), js)
        y, st = tm.stream_step(torch.from_numpy(x[:, t:t + 1]), st)
        _close(y.numpy(), jy)


@pytest.mark.parametrize("remat", [False, True])
def test_train_scan_and_gradients_match_jax(sheath, monkeypatch, remat):
    jm, params, tm, x, valid = sheath
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    w = np.random.RandomState(1).randn(B, T, D).astype(np.float32)
    v = jnp.asarray(valid)

    def loss(p, x):
        y, aux = jm.apply({"params": p}, x, valid=v,
                          rngs={"gumbel": jax.random.key(1)})
        return jnp.sum(y * w), aux

    (jl, jaux), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tm.requires_grad_(True)
    for p in tm.parameters():
        p.grad = None
    xt = torch.from_numpy(x).requires_grad_(True)
    with stochastic.mode(train=True), stochastic.remat(remat):
        y, aux = tm(xt, valid=torch.from_numpy(valid))
        out = (y * torch.from_numpy(w)).sum()
        out.backward()
    tm.requires_grad_(False)
    assert abs(float(out) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_array_equal(aux["actions"].numpy(),
                                  np.asarray(jaux["actions"]))
    want = from_jax_params(jax.device_get(gp))
    grads = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for n, p in tm.named_parameters()}
    top = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for n, g in grads.items():
        np.testing.assert_allclose(g, want[n].numpy(), rtol=1e-4,
                                   atol=1e-6 * top, err_msg=n)
    for n in ("par_w", "par_b", "rnet_w", "rnet_b"):
        assert np.abs(grads[n]).max() > 0, n
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-6 * top)


# ------------------------------------------------ the model's field

KW = dict(tokens=50, mels=8, dims=16, head=2, layer=2)


def _tree(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), tuple(v.shape)


def test_model_config_field_is_inert_as_in_jax():
    """The JAX package's ``ModelConfig.msheath_mini_hc`` reaches no
    module (its ``Residual`` builds ``MSheath(d, head, layer)``): a JAX
    model with the field set has no r_node leaves.  The port's model of
    that config has the same leaves at the same shapes, so the JAX
    checkpoint of such a config loads strictly."""
    rs = np.random.RandomState(3)
    feats = dict(spectrogram=jnp.asarray(rs.randn(B, 8, 20), jnp.float32),
                 pitch=jnp.asarray(rs.rand(B, 1, 20) * 2, jnp.float32))
    jm = JModel(param=JDims(**KW), cfg=JModelConfig(
        dims=JDims(**KW), msheath_mini_hc=True))
    want = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.ones((B, 4), jnp.int32), **feats))
    m = Model(Dimensions(**KW), ModelConfig(msheath_mini_hc=True),
              device="cpu")
    params, stats = to_jax_params(m)
    for got, tree in ((params, want["params"]),
                      (stats, want["batch_stats"])):
        assert dict(_tree(got)) == dict(_tree(tree))
    assert not any("par_w" in k for k, _ in _tree(params))
    assert all(not b.jump.mini_hc for b in
               (getattr(m.processor, n) for n in m.processor.names))
