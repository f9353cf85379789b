"""The port's ``MoEMLP`` against the JAX package's
(``asr_model_tpu/models/moe.py``), and the train step of a chained MoE
model (with the encoder's ``norm`` and ``enc`` options) against the JAX
package's loss with its MoE aux, with and without remat.

MoEMLP, float32: outputs within rtol 1e-5 / atol 1e-6 (the combine sums
the k kept slots in another order), the aux within rtol 1e-6, the
gradients of a scalar of the output with respect to x and every
parameter within rtol 1e-5 / atol 1e-6; the routing itself (expert ids,
slots, drops) exactly, at a capacity that drops nothing, one that drops,
and on a router that ties every expert (``jax.lax.top_k`` keeps the
lower indices).

The train step, noise-free (JAX's gumbel draws zero, dropout 0, the
port's generator None), against JAX's step in float32 and in float64
(``tests/_chained_moe_golden.py``: the two JAX programs, ~7 min to
compile here, are stored in ``tests/golden/chained_moe_step.npz``).
The gradient of this chained model is ill-conditioned in float32, so
the float64 steps are the reference: the port's float64 step within
F64_LOSS of JAX's on the loss and aux (each side sums the aux in f32,
as the modules cast the router's softmax to f32) and each tensor's
gradient within F64_GRAD of its norm plus F64_GRAD_TOP of the largest
norm; the jump counter equal.  The port's float32 step: loss and aux within 1e-5 of
JAX's float32, jstat equal, each tensor's gradient within twice JAX's
float32 distance from JAX's float64 one plus F32_SLACK of the largest
norm, the global norm likewise, and the median over the tensors of its
distance from JAX's float32 gradient within 2% of the tensor's norm.
The port's step with remat ("dots" and "full") equals the port's
without to 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.models.moe import MoEMLP as JMoE

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.models.moe import MoEMLP, expert_capacity
from asr_model_tpu_torch.train.loop import (_dots_policy, device_batch,
                                            make_optimizer, make_train_step)
from asr_model_tpu_torch.weights import from_jax_params, jax_layout

import _chained_moe_golden as G

D, H, B, T = 16, 48, 2, 12
# the train step's bounds (module doc): float64 loss and aux against
# JAX's float64 (measured 6.1e-8 and 1.1e-7: each side's f32 cross
# entropy and aux round differently); each float64 gradient within
# F64_GRAD of its norm plus F64_GRAD_TOP of the largest norm (measured
# at most 2.0e-3 of the norm on the tensors above 1e-3 of the largest,
# jump_s 1.0e-5 of the largest: the modules' f32 islands, the router
# softmax, the cross entropy and MSheath's means, round differently, and
# the chained model's gradient moves ~2e4 times a relative change of its
# weights, 1.7e-4 at 1e-8); the float32 gradients' slack
F64_LOSS = 5e-7
F64_GRAD, F64_GRAD_TOP = 4e-3, 2e-5
F32_SLACK = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_pair(E, k, cf, act="gelu", tie=False):
    x = np.random.RandomState(E + k).randn(B, T, D).astype(np.float32)
    jm = JMoE(D, H, E, top_k=k, capacity_factor=cf, act=act)
    params = jax.device_get(jm.init(jax.random.key(1), jnp.asarray(x)))[
        "params"]
    if tie:
        params["router"] = {k_: np.zeros_like(v)
                            for k_, v in params["router"].items()}
    tm = MoEMLP(D, H, E, k, cf, act, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm, x


def _jax_out(jm, params, x):
    def f(p, x):
        y, mut = jm.apply({"params": p}, x, mutable=["intermediates"])
        return y, mut["intermediates"]["moe_aux"][0]
    y, aux = jax.jit(f)(params, jnp.asarray(x))
    return np.asarray(y), float(aux)


def _port_out(tm, x):
    with stochastic.mode() as rec:
        y = tm(torch.from_numpy(x))
        aux = list(rec.moe_aux)
    assert len(aux) == 1
    return y.numpy(), float(aux[0])


CASES = {"no_drops": (4, 2, 100.0, "gelu", False),
         "drops": (4, 2, 0.5, "relu", False),
         "top1": (8, 1, 1.25, "swish", False),
         "ties": (4, 2, 0.75, "gelu", True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case):
    E, k, cf, act, tie = CASES[case]
    jm, params, tm, x = _moe_pair(E, k, cf, act, tie)
    want, jaux = _jax_out(jm, params, x)
    got, aux = _port_out(tm, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    # the routing: slots past C drop exactly where JAX's cumsum drops
    _, idx, _, slot, C = tm.route(torch.from_numpy(x))
    assert C == expert_capacity(T, E, k, cf)
    dropped = int((slot >= C).sum())
    assert (dropped == 0) == (case in ("no_drops",)), dropped
    if tie:      # equal probabilities: the lowest expert ids win
        assert torch.equal(idx, torch.arange(k).expand(B, T, k))


def test_moe_examples_are_independent():
    """Slots are allocated per example: each row alone gives the batched
    output (to f32 rounding: the products block differently), at a
    capacity that drops."""
    jm, params, tm, x = _moe_pair(4, 2, 0.5)
    got, _ = _port_out(tm, x)
    for b in range(B):
        alone, _ = _port_out(tm, x[b:b + 1])
        np.testing.assert_allclose(alone[0], got[b], rtol=1e-6,
                                   atol=1e-7)
        want, _ = _jax_out(jm, params, x[b:b + 1])
        np.testing.assert_allclose(alone, want, rtol=1e-5, atol=1e-6)


def test_moe_aux_only_where_a_record_takes_it(monkeypatch):
    """Outside ``stochastic.mode`` (a decode) the aux is not computed;
    inside, once a call."""
    _, _, tm, x = _moe_pair(4, 2, 1.25)
    made = []
    monkeypatch.setattr(stochastic, "add_moe_aux", made.append)
    want = tm(torch.from_numpy(x))
    assert made == []
    with stochastic.mode():
        got = tm(torch.from_numpy(x))
    assert len(made) == 1 and torch.equal(got, want)


def test_moe_gradients_match_jax():
    jm, params, tm, x = _moe_pair(4, 2, 0.75)
    w = np.random.RandomState(5).randn(B, T, D).astype(np.float32)

    def loss(p, x):
        y, mut = jm.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y * w) + mut["intermediates"]["moe_aux"][0]

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                      jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm.requires_grad_(True)
    with stochastic.mode() as rec:
        y = tm(xt)
        out = (y * torch.from_numpy(w)).sum() + rec.moe_aux[0]
    out.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    want = from_jax_params(jax.device_get(gp))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# ------------------------------------------------ the train step


@pytest.fixture(scope="module")
def golden():
    return G.load()


def _port_step(params, stats, remat=False, policy="dots",
               dtype=torch.float32):
    m = Model(Dimensions(**G.KW), ModelConfig(**G.MOE), device="cpu",
              dtype=dtype)
    m.load_state_dict(from_jax_params(params, stats), strict=True)
    opt, _ = make_optimizer(Config(dims=Dimensions(**G.KW)), m)
    step = make_train_step(m, opt, remat=remat, remat_policy=policy)
    db = {k: t.to(dtype) if t.is_floating_point() else t
          for k, t in device_batch(G.batch(), "cpu").items()}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    ctx = (functools.partial(create_selective_checkpoint_contexts,
                             _dots_policy) if policy == "dots" else None)
    with stochastic.remat(remat):
        # the step's forward and backward (``make_train_step``'s ``step``
        # without the optimizer)
        loss, jstat, _ = (stochastic.checkpoint(step.loss_fn, db, None,
                                                context_fn=ctx)
                          if remat else step.loss_fn(db, None))
        named = list(m.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    with torch.no_grad():
        aux = m(db["text_ids"], train=True, spectrogram=db["spectrogram"],
                pitch=db["pitch"], waveform=db["waveform"])["moe_aux"]
    layout = jax_layout(m)
    out = {}
    for (n, p), g in zip(named, grads):
        _c, path, perm = layout[n]
        g = torch.zeros_like(p) if g is None else g
        out["/".join(path)] = (g if perm is None else g.permute(*perm)
                               ).detach().double().numpy()
    return float(loss.detach()), float(aux), jstat.numpy(), out


def _norm(gs):
    return np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                       for g in gs.values()))


def test_chained_moe_train_step_matches_jax(golden):
    params, stats, jax_ = golden
    j32, j64 = jax_["f32"], jax_["f64"]
    top = max(float(np.linalg.norm(g)) for g in j64["grads"].values())

    # float64: the port's step against JAX's
    loss, aux, jstat, grads = _port_step(params, stats, dtype=torch.float64)
    assert abs(loss - j64["loss"]) <= F64_LOSS * abs(j64["loss"])
    assert abs(aux - j64["aux"]) <= F64_LOSS * abs(j64["aux"])
    np.testing.assert_array_equal(jstat, j64["jstat"])
    assert set(grads) == set(j64["grads"])
    for k, g in j64["grads"].items():
        err, n = float(np.linalg.norm(grads[k] - g)), float(np.linalg.norm(g))
        assert err <= F64_GRAD * n + F64_GRAD_TOP * top, (k, err, n)

    # float32: within twice JAX's float32 distance from JAX's float64
    loss, aux, jstat, grads = _port_step(params, stats)
    assert abs(loss - j32["loss"]) <= 1e-5 * abs(j32["loss"])
    assert abs(aux - j32["aux"]) <= 1e-5 * abs(j32["aux"])
    np.testing.assert_array_equal(jstat, j32["jstat"])
    rel = []
    for k, g in j64["grads"].items():
        err = float(np.linalg.norm(grads[k] - g))
        witness = float(np.linalg.norm(j32["grads"][k] - g))
        assert err <= 2.0 * witness + F32_SLACK * top, (k, err, witness)
        n = float(np.linalg.norm(g))
        if n > 1e-4 * top:
            rel.append(float(np.linalg.norm(grads[k] - j32["grads"][k]))
                       / n)
    assert float(np.median(rel)) <= 0.02, float(np.median(rel))
    gn, jgn, xgn = _norm(grads), _norm(j32["grads"]), _norm(j64["grads"])
    assert abs(gn - xgn) <= 2.0 * abs(jgn - xgn) + F32_SLACK * xgn, \
        (gn, jgn, xgn)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_chained_moe_train_step_remat(golden, policy):
    """Remat replays the forward without recording a call's aux twice:
    the loss and gradients equal the step's without remat."""
    params, stats, _ = golden
    loss, aux, jstat, grads = _port_step(params, stats)
    rloss, raux, rjstat, rgrads = _port_step(params, stats, remat=True,
                                             policy=policy)
    assert abs(rloss - loss) <= 1e-6 * abs(loss)
    assert abs(raux - aux) <= 1e-6 * abs(aux)
    np.testing.assert_array_equal(rjstat, jstat)
    for k, g in grads.items():
        np.testing.assert_allclose(rgrads[k], g, rtol=1e-6, atol=1e-9,
                                   err_msg=k)
