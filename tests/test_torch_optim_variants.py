"""The port's MaxFactor variants, SimpleFAM, FAMOptimizer and
``fam_scheduler`` against the JAX package's (``asr_model_tpu/optim/
variants.py``, ``fam.py``, ``schedules.py``): the same parameters and
the same random gradients, 5 steps (SimpleFAM 103, to pass its step-100
switch), parameters within rtol 1e-5 / atol 1e-6 of JAX's (float32 sums
in other orders), the tracked rate within rtol 1e-6, the band split and
the roles and groups exactly, the schedules within 1e-6 of the base
rate (XLA's and numpy's float32 cosines differ by an ulp, which the
1 + cos cancellation near the end of the cosine magnifies)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from asr_model_tpu.optim import fam as jfam
from asr_model_tpu.optim import variants as jvar
from asr_model_tpu.optim.schedules import fam_scheduler as jfam_scheduler

from asr_model_tpu_torch.optim import fam, variants
from asr_model_tpu_torch.optim.schedules import fam_scheduler

SHAPES = {"conv_stem/kernel": (4, 6), "attn/bias": (6,),
          "jump_embed/w": (8, 4, 2), "jump/scale": (),
          "big/kernel": (40, 32)}


def _params():
    rs = np.random.RandomState(0)
    return {k: np.asarray(rs.randn(*s), np.float32)
            for k, s in SHAPES.items()}


def _grads(n, seed=1):
    rs = np.random.RandomState(seed)
    return [{k: np.asarray(rs.randn(*s) * 0.1, np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _tree(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split("/")
        out.setdefault(a, {})[b] = jnp.asarray(v)
    return out


def _flat(tree):
    return {f"{a}/{b}": np.asarray(v) for a, d in tree.items()
            for b, v in d.items()}


def _jax_run(tx, grads):
    p = _tree(_params())
    st = tx.init(p)
    upd = jax.jit(lambda g, s, p: tx.update(g, s, params=p))
    for g in grads:
        u, st = upd(_tree(g), st, p)
        p = optax.apply_updates(p, u)
    return _flat(jax.device_get(p)), st


def _port_run(make, grads):
    ps = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    opt = make(list(ps.values()), ps)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: p.numpy() for k, p in ps.items()}, opt


def _roles(named):
    names = sorted(named)
    r = variants.depth_roles(names)
    return {named[n]: r[n] for n in names}


CASES = {
    "maxfactor99_b1": (lambda: jvar.maxfactor99(lr=0.01, bias=1),
                       lambda ps, n: variants.maxfactor99(ps, lr=0.01)),
    "maxfactor99_b2": (lambda: jvar.maxfactor99(lr=0.01, bias=2),
                       lambda ps, n: variants.maxfactor99(ps, lr=0.01,
                                                          bias=2)),
    "maxfactor_a": (
        lambda: jvar.maxfactor_a(
            lr=0.01, roles=jvar.depth_role_tree(_tree(_params()))),
        lambda ps, n: variants.maxfactor_a(ps, lr=0.01, roles=_roles(n))),
    "maxfactor1": (lambda: jvar.maxfactor1(lr=0.01),
                   lambda ps, n: variants.maxfactor1(ps, lr=0.01)),
    "maxfactor2": (lambda: jvar.maxfactor2(lr=0.01),
                   lambda ps, n: variants.maxfactor2(ps, lr=0.01)),
    "maxfactorb_b0": (lambda: jvar.maxfactorb(lr=0.01, bias=0),
                      lambda ps, n: variants.maxfactorb(ps, lr=0.01,
                                                        bias=0)),
    "maxfactorb_b2": (lambda: jvar.maxfactorb(lr=0.01, bias=2),
                      lambda ps, n: variants.maxfactorb(ps, lr=0.01,
                                                        bias=2)),
    "maxheadroom": (lambda: jvar.maxheadroom(lr=0.01),
                    lambda ps, n: variants.maxheadroom(ps, lr=0.01)),
    "maxfactorb_clip": (
        lambda: jvar.maxfactorb(lr=0.01, bias=1, clip=True, cap=0.01),
        lambda ps, n: variants.maxfactorb(ps, lr=0.01, clip=True,
                                          cap=0.01)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_variant_five_step_trajectory(name):
    jmake, pmake = CASES[name]
    grads = _grads(5)
    want, jst = _jax_run(jmake(), grads)
    got, opt = _port_run(pmake, grads)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert not np.allclose(got[k], _params()[k])
    if isinstance(jst, jvar.TrackedLRState):
        np.testing.assert_allclose(variants.get_last_lr(opt),
                                   jvar.get_last_lr(jst), rtol=1e-6)
    else:
        with pytest.raises(ValueError, match="TrackedLRState"):
            variants.get_last_lr(opt)


def test_simple_fam_past_its_switch():
    """103 steps: the last three take the frequency-adaptive momentum on
    the parameter of 1,280 elements."""
    grads = _grads(103, seed=2)
    want, _ = _jax_run(jvar.simple_fam(lr=0.01), grads)
    got, _ = _port_run(lambda ps, n: variants.simple_fam(ps, lr=0.01),
                       grads)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fam_optimizer_five_steps_with_handlers():
    """Every handler, decay on, the adaptive momentum from step 3."""
    grads = _grads(5, seed=3)
    kw = dict(lr=0.01, decay=0.01, min_size=5, fam_start_step=2,
              n_bands=8, sample_size=20)
    names = sorted(SHAPES)
    jt = jfam.handler_tree_from_params(_tree(_params()))
    want, jst = _jax_run(jfam.fam_optimizer(handler_tree=jt, **kw), grads)

    def make(ps, named):
        h = fam.handler_tree_from_params(named.items())
        return fam.fam_optimizer(ps, handlers={named[k]: h[k]
                                               for k in names}, **kw)
    got, opt = _port_run(make, grads)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    hist = _flat(jax.device_get(jst.freq_history))
    ps = list(opt.param_groups[0]["params"])
    for k, p in zip(SHAPES, ps):
        np.testing.assert_allclose(opt.state[p]["freq_history"].numpy(),
                                   hist[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("split", ["linear", "log", "lowhigh"])
def test_band_splits(split):
    p = np.abs(np.random.RandomState(4).randn(501)).astype(np.float32)
    p /= p.sum()
    j = getattr(jfam, f"_band_powers_{split}")(jnp.asarray(p), 8)
    t = getattr(fam, f"_band_powers_{split}")(torch.from_numpy(p), 8)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-7)


def test_handlers_roles_and_groups():
    named = [(k, None) for k in sorted(SHAPES)]
    assert fam.handler_tree_from_params(named) == _flat_names(
        jfam.handler_tree_from_params(_tree(_params())))
    bands = torch.tensor([0.05, 0.05, 0.3, 0.2, 0.1, 0.1, 0.1, 0.1])
    for name, h in fam.HANDLERS.items():
        a = float(h.get_adaptive_momentum(bands, 0.9))
        b = float(jfam.HANDLERS[name].get_adaptive_momentum(
            jnp.asarray(bands.numpy()), 0.9))
        assert a == b, name
    groups = fam.get_parameter_groups(named, lr=1e-3, decay=0.01)
    jgroups = jfam.get_parameter_groups(_tree(_params()), lr=1e-3,
                                        decay=0.01)
    assert groups == jgroups
    assert variants.depth_roles(sorted(SHAPES)) == _flat_names(
        jvar.depth_role_tree(_tree(_params())))


def _flat_names(tree):
    return {f"{a}/{b}": v for a, d in tree.items() for b, v in d.items()}


def test_fam_scheduler_matches_jax():
    for args in ((1e-3, 5, 20), (2.5e-3, 1, 3, 1e-6, 1e-7)):
        got = fam_scheduler(*args)
        want = jfam_scheduler(*args)
        for e in range(0, 25):
            a, b = np.float32(got(e)), np.float32(want(e))
            assert abs(a - b) <= 1e-6 * args[0], (args, e, a, b)


def test_flax_order_and_debug_dump(tmp_path):
    """``flax_order`` sorts a model's parameters as jax.tree_util flattens
    its flax tree; ``dump_debug_info`` writes the history as JSON."""
    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.weights import to_jax_params
    m = Model(Dimensions(tokens=20, mels=4, dims=8, head=2, layer=2),
              device="cpu")
    names = [n for n, _ in variants.flax_order(m)]
    leaves = jax.tree_util.tree_flatten_with_path(to_jax_params(m)[0])[0]
    assert names == ["/".join(k.key for k in path) for path, _ in leaves]
    roles = variants.depth_role_tree(m)
    assert len(roles) == len(names)
    path = str(tmp_path / "d" / "fam.json")
    fam.dump_debug_info(path, {"w": {"bands": torch.ones(3), "n": 2}})
    blob = json.load(open(path))
    assert blob["parameters"]["w"] == {"bands": [1.0, 1.0, 1.0], "n": 2}
