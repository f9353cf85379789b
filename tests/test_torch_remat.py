"""The port's remat (``make_train_step(remat=True, remat_policy=...)``)
against its own step without remat, on the CPU, with gumbel and dropout
on, drawn from one seeded generator: the tiny model of
``tests/_torch_train_step.py`` (train-mode BatchNorm, dropout 0.1),
f32 and bf16 compute, policies "dots" and "full", two steps.  Bounds
(those of ``tests/test_train.py``'s remat test): the loss within 1e-6
relative, the grad norm within 5e-4, the parameters after each step
within atol 1e-6 + rtol 1e-5, the jump counter and BatchNorm's running
statistics as tight.  (Remat changes no arithmetic: measured equal to
the bit.)

The recompute runs inside the backward, after the forward's train-mode
context has exited, and on a CUDA device on autograd's own thread: the
checkpoint replays the forward's state and rewinds the generator, so the
recompute draws the same noise, checkpoints the MSheath slot steps again
and takes no eval route (``stochastic.checkpoint``).  Checked here by
counting the slot steps (forward, the loss's recompute, the slots'
recomputes: three times the forward's count) with the backward run on
a thread of its own, and by the eval-only plain versions' call counts
staying 0."""

import threading

import pytest
import torch

from _torch_train_step import KW, batch, one_thread  # noqa: F401

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models import sheath, stochastic
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops.cuda import abby, sheath as ksheath
from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                            make_train_step)

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _steps(compute, remat, policy, n=2, streaming=False):
    m = Model(Dimensions(**KW), ModelConfig(streaming=streaming),
              device="cpu", seed=0)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    step = make_train_step(m, opt, 0.0, DTYPES[compute], remat=remat,
                           remat_policy=policy)
    db = device_batch(batch(), "cpu")
    gen = torch.Generator().manual_seed(11)
    out = []
    for _ in range(n):
        loss, gn, js = step(db, gen)
        out.append((float(loss), float(gn), js.tolist(),
                    {k: v.detach().clone() for k, v in
                     m.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def plain():
    return {(c, s): _steps(c, False, "dots", streaming=s)
            for c in DTYPES for s in (False, True)}


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("policy", ["dots", "full"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_remat_step_equals_step_without_remat(plain, compute, policy,
                                              streaming):
    want = plain[(compute, streaming)]
    ks, kp = ksheath.sheath_scan_plain.calls, abby.abby_plain.calls
    got = _steps(compute, True, policy, streaming=streaming)
    assert (ksheath.sheath_scan_plain.calls, abby.abby_plain.calls) \
        == (ks, kp)
    assert want[0][2] != want[1][2] or want[0][0] != want[1][0]
    for (gl, gg, gj, gs), (wl, wg, wj, ws) in zip(got, want):
        assert abs(gl - wl) <= 1e-6 * abs(wl), (gl, wl)
        assert abs(gg - wg) <= 5e-4 * abs(wg), (gg, wg)
        assert gj == wj
        for k in ws:
            torch.testing.assert_close(gs[k], ws[k], atol=1e-6, rtol=1e-5)


def test_noise_is_live(plain):
    """The generator's draws reach the step: another seed moves the
    loss."""
    m = Model(Dimensions(**KW), ModelConfig(), device="cpu", seed=0)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    step = make_train_step(m, opt, 0.0)
    loss, _, _ = step(device_batch(batch(), "cpu"),
                      torch.Generator().manual_seed(12))
    assert float(loss) != plain[("f32", False)][0][0]


def test_recompute_replays_state_on_autograd_thread(monkeypatch):
    """The backward on a thread of its own (as autograd runs a CUDA
    backward): the loss's recompute checkpoints the slot steps again and
    each slot step is recomputed once, the gradients equal those of the
    step without remat, and nothing is recorded twice."""
    calls = []
    inner = sheath.MSheath._slot

    def counted(self, *a):
        calls.append(stochastic.train_mode())
        return inner(self, *a)

    monkeypatch.setattr(sheath.MSheath, "_slot", counted)
    db = device_batch(batch(), "cpu")
    grads = {}
    for remat in (False, True):
        m = Model(Dimensions(**KW), ModelConfig(), device="cpu", seed=0)
        opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
        step = make_train_step(m, opt, 0.0, remat=remat)
        params = list(m.parameters())
        gen = torch.Generator().manual_seed(11)
        calls.clear()
        with stochastic.remat(remat):
            loss, jstat, stats = (
                stochastic.checkpoint(step.loss_fn, db, gen, gen=gen)
                if remat else step.loss_fn(db, gen))
        forward = len(calls)
        box = {}

        def backward():
            box["g"] = torch.autograd.grad(loss, params, allow_unused=True)

        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        grads[remat] = (box["g"], float(loss.detach()), jstat.tolist(),
                        {k: v[0].clone() for k, v in stats.items()})
        n_slots = forward
        assert n_slots > 0
        assert len(calls) == (3 * n_slots if remat else n_slots)
        # the recomputes run in the forward's train mode
        assert all(calls)
    (g0, l0, j0, s0), (g1, l1, j1, s1) = grads[False], grads[True]
    assert l0 == l1 and j0 == j1
    assert all(torch.equal(a, b) for a, b in zip(s0.values(), s1.values()))
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_unknown_policy_raises():
    m = Model(Dimensions(**KW), ModelConfig(), device="cpu", seed=0)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    with pytest.raises(ValueError, match="remat_policy"):
        make_train_step(m, opt, remat=True, remat_policy="nothing")
