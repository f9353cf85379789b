"""The port's training math against the goldens and the JAX optimizer,
on the CPU: the reference's train trajectory
(tests/golden/reference_trajectory.npz, the bounds of
tests/test_reference_parity.py), MaxFactor against
tests/golden/maxfactor.npz and against the JAX ``maxfactor`` on a tree
with zero- and None-gradient leaves, and ``fam_scheduler2``.

The golden's reference state_dict reaches the port through the JAX
package's converter (``convert_state_dict``, numpy only) into the flax
tree, whose skeleton is the port's own (``to_jax_params``), then
``from_jax_params``.  Noise-free limit and dropout 0, as the golden was
made.  Bounds: float64 step-0 loss equal to the golden at the golden's
stored precision (float32: relative 1e-12), step-0 gradients within
1e-5 of each tensor's largest reference magnitude (skipping the
numerically-zero class), the f64 trajectory inside the measured
envelope [1e-12, 2e-6, 2e-4, 2e-3, 5e-2...]; float32 step-0 loss 5e-4,
the trajectory 3e-2, the final parameters by the aggregate check of
test_reference_parity.py; float32 step-0 gradients within 2e-3 of each
tensor's largest reference magnitude (float32 conditioning of the deep
stack; the float64 test pins the math).  MaxFactor: atol 2e-6, rtol
1e-5 (the golden test's bound); the schedule to float32 rounding.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.compat import convert_state_dict
from asr_model_tpu.optim.maxfactor import maxfactor as jmaxfactor
from asr_model_tpu.optim.schedules import fam_scheduler2 as jfam

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.optim.maxfactor import MaxFactor, bias_groups
from asr_model_tpu_torch.optim.schedules import fam_scheduler2
from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                            make_train_step)
from asr_model_tpu_torch.weights import from_jax_params, to_jax_params

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs files
    in parallel worker processes, and PyTorch's thread pools in each of
    them oversubscribe the cores (a test here ran 47x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traj():
    g = np.load(os.path.join(GOLD, "reference_trajectory.npz"))
    kw = dict(tokens=int(g["cfg_tokens"]), mels=int(g["cfg_mels"]),
              dims=int(g["cfg_dims"]), head=int(g["cfg_head"]),
              layer=int(g["cfg_layer"]))
    skel = Model(Dimensions(**kw), ModelConfig(dropout=0.0), device="cpu")
    params, stats = to_jax_params(skel)

    def convert(prefix, grads=False):
        sd = {k[4:]: g[k] for k in g.files if k.startswith("sd0:")}
        if grads or prefix != "sd0:":
            sd.update({k[4:]: g[k] for k in g.files if k.startswith(prefix)})
        v = convert_state_dict(sd, params, None if grads else stats)
        return from_jax_params(v["params"], v.get("batch_stats"))

    return g, kw, convert("sd0:"), convert("sdN:"), convert("g64:", True)


def _model(kw, sd, dtype):
    m = Model(Dimensions(**kw), ModelConfig(dropout=0.0), device="cpu",
              dtype=dtype)
    m.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                       for k, v in sd.items()}, strict=True)
    return m


def _batch(g, i, dtype):
    b = {"spectrogram": g[f"b{i}:spec"], "pitch": g[f"b{i}:pitch"],
         "waveform": g[f"b{i}:wave"], "text_ids": g[f"b{i}:ids"],
         "labels": g[f"b{i}:labels"]}
    out = device_batch(b, "cpu")
    return {k: v.to(dtype) if v.is_floating_point() else v.long()
            for k, v in out.items()}


def _grads(m, b):
    m.requires_grad_(True)
    out = m(b["text_ids"], labels=b["labels"], spectrogram=b["spectrogram"],
            pitch=b["pitch"], waveform=b["waveform"], train=True)
    names = [n for n, _ in m.named_parameters()]
    gs = torch.autograd.grad(out["loss"], list(m.parameters()),
                             allow_unused=True)
    return out["loss"], dict(zip(names, gs))


def _check_grads(got, want, tol):
    gscale = max(float(v.abs().max()) for v in want.values())
    checked = 0
    for name, ref in want.items():
        rmax = float(ref.abs().max())
        if rmax < 1e-10 * gscale:
            continue        # the numerically-zero-gradient class
        g = got[name]
        g = torch.zeros_like(ref) if g is None else g.to(ref.dtype)
        err = float((g - ref).abs().max())
        assert err / rmax < tol, (name, err, rmax)
        checked += 1
    assert checked > 100


def _run(g, kw, sd0, dtype):
    m = _model(kw, sd0, dtype)
    loss0, grads0 = _grads(m, _batch(g, 0, dtype))
    opt, _ = make_optimizer(Config(dims=Dimensions(**kw)), m)
    step = make_train_step(m, opt)
    losses, gnorms = [], []
    for i in range(int(g["n_steps"])):
        loss, gnorm, _ = step(_batch(g, i, dtype), None)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    assert losses[0] == float(loss0)
    return m, losses, gnorms, grads0


def test_golden_trajectory_float64(traj):
    """Step-0 loss at the golden's precision, step-0 gradients per
    tensor, the trajectory inside the envelope."""
    g, kw, sd0, _sdN, g64 = traj
    _m, losses, gnorms, grads0 = _run(g, kw, sd0, torch.float64)
    ref = np.asarray(g["losses64"])
    assert abs(float(np.float32(losses[0])) - ref[0]) / ref[0] < 1e-12, (
        losses[0], ref[0])
    _check_grads(grads0, {k: v.double() for k, v in g64.items()
                          if k in grads0}, 1e-5)
    env = [1e-12, 2e-6, 2e-4, 2e-3] + [5e-2] * (len(ref) - 4)
    for i, (a, b) in enumerate(zip(losses, ref)):
        assert abs(float(np.float32(a)) - b) / b < env[i], (i, losses, ref)
    assert all(np.isfinite(gnorms))


def test_golden_trajectory_float32(traj):
    g, kw, sd0, sdN, g64 = traj
    m, losses, gnorms, grads0 = _run(g, kw, sd0, torch.float32)
    ref = np.asarray(g["losses"])
    assert abs(losses[0] - ref[0]) / ref[0] < 5e-4, (losses[0], ref[0])
    np.testing.assert_allclose(losses, ref, rtol=3e-2)
    assert all(np.isfinite(gnorms))
    _check_grads(grads0, {k: v.float() for k, v in g64.items()
                          if k in grads0}, 2e-3)
    # the final parameters over the live-gradient tensors: the aggregate
    # check of tests/test_reference_parity.py
    gscale = max(float(v.abs().max()) for v in g64.values())
    live = [k for k, v in g64.items()
            if k in grads0 and float(v.abs().max()) >= 1e-10 * gscale]
    ours = {k: v.detach() for k, v in m.state_dict().items()}
    tot_err = tot_moved = tot_ours = 0.0
    for k in live:
        err = float(torch.sqrt(torch.mean((ours[k] - sdN[k]) ** 2)))
        moved = float(torch.sqrt(torch.mean((sdN[k] - sd0[k]) ** 2)))
        assert err / max(moved, 1e-12) < 3.0 or err < 1e-3, (k, err, moved)
        tot_err += float(torch.sum((ours[k] - sdN[k]) ** 2))
        tot_moved += float(torch.sum((sdN[k] - sd0[k]) ** 2))
        tot_ours += float(torch.sum((ours[k] - sd0[k]) ** 2))
    assert len(live) > 100
    assert np.sqrt(tot_err / tot_moved) < 1.2
    assert np.sqrt(tot_ours / tot_moved) < 1.4


SHAPES = [(8, 16), (16,), (4, 6, 5), ()]


@pytest.mark.parametrize("group,bias", [("main", 1), ("jump", 2)])
def test_maxfactor_matches_golden(group, bias):
    gold = np.load(os.path.join(GOLD, "maxfactor.npz"))
    ps = [torch.tensor(gold[f"init_{group}_{i}"]) for i in range(len(SHAPES))]
    opt = MaxFactor([{"params": ps, "bias": bias}], decay=1e-2,
                    lr=fam_scheduler2(2.5e-3, warmup_steps=10,
                                      total_steps=100))
    for t in range(5):
        for i, p in enumerate(ps):
            p.grad = torch.tensor(gold[f"grad_{t}_{i}"])
        opt.step()
        for i, p in enumerate(ps):
            np.testing.assert_allclose(
                p.numpy(), gold[f"{group}_{t}_{i}"], atol=2e-6, rtol=1e-5,
                err_msg=f"group={group} step={t} shape={SHAPES[i]}")


@pytest.mark.parametrize("clip", [False, True])
def test_maxfactor_matches_jax_with_zero_and_none_grads(clip):
    """Six steps on a tree mixing the two bias groups, with a leaf whose
    gradient is zero and one whose ``.grad`` is None on the port's side
    (zero on JAX's): both still take the decoupled weight decay, as the
    JAX optimizer applies it to every leaf (torch optimizers skip a
    None-gradient parameter)."""
    rs = np.random.RandomState(0)
    shapes = {"w": (8, 16), "jump_w": (3, 4, 5), "b": (16,), "s": (),
              "zero": (6, 4), "none": (7,), "jump_none": (2, 3, 4)}
    init = {k: np.asarray(rs.randn(*s), np.float32) for k, s in shapes.items()}
    dead = ("zero", "none", "jump_none")
    grads = [{k: (np.zeros(s, np.float32) if k in dead
                  else np.asarray(rs.randn(*s), np.float32))
              for k, s in shapes.items()} for _ in range(6)]
    kw = dict(b_decay=-0.8, eps=(1e-8, 1e-8), d=1.0, decay=1e-2, gamma=0.99,
              min_lr=1e-9, clip=clip, cap=0.5)
    sched = dict(warmup_steps=2, total_steps=6)
    labels = {k: 2 if k.startswith("jump") else 1 for k in shapes}
    tx = jmaxfactor(lr=jfam(2.5e-3, **sched), bias=labels, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in init.items()}
    opt = MaxFactor(bias_groups(tp.items()), lr=fam_scheduler2(2.5e-3,
                                                               **sched), **kw)
    for gr in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, st,
                            params=jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = None if k.endswith("none") else torch.tensor(gr[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=2e-6, rtol=1e-5, err_msg=k)
    for k in dead:
        assert not np.array_equal(tp[k].numpy(), init[k]), k
    assert opt.step_count == int(st.step) == 6


@pytest.mark.parametrize("decay_start", [None, 7])
def test_fam_scheduler2_matches_jax(decay_start):
    kw = dict(warmup_steps=5, total_steps=20, decay_start=decay_start,
              warmup_start=1e-6, eta_min=1e-5)
    ours, theirs = fam_scheduler2(2.5e-3, **kw), jfam(2.5e-3, **kw)
    got = np.asarray([ours(s) for s in range(25)], np.float32)
    want = np.asarray([float(theirs(s)) for s in range(25)], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_multisteps_matches_optax():
    """Gradient accumulation (``acc_steps``): the port's ``MultiSteps``
    around MaxFactor against optax's around the JAX optimizer, every 2
    calls, 6 calls: no update on the odd calls, the mean gradient's
    update on the even ones."""
    import optax
    rs = np.random.RandomState(2)
    shapes = {"w": (6, 5), "b": (5,), "jump_w": (2, 3, 4)}
    init = {k: np.asarray(rs.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rs.randn(*s), np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    sched = dict(warmup_steps=2, total_steps=6)
    labels = {k: 2 if k.startswith("jump") else 1 for k in shapes}
    tx = optax.MultiSteps(jmaxfactor(lr=jfam(2.5e-3, **sched), bias=labels,
                                     decay=1e-2), every_k_schedule=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    update = jax.jit(lambda g, s, p: tx.update(g, s, params=p))
    tp = {k: torch.tensor(v) for k, v in init.items()}
    from asr_model_tpu_torch.optim.maxfactor import MultiSteps
    opt = MultiSteps(MaxFactor(bias_groups(tp.items()), decay=1e-2,
                               lr=fam_scheduler2(2.5e-3, **sched)), 2)
    for i, gr in enumerate(grads):
        upd, st = update({k: jnp.asarray(v) for k, v in gr.items()}, st, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(gr[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=2e-6, rtol=1e-5, err_msg=k)
        assert opt.mini_step == int(st.mini_step)
        assert opt.gradient_step == int(st.gradient_step)
    assert opt.inner.step_count == 3
