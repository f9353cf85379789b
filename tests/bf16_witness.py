"""Why the bf16 train steps of the JAX package and the port differ, on
the tiny model and batch of ``tests/_torch_train_step.py``: a witness,
not a test (pytest does not collect it).

    python tests/bf16_witness.py        # ~8 min on a CPU, JAX compiles

For the JAX init and for ``wide_margins`` it takes the train-step loss
and its gradients (noise-free, one step's worth, no optimizer) in f32
and bf16 on each side, logs every hard choice of the forward (the port
through ``record_choices``; JAX by patching the same functions with
``jax.debug.callback``), and prints per pair of runs the choices that
differ by kind, the smallest margins among them, and how far the
gradients are apart.  Then it shows JAX's bf16 backward summing a
broadcast bias's cotangents in bf16, and the bf16 gradient of q_proj
at the parameters the port's bf16 step reaches after two steps from
``wide_margins``.  The calls of a kind are paired across the runs by
least disagreement (JAX's scan traces a body once, the port loops)."""

import collections
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (CPU platform, compile cache)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import linear_sum_assignment  # noqa: E402

import _torch_train_step as T  # noqa: E402
from asr_model_tpu.models import gates as jgates  # noqa: E402
from asr_model_tpu.models import norms as jnorms  # noqa: E402
from asr_model_tpu.models import sheath as jsheath  # noqa: E402
from asr_model_tpu.models.model import \
    cross_entropy_ignore_pad as jce  # noqa: E402

Q = "processor/block1/attn/q_proj/kernel"


def jax_choices(log):
    """Patch the JAX model's hard choices to append (kind, choice,
    margin) to ``log`` from inside the compiled program."""
    def put(kind):
        return lambda c, m: log.append((kind, np.asarray(c),
                                        np.asarray(m, np.float32)))

    def gap(y, k):
        s = jnp.sort(y.astype(jnp.float32), axis=-1)
        return s[..., -k] - s[..., -k - 1]

    gumbel = jnorms.gumbel_softmax

    def gumbel_softmax(rng, logits, tau=1.0, hard=True):
        kind = "jump" if logits.ndim == 1 else "abby"
        jax.debug.callback(put(kind), jnp.argmax(logits, -1), gap(logits, 1))
        return gumbel(rng, logits, tau, hard)

    topk = jgates._topk_hard

    def topk_hard(scores, num):
        idx = jnp.sort(jnp.argsort(-scores, axis=-1)[..., :num], axis=-1)
        jax.debug.callback(put("top2"), idx, gap(scores, num))
        return topk(scores, num)

    ste = jsheath.ste_threshold

    def ste_threshold(x, t):
        d = x.astype(jnp.float32) - t
        jax.debug.callback(put("mask"), d > 0, jnp.abs(d))
        return ste(x, t)

    window = jnorms.window_reduce_last
    means = []

    def window_reduce_last(x, size, kind):
        y = window(x, size, kind)
        if kind == "mean":
            means.append(y)
        else:
            d = y.astype(jnp.float32) - 2.0 * means.pop().astype(jnp.float32)
            jax.debug.callback(put("window"), d > 0, jnp.abs(d))
        return y

    mp = pytest.MonkeyPatch()
    mp.setattr(jnorms, "gumbel_softmax", gumbel_softmax)
    mp.setattr(jsheath, "gumbel_softmax", gumbel_softmax)
    mp.setattr(jgates, "_topk_hard", topk_hard)
    mp.setattr(jsheath, "ste_threshold", ste_threshold)
    mp.setattr(jnorms, "window_reduce_last", window_reduce_last)
    return mp


def jax_grads(jm, v, jb, dtype, log=None):
    """JAX's train-step loss (``loop.py``'s bf16 form: casts inside,
    cross entropy on f32 logits) and its gradients at ``v``."""
    def loss_fn(p):
        def cast(t):
            return jax.tree.map(lambda x: x.astype(dtype)
                                if dtype and x.dtype == jnp.float32 else x, t)
        out, _ = jm.apply({"params": cast(p),
                           "batch_stats": cast(v["batch_stats"])},
                          jb["text_ids"], spectrogram=cast(jb["spectrogram"]),
                          pitch=cast(jb["pitch"]),
                          waveform=cast(jb["waveform"]), train=True,
                          mutable=["batch_stats", "intermediates"])
        return jce(out["logits"].astype(jnp.float32), jb["labels"])

    mp = jax_choices(log) if log is not None else None
    try:
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        jax.effects_barrier()
    finally:
        if mp is not None:
            mp.undo()
    return float(loss), dict(T.flat(jax.device_get(g)))


def port_run(v, compute):
    mp = pytest.MonkeyPatch()
    log = T.record_choices(mp)
    try:
        loss, g = T.port_grads(v, compute)
    finally:
        mp.undo()
    return loss, g, log


def differ(la, lb):
    """{kind: choices that differ}, smallest margins among them."""
    def key(log):
        d = collections.defaultdict(list)
        for kind, c, m in log:
            d[(kind, c.shape)].append((c, m))
        return d

    a, b = key(la), key(lb)
    out, margins = collections.Counter(), []
    for k in set(a) & set(b):
        cost = np.array([[int(np.sum(ca != cb)) for cb, _ in b[k]]
                         for ca, _ in a[k]])
        for i, j in zip(*linear_sum_assignment(cost)):
            (ca, ma), (cb, mb) = a[k][i], b[k][j]
            bad = ca != cb
            if ca.ndim > ma.ndim:           # top2: one pair of types
                bad = bad.any(-1)
            out[k[0]] += int(bad.sum())
            margins.extend(np.minimum(ma, mb)[bad].tolist())
    return dict(out), sorted(margins)[:3]


def norm(g):
    return float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                             for a in g.values())))


def apart(ga, gb):
    return norm({k: ga[k] - gb[k] for k in ga}) / norm(ga)


def main():
    torch.set_num_threads(2)
    for margins in (False, True):
        jm, v, jb = T.jax_variables(margins)
        runs = {}
        for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
            log = []
            loss, g = jax_grads(jm, v, jb, dt, log)
            runs["jax " + name] = (loss, g, log)
            runs["port " + name] = port_run(v, name)
        print(f"== {'wide_margins' if margins else 'the JAX init'}")
        for name, (loss, g, log) in runs.items():
            print(f"{name:>9}: loss {loss:.6f}, grad norm {norm(g):.4f}, "
                  f"{sum(c.size for _, c, _ in log)} choices")
        for a, b in (("jax f32", "port f32"), ("jax f32", "jax bf16"),
                     ("port f32", "port bf16"), ("jax bf16", "port bf16")):
            flips, least = differ(runs[a][2], runs[b][2])
            gap = 100 * apart(runs[a][1], runs[b][1])
            print(f"{a} vs {b}: gradients {gap:.2f}% apart; choices that "
                  f"differ {flips}, least margins {least}")

    rs = np.random.RandomState(0)
    x, b, g = (rs.randn(4096, 16).astype(np.float32), rs.randn(16).astype(
        np.float32), rs.randn(4096, 16).astype(np.float32))
    exact = g.astype(np.float64).sum(0)
    for dt in (jnp.float32, jnp.bfloat16):
        gb = jax.jit(jax.grad(lambda b_: jnp.sum(
            (x.astype(dt) + b_.astype(dt)) * g.astype(dt)).astype(
                jnp.float32)))(b)
        print(f"JAX {jnp.dtype(dt).name} bias gradient over 4096 rows: "
              f"{np.asarray(gb)[:3]} (exact {exact[:3]})")
    bt = torch.tensor(b, dtype=torch.bfloat16, requires_grad=True)
    ((torch.tensor(x).bfloat16() + bt) * torch.tensor(g).bfloat16()).sum() \
        .float().backward()
    print(f"PyTorch bfloat16 the same: {bt.grad.float().numpy()[:3]}")

    jm, v, jb = T.jax_variables(True)
    from asr_model_tpu_torch.config import Config, Dimensions
    from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                                make_train_step)
    from asr_model_tpu_torch.weights import to_jax_params
    m = T.port_model(v)
    opt, _ = make_optimizer(Config(dims=Dimensions(**T.KW)), m)
    step = make_train_step(m, opt, 0.0, torch.bfloat16)
    db = device_batch(T.batch(), "cpu")
    step(db, None)
    step(db, None)
    params, stats = to_jax_params(m)
    v2 = {"params": params, "batch_stats": stats}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        _, gj = jax_grads(jm, v2, jb, dt)
        _, gp, _ = port_run(v2, name)
        print(f"after two port bf16 steps, {name}: grad norm JAX "
              f"{norm(gj):.4f} port {norm(gp):.4f}; |grad q_proj| JAX "
              f"{np.linalg.norm(gj[Q]):.4f} port {np.linalg.norm(gp[Q]):.4f}")


if __name__ == "__main__":
    main()
