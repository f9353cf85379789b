"""Shared by tests/test_torch_train_step*.py: the JAX package's
``make_train_step`` and the port's on the same tiny model, batch and
initial weights, in the noise-free limit (JAX's gumbel draws replaced by
zeros, dropout 0; the port's generator None), stepped three times;
``wide_margins``, an initialisation whose hard choices are all made far
above a bf16 ulp; the port's own step, per-tensor gradients and hard
choices at given weights (``port_steps``, ``port_grads``,
``record_choices``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.config import Config as JConfig
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JModelConfig
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.train.loop import make_optimizer as jmake_optimizer
from asr_model_tpu.train.loop import make_train_step as jmake_train_step

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models import gates, norms, stochastic
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.train.checkpoint import opt_state_tree
from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                            make_train_step)
from asr_model_tpu_torch.weights import (from_jax_params, jax_layout,
                                         to_jax_array, to_jax_params)

KW = dict(tokens=64, mels=8, dims=16, head=2, layer=2)
STEPS = 3
DTYPES = {"f32": None, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs files
    in parallel worker processes, and PyTorch's thread pools in each of
    them oversubscribe the cores (a test here ran 47x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch():
    rs = np.random.RandomState(0)
    b, ta, tt = 2, 16, 6
    labels = rs.randint(3, 64, (b, tt))
    labels[1, -2:] = 0
    return {"spectrogram": rs.randn(b, 8, ta).astype(np.float32),
            "pitch": (rs.rand(b, 1, ta) * 200).astype(np.float32),
            "waveform": (rs.randn(b, 1, ta) * 0.3).astype(np.float32),
            "text_ids": rs.randint(3, 64, (b, tt)), "labels": labels}


def flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def unflat(items):
    tree = {}
    for name, a in items:
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


# per hard choice of the train forward, the parameters that decide it:
# (name suffix, scale, shift)
WIDE = (("router_out/kernel", 0.01, 0.0),           # AbbyNormal:
        ("router_out/bias", 1.0, (12.0, 0.0, 0.0)),  # the window mean
        ("router/top/bias", 1.0, (8.0, 4.0, 0.0)),   # Router: types 0, 1
        ("pnet/fc2/bias", 1.0, (0.0, 8.0, 0.0)),     # MSheath: skip one
        ("jump/vcat_b", 1.0, (8.0,)),                # v_gate: mask on
        ("token/embedding", 0.05, 0.0))              # logits O(1)


def wide_margins(params):
    """A copy of the flax ``params`` in which every hard choice of the
    train forward is made by a margin far above a bf16 ulp, so bf16 and
    f32, and the two frameworks, take one discrete path (``WIDE``): the
    decision biases shifted, AbbyNormal's router kernel scaled down so
    its inputs (up to hundreds) cannot outvote its bias, and the token
    embedding (tied to the output head) scaled by 0.05, so the logits
    are O(1) and the loss ~6, not ~100.  AbbyNormal then always takes
    the windowed mean, so its per-element max-against-mean test, which
    ties in bf16 wherever a window's sums round alike, reaches no
    forward value."""
    out = []
    for name, a in flat(params):
        for suffix, scale, shift in WIDE:
            if name.endswith("/" + suffix):
                a = a * np.float32(scale) + np.asarray(shift, np.float32)
        out.append((name, a.astype(np.float32)))
    return unflat(out)


@functools.lru_cache(maxsize=1)
def _jax_init():
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in batch().items()}
    jm = JModel(param=JDims(**KW), cfg=JModelConfig(dims=JDims(**KW),
                                                    dropout=0.0))
    v = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jb["text_ids"], spectrogram=jb["spectrogram"],
        pitch=jb["pitch"], waveform=jb["waveform"]))(jax.random.key(0)))
    return jm, v, jb


def jax_variables(margins: bool = False):
    """The JAX model, its variables from key 0 (``wide_margins`` applied
    to the params when ``margins``) and the batch as JAX arrays; the
    init is traced once a process."""
    jm, v, jb = _jax_init()
    if margins:
        v = dict(v, params=wide_margins(v["params"]))
    return jm, v, jb


def port_model(v, streaming: bool = False):
    m = Model(Dimensions(**KW), ModelConfig(dropout=0.0,
                                            streaming=streaming),
              device="cpu")
    m.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                      strict=True)
    return m


def port_steps(v, compute: str, steps: int = STEPS, streaming=False,
               remat=False, remat_policy="dots"):
    """The port's ``make_train_step`` from the variables ``v``: per step
    (loss, gnorm, jstat, params tree, opt-state dict, batch stats)."""
    m = port_model(v, streaming)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    step = make_train_step(m, opt, 0.0, DTYPES[compute], remat=remat,
                           remat_policy=remat_policy)
    db = device_batch(batch(), "cpu")
    ours = []
    for _ in range(steps):
        loss, gn, js = step(db, None)
        params, stats = to_jax_params(m)
        ost = opt_state_tree(opt, m)
        ours.append((float(loss), float(gn), js.numpy(), dict(flat(params)),
                     {k: dict(flat(ost[k])) for k in ("row_var", "col_var",
                                                      "v")},
                     dict(flat(stats))))
        assert all(t.dtype == torch.float32 for t in m.parameters())
        assert int(ost["step"]) == len(ours)
    return ours


def port_grads(v, compute: str):
    """(loss, {flax name: gradient}) of the port's train-step loss
    (``step.loss_fn``, the compute dtype's casts included) at ``v``."""
    m = port_model(v)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    step = make_train_step(m, opt, 0.0, DTYPES[compute])
    loss, _, _ = step.loss_fn(device_batch(batch(), "cpu"), None)
    named = list(m.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    layout = jax_layout(m)
    out = {}
    for (n, p), g in zip(named, grads):
        _coll, path, perm = layout[n]
        out["/".join(path)] = to_jax_array(
            torch.zeros_like(p) if g is None else g, perm)
    return float(loss.detach()), out


def record_choices(monkeypatch):
    """Log every hard choice the port's train forward makes while the
    patch is on: a list of (kind, choice, margin) with numpy arrays.
    Kinds: ``abby`` (AbbyNormal's routing argmax), ``jump`` (MSheath's
    policy argmax), ``top2`` (the Router's two types), ``mask`` (the
    v_gate threshold) and ``window`` (AbbyNormal's max > 2 * mean).
    The margin is the distance to the nearest other outcome: the gap
    between the winner and the runner-up, or from the threshold."""
    log = []

    def gap(y, k):
        s = torch.sort(y.detach().float(), dim=-1).values
        return (s[..., -k] - s[..., -k - 1]).numpy()

    gumbel = stochastic.gumbel_softmax

    def gumbel_softmax(logits, noise=None, tau=1.0, hard=True):
        kind = "jump" if logits.dim() == 1 else "abby"
        log.append((kind, torch.argmax(logits.detach(), -1).numpy(),
                    gap(logits, 1)))
        return gumbel(logits, noise, tau, hard)

    topk = gates._topk_hard

    def topk_hard(scores, num):
        idx = torch.argsort(scores.detach(), dim=-1, descending=True,
                            stable=True)[..., :num]
        log.append(("top2", torch.sort(idx, -1).values.numpy(),
                    gap(scores, num)))
        return topk(scores, num)

    ste = stochastic.ste_threshold

    def ste_threshold(x, t):
        d = x.detach().float() - t
        log.append(("mask", (d > 0).numpy(), d.abs().numpy()))
        return ste(x, t)

    window = norms.window_reduce
    means = []

    def window_reduce(x, size, kind):
        y = window(x, size, kind)
        if kind == "mean":
            means.append(y.detach().float())
        else:
            d = y.detach().float() - 2.0 * means.pop()
            log.append(("window", (d > 0).numpy(), d.abs().numpy()))
        return y

    monkeypatch.setattr(stochastic, "gumbel_softmax", gumbel_softmax)
    monkeypatch.setattr(gates, "_topk_hard", topk_hard)
    monkeypatch.setattr(stochastic, "ste_threshold", ste_threshold)
    monkeypatch.setattr(norms, "window_reduce", window_reduce)
    return log


def run(monkeypatch, compute: str, inits=(False,)):
    """For each initialisation (``margins`` flag of ``jax_variables``),
    through one JAX step program: per step (loss, gnorm, jstat, params
    tree, opt-state dict, batch stats) of each side, and the initial
    params."""
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    jstep, out = None, {}
    for margins in inits:
        jm, v, jb = jax_variables(margins)
        tx, _ = jmake_optimizer(JConfig(), v["params"])
        if jstep is None:
            jstep = jmake_train_step(
                jm, tx, 0.0, compute_dtype=jnp.bfloat16
                if compute == "bf16" else None)
        p, o, bs = v["params"], tx.init(v["params"]), v["batch_stats"]
        rng = jax.random.key(1)
        theirs = []
        for _ in range(STEPS):
            p, o, bs, rng, loss, gn, js = jstep(p, o, bs, rng, jb)
            jo = jax.device_get(o)
            theirs.append((float(loss), float(gn), np.asarray(js),
                           dict(flat(jax.device_get(p))),
                           {k: dict(flat(getattr(jo, k)))
                            for k in ("row_var", "col_var", "v")},
                           dict(flat(jax.device_get(bs)))))
        out[margins] = (theirs, port_steps(v, compute),
                        dict(flat(v["params"])), v)
    return out


def live_names(state, tol=1e-10):
    """Tensors whose squared-gradient statistics are not numerically zero
    (the depthwise biases' gradient cancels in BatchNorm, the rotary
    placeholders have none: MaxFactor turns their rounding noise into
    full-size signed steps on either side)."""
    mx = {k: max(float(np.abs(state[s][k]).max()) for s in state)
          for k in state["row_var"]}
    top = max(mx.values())
    return [k for k, m in mx.items() if m > tol * top]


def update_agreement(ours, theirs, init, names):
    """Over the tensors ``names``: the share of elements whose update
    (new - initial) is the same on both sides within 1e-3 of its
    tensor's largest update, and the norm of the update difference over
    the norm of JAX's update."""
    same = total = 0
    d2 = n2 = 0.0
    for k in names:
        d_o, d_t = ours[k] - init[k], theirs[k] - init[k]
        tol = 1e-3 * max(float(np.abs(d_t).max()), 1e-30)
        same += int(np.sum(np.abs(d_o - d_t) <= tol))
        total += d_t.size
        d2 += float(np.sum((d_o - d_t).astype(np.float64) ** 2))
        n2 += float(np.sum(d_t.astype(np.float64) ** 2))
    return same / total, float(np.sqrt(d2 / n2))


def check_step(theirs, ours, init, n, rel_tol, share_tol, updates=True):
    """Step ``n`` of the port (``ours``) against JAX's (``theirs``), both
    ``run``'s per-step tuples, at the bounds of
    ``test_torch_train_step.py``'s docstring; without ``updates``, the
    loss, the grad norm, the jump counter and BatchNorm's statistics
    only."""
    tl, tg, tj, tp, ts, tb = theirs[n - 1]
    ol, og, oj, op, os_, ob = ours[n - 1]
    assert abs(ol - tl) <= 1e-5 * abs(tl), (ol, tl)
    assert abs(og - tg) <= 1e-4 * abs(tg), (og, tg)
    np.testing.assert_array_equal(oj, tj)
    bs_tol = 1e-5 if n == 1 else 1e-3
    for k in tb:
        scale = max(float(np.abs(tb[k]).max()), 1.0)
        assert float(np.abs(ob[k] - tb[k]).max()) <= bs_tol * scale, k
    if not updates:
        return
    names = live_names(ts)
    assert len(names) > 50
    st_tol = 1e-3 if n == 1 else 1e-2
    for key in ("row_var", "col_var", "v"):
        for k in names:
            scale = float(np.abs(ts[key][k]).max())
            if scale > 0:
                err = float(np.abs(os_[key][k] - ts[key][k]).max())
                assert err <= st_tol * scale, (key, k, err, scale)
    share, rel = update_agreement(op, tp, init, names)
    assert share >= share_tol, share
    assert rel <= rel_tol, rel


def letters_tokenizer(path) -> str:
    """Write a byte-level BPE ``tokenizer.json`` of 30 ids (PAD, BOS,
    EOS, the prefix space and a-z, no merges): the GrammarDataset
    sentences encode within a model of a few dozen tokens.  Returns the
    path."""
    import json
    vocab = {"<PAD>": 0, "<BOS>": 1, "<EOS>": 2}
    for c in "Ġabcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
    blob = {"added_tokens": [{"content": k, "id": v}
                             for k, v in list(vocab.items())[:3]],
            "normalizer": {"type": "NFKC"},
            "pre_tokenizer": {"add_prefix_space": True},
            "model": {"vocab": vocab, "merges": []}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(blob, f)
    return str(path)
