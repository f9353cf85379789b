"""Train-mode pieces of the port against the JAX package, forward and
backward, on the CPU at tiny sizes: the straight-through gumbel-softmax
and threshold, AbbyNormal's train route (an all-zero row included),
BatchNorm's batch statistics and running update, the depthwise
convolution's gradient, the signal-adaptive rotary at a zero
conditioning row, the masked attention's gradient, and MSheath's keyed
scan with the same per-slot noise on both sides.

The same noise reaches both packages: ``jax.random.gumbel`` and the
port's ``stochastic.sample_gumbel`` are replaced by one queue of numpy
draws, taken in call order.  Tolerance: f32, 1e-5 relative to each
tensor's largest magnitude (the gradients too); integer outputs
(actions, jump counters) exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.models import attention as jattention
from asr_model_tpu.models import norms as jnorms
from asr_model_tpu.models import rotary as jrotary
from asr_model_tpu.models import stochastic as jstochastic
from asr_model_tpu.models import tlayers as jtlayers
from asr_model_tpu.models.sheath import MSheath as JMSheath

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.norms import AbbyNormal, BatchNorm1d
from asr_model_tpu_torch.models.rotary import Rotary
from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.models.tlayers import dwconv_same
from asr_model_tpu_torch.ops.cuda.attention import attention_plain
from asr_model_tpu_torch.weights import from_jax_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs files
    in parallel worker processes, and PyTorch's thread pools in each of
    them oversubscribe the cores (a test here ran 47x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= TOL * scale, (what, err, scale)


class Noise:
    """One queue of gumbel draws served to both packages in call order."""

    def __init__(self, monkeypatch, seed=0):
        self.rs = np.random.RandomState(seed)
        self.jq, self.tq = [], []
        monkeypatch.setattr(jax.random, "gumbel", self._jax)
        monkeypatch.setattr(stochastic, "sample_gumbel", self._torch)

    def _jax(self, key, shape, dtype=jnp.float32):
        g = self.rs.gumbel(size=shape).astype(np.float32)
        self.tq.append(g)
        return jnp.asarray(g, dtype)

    def _torch(self, shape, gen, dtype=torch.float32):
        return torch.from_numpy(self.tq.pop(0)).to(dtype).reshape(shape)


def gen():
    return torch.Generator().manual_seed(0)


def test_gumbel_softmax_and_ste_match_jax(monkeypatch):
    noise = Noise(monkeypatch)
    rs = np.random.RandomState(1)
    logits = rs.randn(5, 3).astype(np.float32)
    w = rs.randn(5, 3).astype(np.float32)

    def jf(lg, key):
        return jnp.sum(jstochastic.gumbel_softmax(key, lg) * w)

    for key in (jax.random.key(0), None):
        jv, jg = jax.value_and_grad(jf)(jnp.asarray(logits), key)
        t = torch.from_numpy(logits).requires_grad_(True)
        n = None if key is None else stochastic.sample_gumbel(
            t.shape, gen())
        tv = (stochastic.gumbel_softmax(t, n) * torch.from_numpy(w)).sum()
        tv.backward()
        close(tv, jv, "gumbel value")
        close(t.grad, jg, "gumbel grad")
    assert not noise.tq

    x = rs.randn(4, 6).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda a: jnp.sum(jstochastic.ste_threshold(a, 0.3) * w[:4, :3].sum()
                          ))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = (stochastic.ste_threshold(t, 0.3) * float(w[:4, :3].sum())).sum()
    tv.backward()
    close(tv, jv, "ste value")
    close(t.grad, jg, "ste grad (identity)")


@pytest.mark.parametrize("noisy", [True, False])
def test_abby_train_route_matches_jax(monkeypatch, noisy):
    """An all-zero row (MoE capacity overflow's) keeps finite gradients:
    the std has a zero gradient at var == 0, as in the JAX package
    (the unguarded sqrt(var)'s backward is NaN there)."""
    Noise(monkeypatch)
    d = 32
    rs = np.random.RandomState(2)
    x = rs.randn(3, 5, d).astype(np.float32)
    x[1, 2] = 0.0
    w = rs.randn(3, 5, d).astype(np.float32)
    jm = jnorms.AbbyNormal(dims=d)
    params = jm.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"]
    rngs = {"gumbel": jax.random.key(1)} if noisy else {}

    def jf(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, rngs=rngs) * w)

    jv, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(
        params, jnp.asarray(x))
    tm = AbbyNormal(d, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    tm.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    with stochastic.mode(train=True, gen=gen() if noisy else None):
        tv = (tm(tx) * torch.from_numpy(w)).sum()
    tv.backward()
    close(tv, jv, "value")
    close(tx.grad, jgx, "dx")
    want = from_jax_params(jax.device_get(jgp))
    for name, p in tm.named_parameters():
        close(p.grad, want[name].numpy(), name)
    assert torch.isfinite(tx.grad[1, 2]).all()
    # the unguarded std is the fault this route closes
    z = torch.zeros(1, d, requires_grad=True)
    torch.sqrt(torch.var(z, dim=-1)).sum().backward()
    assert not torch.isfinite(z.grad).all()


def test_batchnorm_train_matches_flax():
    """Batch statistics in the forward; the running update with flax's
    momentum 0.9 and the BIASED batch variance (torch's own BatchNorm
    updates with the unbiased one)."""
    rs = np.random.RandomState(3)
    c = 8
    x = (rs.randn(2, 7, c) * 2 + 0.5).astype(np.float32)
    w = rs.randn(2, 7, c).astype(np.float32)
    jm = jnorms.BatchNorm1d(dims=c)
    variables = jm.init(jax.random.key(0), jnp.asarray(x),
                        use_running_average=False)
    params = {"params": {"scale": jnp.asarray(rs.rand(c) + 0.5,
                                               jnp.float32),
                         "bias": jnp.asarray(rs.randn(c), jnp.float32)}}
    stats = {"mean": jnp.asarray(rs.randn(c), jnp.float32),
             "var": jnp.asarray(rs.rand(c) + 0.5, jnp.float32)}
    p = params["params"]

    def jf(pp, xx):
        out, mut = jm.apply({"params": {"BatchNorm_0": pp},
                             "batch_stats": {"BatchNorm_0": stats}}, xx,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"]["BatchNorm_0"])

    assert "BatchNorm_0" in variables["params"]
    (jv, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    bn = BatchNorm1d(c, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(p["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
    bn.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    with stochastic.mode(train=True) as rec:
        out = bn(tx)
        new = rec.batch_stats[bn]
    (out * torch.from_numpy(w)).sum().backward()
    close(out, jout, "out")
    close(new[0], jstats["mean"], "running_mean")
    close(new[1], jstats["var"], "running_var")
    close(tx.grad, jgx, "dx")
    close(bn.weight.grad, jgp["scale"], "dscale")
    close(bn.bias.grad, jgp["bias"], "dbias")
    # torch's own update (unbiased variance) is another number
    rv = torch.from_numpy(np.asarray(stats["var"])).clone()
    torch.nn.functional.batch_norm(
        torch.from_numpy(x).reshape(-1, c), torch.zeros(c), rv,
        training=True, momentum=0.1)
    assert not np.allclose(rv.numpy(), np.asarray(jstats["var"]), rtol=1e-6)


def test_dwconv_same_gradient_matches_jax():
    rs = np.random.RandomState(4)
    b, t, c, k = 2, 11, 6, 5
    x = rs.randn(b, t, c).astype(np.float32)
    kern = rs.randn(k, 1, c).astype(np.float32)
    w = rs.randn(b, t, c).astype(np.float32)
    jv, (jgx, jgk) = jax.value_and_grad(
        lambda xx, kk: jnp.sum(jtlayers.dwconv_same(xx, kk) * w),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kern))
    tx = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_(True)
    tk = torch.from_numpy(kern.transpose(2, 1, 0).copy()).requires_grad_(True)
    tv = (dwconv_same(tx, tk) * torch.from_numpy(
        w.transpose(0, 2, 1).copy())).sum()
    tv.backward()
    close(tv, jv, "value")
    close(tx.grad.permute(0, 2, 1), jgx, "dx")
    close(tk.grad.permute(2, 1, 0), jgk, "dkernel")


def test_rotary_gradient_at_zero_condition_matches_jax():
    """The safe norm: a zero conditioning row has a defined (zero)
    gradient, not NaN."""
    rs = np.random.RandomState(5)
    dims, head, b, t = 16, 2, 2, 5
    x = rs.randn(b, head, t, dims // head).astype(np.float32)
    cond = rs.randn(b, t, dims).astype(np.float32)
    cond[0, 1] = 0.0
    w = rs.randn(*x.shape).astype(np.float32)
    jm = jrotary.Rotary(dims=dims, head=head)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond),
                     False)

    def jf(xx, cc):
        return jnp.sum(jm.apply(params, xx, cc, False) * w)

    jv, (jgx, jgc) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(cond))
    rot = Rotary(dims, head, device="cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(cond).requires_grad_(True)
    (rot(tx, tc, causal=False) * torch.from_numpy(w)).sum().backward()
    close(tx.grad, jgx, "dx")
    close(tc.grad, jgc, "dcond")
    assert torch.all(tc.grad[0, 1] == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_gradient_matches_jax(causal):
    rs = np.random.RandomState(6)
    q = rs.randn(2, 2, 5, 8).astype(np.float32)
    k = rs.randn(2, 2, 7, 8).astype(np.float32)
    v = rs.randn(2, 2, 7, 8).astype(np.float32)
    w = rs.randn(2, 2, 5, 8).astype(np.float32)
    valid = np.array([[1] * 7, [1, 1, 1, 0, 0, 0, 0]], bool)
    scale = 1 / np.sqrt(8)
    jg = jax.grad(lambda a, b_, c: jnp.sum(jattention._sdpa_xla(
        a, b_, c, causal, jnp.asarray(valid), None, scale) * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (attention_plain(*ts, causal=causal, kv_valid=torch.from_numpy(valid),
                     scale=scale) * torch.from_numpy(w)).sum().backward()
    for t, g, n in zip(ts, jg, "qkv"):
        close(t.grad, g, "d" + n)


B, T, D, L = 2, 6, 32, 4
VALID = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool)


@pytest.fixture(scope="module")
def sheath_pair():
    x = np.random.RandomState(7).randn(B, T, D).astype(np.float32)
    jm = JMSheath(dims=D, head=2, layer=L)
    params = jax.device_get(
        jm.init({"params": jax.random.key(0)}, jnp.asarray(x))["params"])
    return jm, params, x


@pytest.mark.parametrize("use_valid,scale,streaming",
                         [(False, 1.0, False), (True, 1.0, False),
                          (False, 0.05, False), (False, 1.0, True)])
def test_msheath_keyed_scan_matches_jax(monkeypatch, sheath_pair,
                                        use_valid, scale, streaming):
    """Per-slot gumbel draws (the same on both sides), the STE mask,
    the straight-through jump gate: output, actions, jump counter and
    the gradients of x and every parameter.  JAX draws inside its scan
    from the slot's key, so there the L keys become the slot indices
    (``jax.random.split`` into L) and a draw reads its row of the table;
    the port takes the rows in slot order."""
    table = np.random.RandomState(int(scale * 10) + use_valid).gumbel(
        size=(L, 3)).astype(np.float32)
    split = jax.random.split
    monkeypatch.setattr(jax.random, "split", lambda key, num=2: (
        jnp.arange(num) if num == L else split(key, num)))
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype: (
        jnp.asarray(table, dtype)[key]))
    rows = list(table)
    monkeypatch.setattr(stochastic, "sample_gumbel", lambda shape, g, dt: (
        torch.from_numpy(rows.pop(0)).to(dt)))
    jm, params, x = sheath_pair
    x = x * scale
    w = np.random.RandomState(8).randn(B, T, D).astype(np.float32)
    valid = VALID if use_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)

    def jf(p, xx):
        out, aux = jm.apply({"params": p}, xx, jvalid, streaming=streaming,
                            rngs={"gumbel": jax.random.key(3)})
        return jnp.sum(out * w), aux

    (jv, aux_w), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tm = MSheath(D, 2, L, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    tm.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    with stochastic.mode(train=True, gen=gen()) as rec:
        out, aux_g = tm(tx, None if valid is None else torch.from_numpy(
            valid), streaming=streaming)
        jstat = rec.jstat
    (out * torch.from_numpy(w)).sum().backward()
    assert not rows
    np.testing.assert_array_equal(aux_g["actions"].numpy(),
                                  np.asarray(aux_w["actions"]))
    np.testing.assert_array_equal(jstat.numpy(), np.asarray(aux_w["jstat"]))
    close((out * torch.from_numpy(w)).sum(), jv, "value")
    close(tx.grad, jgx, "dx")
    want = from_jax_params(jax.device_get(jgp))
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if float(np.abs(want[name].numpy()).max()) == 0.0:
            assert float(g.abs().max()) == 0.0, name
        else:
            close(g, want[name].numpy(), name)
