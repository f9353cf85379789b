"""The fused decode path of the port against the JAX package: each plain
version of the whole-call kernels (attention, residual MLP, router),
reached through the port's modules with their ``ModelConfig`` field on,
against the JAX module with its switch "on" (the Pallas kernel in
interpret mode) and "off" (the XLA route); the abby tail entry against
the Pallas ``fused_abby_tail`` and the XLA formula; then the slice: the
port Model with the three fields on against the JAX Model with all five
decode switches on, and the fused decode's tokens against the unfused
one's.

f32 throughout.  Modules at atol 5e-5, rtol 5e-4 (the bound
tests/test_pallas.py holds the Pallas kernels to against XLA); attention
at dims 256 / 2 heads, the smallest the gate admits (head width 128);
MLP and router at dims 128.  Model logits at atol = rtol = 2e-3
(test_pallas.py's bound for the same composition); the reading on the
CPU is 1.1e-3 at logits up to 2.3e3 (5e-7 of the largest; the JAX
Model's own two routes differ by 5.8e-4 there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asr_model_tpu.models.attention as jam
import asr_model_tpu.models.decoder as jdm
import asr_model_tpu.models.gates as jgm
import asr_model_tpu.models.norms as jnm
import asr_model_tpu.models.sheath as jsm
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JConfig
from asr_model_tpu.models.attention import Attention as JAttention
from asr_model_tpu.models.decoder import Residual as JResidual
from asr_model_tpu.models.gates import Router as JRouter
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.ops.pallas.abby_kernel import fused_abby_tail as jtail

from asr_model_tpu_torch.config import Dimensions, ModelConfig
from asr_model_tpu_torch.models.attention import Attention
from asr_model_tpu_torch.models.decoder import Residual
from asr_model_tpu_torch.models.gates import Router
from asr_model_tpu_torch.models.generate import greedy_decode
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.ops.cuda import abby
from asr_model_tpu_torch.weights import from_jax_params

TOL = dict(atol=5e-5, rtol=5e-4)
SWITCHES = ((jsm, "_PALLAS_SHEATH"), (jnm, "_PALLAS_ABBY"),
            (jam, "_PALLAS_XATTN"), (jdm, "_PALLAS_MLP"),
            (jgm, "_PALLAS_ROUTER"))


def _both(monkeypatch, mod, name, fn, *args):
    """JAX outputs of fn(*args) with the switch off (XLA) and on (Pallas,
    interpret), each traced afresh under jit (the switch is read while
    tracing)."""
    out = []
    for value in ("off", "on"):
        monkeypatch.setattr(mod, name, value)
        out.append(np.asarray(jax.jit(lambda *a: fn(*a))(*args)))
    return out


def _check(got, wants):
    for want in wants:
        np.testing.assert_allclose(got, want, **TOL)


def _engaged(name):
    """The port took the fused route (the wrapper's plain version on CPU
    tensors) exactly once since the last reset."""
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 1}


# ------------------------------------------------------------ attention

@pytest.fixture(scope="module")
def attn_pair():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 6, 256) * 0.5).astype(np.float32)
    xa = (rng.randn(2, 20, 256) * 0.5).astype(np.float32)
    jm = JAttention(dims=256, head=2, layer=2, n_type="AbbyNormal")
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(x), xa=jnp.asarray(xa)))(
            jax.random.key(3))["params"])
    tm = Attention(256, 2, "AbbyNormal", fused=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm, x, xa


@pytest.mark.parametrize("masked", [False, True])
def test_fused_attn_cached_matches_jax(attn_pair, masked, monkeypatch):
    jm, v, tm, x, xa = attn_pair
    valid = np.arange(20)[None, :] < np.array([[15], [20]])
    jvalid = jnp.asarray(valid) if masked else None
    kv = jax.jit(lambda v, xa: jm.apply(
        v, xa, method=JAttention.precompute_kv))(v, jnp.asarray(xa))
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, kv, m: jm.apply(v, x, cached_kv=kv,
                                               kv_valid=m),
                  v, jnp.asarray(x), kv, jvalid)
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), cached_kv=tm.precompute_kv(
        torch.from_numpy(xa)), kv_valid=torch.from_numpy(valid) if masked
        else None)
    _engaged("fused_attn_cached")
    _check(got.numpy(), wants)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attn_full_self_matches_jax(attn_pair, causal, monkeypatch):
    jm, v, tm, x, _ = attn_pair
    valid = np.arange(6)[None, :] < np.array([[4], [6]])
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, m: jm.apply(v, x, causal=causal, kv_valid=m),
                  v, jnp.asarray(x), jnp.asarray(valid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), causal=causal,
             kv_valid=torch.from_numpy(valid))
    _engaged("fused_attn_full")
    _check(got.numpy(), wants)


def test_fused_attn_full_cross_matches_jax(attn_pair, monkeypatch):
    jm, v, tm, x, xa = attn_pair
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, xa: jm.apply(v, x, xa=xa),
                  v, jnp.asarray(x), jnp.asarray(xa))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), xa=torch.from_numpy(xa))
    _engaged("fused_attn_full")
    _check(got.numpy(), wants)


# ---------------------------------------------------------- residual MLP

@pytest.fixture(scope="module")
def mlp_pair():
    rng = np.random.RandomState(7)
    jm = JResidual(dims=128, head=1, layer=2, act="gelu",
                   n_type="AbbyNormal")
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.zeros((1, 4, 128), jnp.float32)))(
            jax.random.key(0))["params"])
    tm = Residual(128, 1, 2, "gelu", "AbbyNormal", fused_mlp=True,
                  device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm, rng


def _jax_mlp_tail(mdl, x):
    """The last line of the JAX Residual.__call__: its gate, then the
    fused kernel or the XLA MLP."""
    if mdl._mlp_fused_eligible(x):
        return mdl._mlp_residual_fused(x)
    return x + mdl._mlp(x)


# N = 12 rows (one Pallas block) and 1600 rows (N * D past the Pallas
# single-block budget: a row grid with a partial block)
@pytest.mark.parametrize("shape", [(2, 6, 128), (4, 400, 128)])
def test_fused_mlp_residual_matches_jax(mlp_pair, shape, monkeypatch):
    jm, v, tm, rng = mlp_pair
    x = (rng.randn(*shape) * 0.5).astype(np.float32)
    wants = _both(monkeypatch, jdm, "_PALLAS_MLP",
                  lambda v, x: jm.apply(v, x, method=_jax_mlp_tail),
                  v, jnp.asarray(x))
    kernels.reset_counts()
    tx = torch.from_numpy(x)
    assert tm._mlp_fused_ok(tx)
    got = tm._mlp_residual_fused(tx)
    _engaged("fused_mlp_residual")
    _check(got.numpy(), wants)


# ---------------------------------------------------------------- router

@pytest.mark.parametrize("n_mod", [1, 3])
def test_fused_router_matches_jax(n_mod, monkeypatch):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 128).astype(np.float32)
    jm = JRouter(dims=128, num_types=3)
    jx = jnp.asarray(x)
    params = jax.device_get(jm.init({"params": jax.random.key(0)},
                                    *(jx,) * n_mod)["params"])
    wants = _both(monkeypatch, jgm, "_PALLAS_ROUTER",
                  lambda p, x: jm.apply({"params": p}, *(x,) * n_mod),
                  params, jx)
    tm = Router(128, 3, n_mod, fused=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    tx = torch.from_numpy(x)
    kernels.reset_counts()
    got = tm(*(tx,) * n_mod)
    _engaged("fused_router_same")
    _check(got.numpy(), wants)
    if n_mod > 1:               # distinct modalities: the module route
        kernels.reset_counts()
        tm(*(tx,) * (n_mod - 1), tx.clone())
        assert kernels.counts()["fused_router_same"]["plain_calls"] == 0


# ---------------------------------------------------- the abby tail alone

def test_fused_abby_tail_matches_jax():
    """At test_pallas.py's short-wide shape (250, 2048): against the
    Pallas kernel in interpret mode and against its XLA formula."""
    from asr_model_tpu.models.norms import window_reduce_last
    rng = np.random.RandomState(3)
    n, d = 250, 2048
    x = rng.randn(n, d).astype(np.float32)
    lg = rng.randn(n, 3).astype(np.float32)
    size = abby.window_size(d)
    jx, jl = jnp.asarray(x), jnp.asarray(lg)
    pallas = np.asarray(jtail(jx, jl, size=size, alpha=1e-4, k=1.0,
                              beta=0.75, interpret=True))
    div = jx * jx
    mean_val = jnp.mean(jnp.abs(jx), axis=-1, keepdims=True)
    cv = jnp.std(jx, axis=-1, keepdims=True, ddof=1) / (mean_val + 1e-6)
    choice = jnp.argmax(jl + cv, axis=-1, keepdims=True)
    avg_d = window_reduce_last(div, size, "mean")
    max_d = window_reduce_last(div, size, "max")
    div2 = jnp.where(max_d > 2.0 * avg_d, max_d, avg_d)
    mix = jnp.where(choice == 1, div2, avg_d)
    xla = np.asarray(jx / (mix * 1e-4 + 1.0) ** 0.75)
    kernels.reset_counts()
    got = abby.fused_abby_tail(torch.from_numpy(x), torch.from_numpy(lg),
                               size, 1e-4, 1.0, 0.75).numpy()
    _engaged("fused_abby_tail")
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------- the slice

KW = dict(tokens=96, mels=8, dims=256, head=2, layer=2)
FUSED = ModelConfig(fused_attention=True, fused_mlp=True, fused_router=True)


@pytest.fixture(scope="module")
def model_pair():
    """test_pallas.py's composition config (dims 256, 2 heads, 2
    layers); the learned positions redrawn from N(0, 10^2) so a greedy
    decode emits varied tokens."""
    rng = np.random.RandomState(11)
    ids = rng.randint(3, 96, (2, 5))
    feats = dict(spectrogram=rng.randn(2, 8, 12).astype(np.float32),
                 pitch=rng.rand(2, 1, 12).astype(np.float32),
                 waveform=rng.randn(2, 1, 12).astype(np.float32))
    jm = JModel(param=JDims(**KW), cfg=JConfig(dims=JDims(**KW)))
    variables = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(ids, jnp.int32),
        **{k: jnp.asarray(v) for k, v in feats.items()}))(
            jax.random.key(0)))
    pos = variables["params"]["processor"]["position"]
    variables["params"]["processor"]["position"] = 10.0 * rng.randn(
        *pos.shape).astype(np.float32)
    sd = from_jax_params(variables["params"], variables.get("batch_stats"))
    return jm, variables, sd, ids, feats


def _port(sd, cfg=None):
    m = Model(Dimensions(**KW), cfg, device="cpu")
    m.load_state_dict(sd, strict=True)
    return m


def test_fused_model_matches_jax_all_switches_on(model_pair, monkeypatch):
    jm, variables, sd, ids, feats = model_pair
    for mod, name in SWITCHES:
        monkeypatch.setattr(mod, name, "on")
    want = np.asarray(jax.jit(lambda v: jm.apply(
        v, jnp.asarray(ids, jnp.int32),
        **{k: jnp.asarray(x) for k, x in feats.items()})["logits"])(
            jax.tree.map(jnp.asarray, variables)))
    kernels.reset_counts()
    got = _port(sd, FUSED)(torch.from_numpy(ids),
                           **{k: torch.from_numpy(v)
                              for k, v in feats.items()})["logits"]
    c = kernels.counts()
    assert all(c[n]["plain_calls"] > 0 for n in kernels.FUSED_ONLY), c
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def test_fused_decode_tokens_match_unfused(model_pair):
    _, _, sd, _, feats = model_pair
    feats = {k: torch.from_numpy(v) for k, v in feats.items()}
    want = greedy_decode(_port(sd), max_new_tokens=8, **feats)
    kernels.reset_counts()
    got = greedy_decode(_port(sd, FUSED), max_new_tokens=8, **feats)
    c = kernels.counts()
    assert all(c[n]["plain_calls"] > 0 for n in kernels.FUSED_ONLY), c
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    assert got.tolist() == want.tolist()


def test_fused_fields_keep_the_state_dict(model_pair):
    _, _, sd, _, _ = model_pair
    on, off = _port(sd, FUSED), _port(sd)
    assert on.state_dict().keys() == off.state_dict().keys() == sd.keys()
