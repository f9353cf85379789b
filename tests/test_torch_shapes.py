"""The port at the shapes its kernels were widened to take, on the CPU:
each plain version against the JAX package there, and the port's fused
gates against the JAX gates.

* MSheath at B = 80 (more batch rows than one pass of the kernel's
  memory EMA): the port's module against the JAX module with its Pallas
  switch "on" (interpret) and "off" (the XLA scan), f32 at 1e-5 as
  tests/test_torch_sheath.py holds it; actions and jstat exactly.
* The cached call against more than 1024 keys, and both whole calls at
  head width 256, through the port's ``Attention`` with ``fused`` on
  against the JAX module with PALLAS_XATTN "on" and "off", f32 at atol
  5e-5, rtol 5e-4 (tests/test_torch_fused.py's bound).
* The plain mel at Whisper's n_fft 400 and at 256 mels against the JAX
  mel (XLA and the Pallas kernel in interpret mode), 2e-3 as
  tests/test_torch_ops.py holds it; Bluestein's tables against numpy.
* Past D 2048, head width 256, n_fft 64..4096 and 8 types, at a few
  rows: the plain AbbyNormal and MSheath at D 2304, both whole calls at
  head width 384, the plain mel at n_fft 48, 4097 and 8192, the router
  at 12 types (ties to the first occurrence) and the tail at D 4608,
  each against the JAX package (the Pallas kernel in interpret mode and
  the XLA route), f32 at the bounds above (the AbbyNormal, router and
  tail at atol 2e-5, rtol 1e-4: test_torch_fused.py's).
* Past the shared-memory plans, at the two limits a config reaches:
  head width 2048 (the plain flash version and both whole calls at one
  head of 2048) and 16 TGate types (the residual MLP), each against the
  JAX package's XLA route, f32 at the bounds above.
* The gates: on a grid of (D, heads, B, T, Tk, dtype) up to D 4096 and
  head width 512, the port's ``Attention._fused_ok``,
  ``Residual._mlp_fused_ok`` (up to 12 gates) and ``Router._fused_ok``
  (up to 12 types) decide as the JAX gates do, and every shape they
  admit lies within the kernels' widths (``xattn.supports``,
  ``mlp.supports``, ``router.supports``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asr_model_tpu.models.attention as jam
import asr_model_tpu.models.decoder as jdm
import asr_model_tpu.models.gates as jgm
import asr_model_tpu.models.sheath as jsm
from asr_model_tpu.models.attention import Attention as JAttention
from asr_model_tpu.models.decoder import Residual as JResidual
from asr_model_tpu.models.gates import Router as JRouter
from asr_model_tpu.models.sheath import MSheath as JMSheath
from asr_model_tpu.ops import mel as jmel
from asr_model_tpu.ops.pallas.abby_kernel import (abby_full_compute,
                                                  abby_tail_compute)
from asr_model_tpu.ops.pallas.abby_kernel import fused_abby as jabby
from asr_model_tpu.ops.pallas.abby_kernel import fused_abby_tail as jtail
from asr_model_tpu.ops.pallas.mel_kernel import pallas_mel_spectrogram

from asr_model_tpu_torch.models.attention import (KV_LIMIT_CACHED,
                                                  KV_LIMIT_FULL, Attention)
from asr_model_tpu_torch.models.decoder import Residual
from asr_model_tpu_torch.models.gates import Router, _topk_hard
from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.ops import mel
from asr_model_tpu_torch.ops.cuda import mel as kmel
from asr_model_tpu_torch.ops.cuda import abby, mlp, router, xattn
from asr_model_tpu_torch.weights import from_jax_params

TOL = dict(atol=5e-5, rtol=5e-4)


def _both(monkeypatch, mod, name, fn, *args):
    """JAX outputs of fn(*args) with the switch off (XLA) and on (Pallas,
    interpret), each traced afresh under jit."""
    out = []
    for value in ("off", "on"):
        monkeypatch.setattr(mod, name, value)
        out.append(jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda *a: fn(*a))(*args)))
    return out


# ------------------------------------------------------- MSheath, B = 80

def test_msheath_batch_80_matches_jax(monkeypatch):
    b, t, d, layers = 80, 3, 128, 4
    rng = np.random.RandomState(5)
    x = (rng.randn(b, t, d) * 0.3).astype(np.float32)
    valid = np.arange(t)[None, :] < (1 + np.arange(b) % t)[:, None]
    jm = JMSheath(dims=d, head=2, layer=layers)
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(x)))(jax.random.key(6))["params"])
    tm = MSheath(d, 2, layers, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    wants = _both(monkeypatch, jsm, "_PALLAS_SHEATH",
                  lambda p, x, m: jm.apply({"params": p}, x, m), params,
                  jnp.asarray(x), jnp.asarray(valid))
    kernels.reset_counts()
    got, aux = tm(torch.from_numpy(x), torch.from_numpy(valid))
    assert kernels.counts()["fused_sheath_scan"]["plain_calls"] == 1
    for want, aux_w in wants:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(aux["actions"].numpy(),
                                      aux_w["actions"])
        np.testing.assert_array_equal(aux["jstat"].numpy(), aux_w["jstat"])


# ------------------------------------- attention: long caches, hd 256

def _attn_pair(dims, head, t, ta, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, t, dims) * 0.5).astype(np.float32)
    xa = (rng.randn(2, ta, dims) * 0.5).astype(np.float32)
    jm = JAttention(dims=dims, head=head, layer=2, n_type="AbbyNormal")
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(x), xa=jnp.asarray(xa)))(
            jax.random.key(seed))["params"])
    tm = Attention(dims, head, "AbbyNormal", fused=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm, x, xa


def _engaged(name):
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 1}


# (dims, heads, query width, cached keys): more keys than one CTA's
# scores held before (1100 > 1024), and head width 256
@pytest.mark.parametrize("dims,head,t,ta", [(256, 2, 3, 1100),
                                            (256, 1, 5, 40)])
def test_fused_attn_cached_matches_jax(dims, head, t, ta, monkeypatch):
    jm, v, tm, x, xa = _attn_pair(dims, head, t, ta, 7)
    valid = np.arange(ta)[None, :] < np.array([[ta - 7], [ta]])
    kv = jax.jit(lambda v, xa: jm.apply(
        v, xa, method=JAttention.precompute_kv))(v, jnp.asarray(xa))
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, kv, m: jm.apply(v, x, cached_kv=kv,
                                               kv_valid=m),
                  v, jnp.asarray(x), kv, jnp.asarray(valid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), cached_kv=tm.precompute_kv(
        torch.from_numpy(xa)), kv_valid=torch.from_numpy(valid))
    _engaged("fused_attn_cached")
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attn_full_hd256_matches_jax(causal, monkeypatch):
    jm, v, tm, x, _ = _attn_pair(256, 1, 6, 6, 8)
    valid = np.arange(6)[None, :] < np.array([[4], [6]])
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, m: jm.apply(v, x, causal=causal, kv_valid=m),
                  v, jnp.asarray(x), jnp.asarray(valid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), causal=causal,
             kv_valid=torch.from_numpy(valid))
    _engaged("fused_attn_full")
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# ----------------------------------------------------------------- mel

@pytest.mark.parametrize("n_fft,n_mels", [(400, 80), (1024, 256)])
def test_plain_mel_matches_jax_other_sizes(n_fft, n_mels):
    audio = np.random.RandomState(9).randn(8000).astype(np.float32)
    kw = dict(n_fft=n_fft, n_mels=n_mels, hop_length=160)
    got = kmel.mel_spectrogram_plain(torch.from_numpy(audio)[None],
                                     **kw)[0].numpy()
    for want in (jmel.mel_spectrogram(jnp.asarray(audio), **kw),
                 pallas_mel_spectrogram(jnp.asarray(audio), interpret=True,
                                        **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("n_fft", [64, 400, 401, 1000, 4095])
def test_bluestein_tables_give_the_rfft_power(n_fft):
    """The kernel's arithmetic on its tables (in float64 here): the
    chirped frame's L-point FFT times bf, inverse-transformed, gives the
    windowed frame's rfft power within f32 table rounding."""
    wc, bf, tw = kmel.bluestein_tables(n_fft)
    n_len = kmel.bluestein_len(n_fft)
    assert n_len >= 2 * n_fft - 1 and n_len & (n_len - 1) == 0
    z = lambda a: a[..., 0].astype(np.float64) + 1j * a[..., 1]
    np.testing.assert_allclose(
        z(tw), np.exp(-2j * np.pi * np.arange(n_len // 2) / n_len),
        atol=1e-7)
    x = np.random.RandomState(n_fft).randn(n_fft)
    a = np.zeros(n_len, complex)
    a[:n_fft] = x * z(wc)
    c = np.fft.ifft(np.fft.fft(a) * z(bf)) * n_len
    want = np.abs(np.fft.rfft(x * mel.hann_window(n_fft))) ** 2
    got = np.abs(c[:n_fft // 2 + 1]) ** 2
    assert np.max(np.abs(got - want)) <= 1e-6 * want.max()


# ------------------------------------- past D 2048, head width 256, ...

AKW = dict(size=abby.window_size(2304), alpha=1e-4, k=1.0, beta=0.75)
FTOL = dict(atol=2e-5, rtol=1e-4)


def test_plain_abby_d2304_matches_jax():
    """The plain AbbyNormal at (4, 2304) (a 115-tap window) against the
    Pallas kernel (interpret) and its XLA formula; flax (in, out)
    weights there, torch (out, in) here."""
    rng = np.random.RandomState(21)
    n, d = 4, 2304
    x = (rng.randn(n, d) * 2).astype(np.float32)
    w1 = (rng.randn(d, d) * d ** -0.5).astype(np.float32)
    b1 = (rng.randn(d) * 0.1).astype(np.float32)
    w2 = (rng.randn(d, 3) * d ** -0.5).astype(np.float32)
    b2 = (rng.randn(3) * 0.1).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    wants = [np.asarray(jabby(*j, interpret=True, **AKW)),
             np.asarray(abby_full_compute(*j, **AKW))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = abby.abby_plain(t(x), t(w1.T), t(b1), t(w2.T), t(b2),
                          *AKW.values()).numpy()
    for want in wants:
        np.testing.assert_allclose(got, want, **FTOL)


def test_plain_abby_tail_d4608_matches_jax():
    """The tail alone at (4, 4608) (a 229-tap window) against the Pallas
    tail (interpret) and its XLA formula."""
    rng = np.random.RandomState(22)
    n, d = 4, 4608
    x = (rng.randn(n, d) * 2).astype(np.float32)
    lg = rng.randn(n, 3).astype(np.float32)
    kw = dict(AKW, size=abby.window_size(d))
    wants = [np.asarray(jtail(jnp.asarray(x), jnp.asarray(lg),
                              interpret=True, **kw)),
             np.asarray(abby_tail_compute(jnp.asarray(x), jnp.asarray(lg),
                                          **kw))]
    got = abby.abby_tail_plain(torch.from_numpy(x), torch.from_numpy(lg),
                               *kw.values()).numpy()
    for want in wants:
        np.testing.assert_allclose(got, want, **FTOL)


def test_msheath_d2304_matches_jax(monkeypatch):
    """MSheath at D 2304 (two batch rows of two frames) against the JAX
    module with its Pallas switch "on" (interpret) and "off"."""
    b, t, d, layers = 2, 2, 2304, 4
    rng = np.random.RandomState(23)
    x = (rng.randn(b, t, d) * 0.3).astype(np.float32)
    valid = np.array([[True, True], [True, False]])
    jm = JMSheath(dims=d, head=18, layer=layers)
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(x)))(jax.random.key(24))["params"])
    tm = MSheath(d, 18, layers, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    wants = _both(monkeypatch, jsm, "_PALLAS_SHEATH",
                  lambda p, x, m: jm.apply({"params": p}, x, m), params,
                  jnp.asarray(x), jnp.asarray(valid))
    kernels.reset_counts()
    got, aux = tm(torch.from_numpy(x), torch.from_numpy(valid))
    assert kernels.counts()["fused_sheath_scan"]["plain_calls"] == 1
    for want, aux_w in wants:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(aux["actions"].numpy(),
                                      aux_w["actions"])


def test_fused_attn_hd384_matches_jax(monkeypatch):
    """Both whole calls at one head of 384 (the wide route's width): the
    cached call against 40 keys, the full call causal with a mask."""
    jm, v, tm, x, xa = _attn_pair(384, 1, 3, 40, 25)
    valid = np.arange(40)[None, :] < np.array([[33], [40]])
    kv = jax.jit(lambda v, xa: jm.apply(
        v, xa, method=JAttention.precompute_kv))(v, jnp.asarray(xa))
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, kv, m: jm.apply(v, x, cached_kv=kv,
                                               kv_valid=m),
                  v, jnp.asarray(x), kv, jnp.asarray(valid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), cached_kv=tm.precompute_kv(
        torch.from_numpy(xa)), kv_valid=torch.from_numpy(valid))
    _engaged("fused_attn_cached")
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    fvalid = np.array([[True, True, False], [True, True, True]])
    wants = _both(monkeypatch, jam, "_PALLAS_XATTN",
                  lambda v, x, m: jm.apply(v, x, causal=True, kv_valid=m),
                  v, jnp.asarray(x), jnp.asarray(fvalid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), causal=True,
             kv_valid=torch.from_numpy(fvalid))
    _engaged("fused_attn_full")
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------- past the shared-memory plans

def _xla(monkeypatch, mod, name, fn, *args):
    """JAX outputs of fn(*args) with the Pallas switch off (XLA)."""
    monkeypatch.setattr(mod, name, "off")
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_hd2048_matches_jax(causal):
    """The plain version of flash (the global route's oracle) at head
    width 2048 against the JAX package's sdpa (the XLA route), with a
    fully masked batch row."""
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(2, 1, t, 2048).astype(np.float32) * 0.1
               for t in (7, 19, 19))
    valid = np.arange(19)[None, :] < np.array([[19], [0]])
    want = np.asarray(jax.jit(lambda q, k, v, m: jam.sdpa(
        q, k, v, causal=causal, kv_valid=m))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid)))
    got = kernels.attention.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_attn_hd2048_matches_jax(monkeypatch):
    """Both whole calls at one head of 2048 (past the wide route's 1024:
    the global route's plain versions) against the JAX module's XLA
    route: the cached call against 20 keys, the full call causal."""
    jm, v, tm, x, xa = _attn_pair(2048, 1, 2, 20, 13)
    valid = np.arange(20)[None, :] < np.array([[11], [20]])
    kv = jax.jit(lambda v, xa: jm.apply(
        v, xa, method=JAttention.precompute_kv))(v, jnp.asarray(xa))
    want = _xla(monkeypatch, jam, "_PALLAS_XATTN",
                lambda v, x, kv, m: jm.apply(v, x, cached_kv=kv, kv_valid=m),
                v, jnp.asarray(x), kv, jnp.asarray(valid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), cached_kv=tm.precompute_kv(
        torch.from_numpy(xa)), kv_valid=torch.from_numpy(valid))
    _engaged("fused_attn_cached")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert xattn.launch_plan_cached(2, 2, 20, 2048, torch.bfloat16, True,
                                    132, 1)["route"] == "global"
    fvalid = np.array([[True, False], [True, True]])
    want = _xla(monkeypatch, jam, "_PALLAS_XATTN",
                lambda v, x, m: jm.apply(v, x, causal=True, kv_valid=m),
                v, jnp.asarray(x), jnp.asarray(fvalid))
    kernels.reset_counts()
    got = tm(torch.from_numpy(x), causal=True,
             kv_valid=torch.from_numpy(fvalid))
    _engaged("fused_attn_full")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_mlp_16_types_matches_jax(monkeypatch):
    """The residual MLP at 16 TGate types (past the gates' launch's 12:
    the types route's plain version) against ``Residual._mlp`` at the
    same ``num_types`` (the XLA route)."""
    d, nt = 128, 16
    rng = np.random.RandomState(14)
    jm = JResidual(dims=d, head=1, layer=2, act="gelu", n_type="AbbyNormal",
                   num_types=nt)
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.zeros((1, 4, d), jnp.float32)))(
            jax.random.key(3))["params"])
    tm = Residual(d, 1, 2, "gelu", "AbbyNormal", num_types=nt,
                  fused_mlp=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    x = (rng.randn(2, 9, d) * 0.5).astype(np.float32)
    want = _xla(monkeypatch, jdm, "_PALLAS_MLP",
                lambda v, x: jm.apply(v, x, method=lambda m, x:
                                      x + m._mlp(x)),
                {"params": params}, jnp.asarray(x))
    kernels.reset_counts()
    tx = torch.from_numpy(x)
    assert tm._mlp_fused_ok(tx)
    got = tm._mlp_residual_fused(tx)
    _engaged("fused_mlp_residual")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert mlp.launch_plan(18, d, nt * d, torch.bfloat16, nt)["types"] == \
        "many"


@pytest.mark.parametrize("n_fft", [48, 4097, 8192])
def test_plain_mel_matches_jax_direct_dft_sizes(n_fft):
    """The sizes the direct-DFT kernel takes: below 64, odd past 4096, a
    power of two past 4096.  At an odd n_fft the port frames as
    torch.stft and the JAX package's XLA mel do (n_fft // 2 zeros a side:
    1 + (N - 1) // hop frames) and its Pallas kernel has one frame more;
    the frames both have agree."""
    audio = np.random.RandomState(10).randn(4000).astype(np.float32)
    kw = dict(n_fft=n_fft, n_mels=40, hop_length=160)
    got = kmel.mel_spectrogram_plain(torch.from_numpy(audio)[None],
                                     **kw)[0].numpy()
    assert kmel.route(n_fft, 40) == "dft"
    for want, extra in ((jmel.mel_spectrogram(jnp.asarray(audio), **kw), 0),
                        (pallas_mel_spectrogram(jnp.asarray(audio),
                                                interpret=True, **kw),
                         n_fft % 2)):
        want = np.asarray(want)
        assert want.shape[-1] == got.shape[-1] + extra
        np.testing.assert_allclose(got, want[:, :got.shape[-1]], rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("n_mod", [1, 12])
def test_fused_router_12_types_matches_jax(n_mod, monkeypatch):
    """12 types (two passes of 8 in the kernel), with types 3, 7 and 11
    given type 1's top weights: tied top scores."""
    rng = np.random.RandomState(26)
    x = rng.randn(2, 2, 128).astype(np.float32)
    jm = JRouter(dims=128, num_types=12)
    jx = jnp.asarray(x)
    params = jax.device_get(jm.init({"params": jax.random.key(1)},
                                    *(jx,) * n_mod)["params"])
    top = np.array(params["top"]["kernel"])
    top[:, [3, 7, 11]] = top[:, [1]]
    bias = np.array(params["top"]["bias"])
    bias[[3, 7, 11]] = bias[1]
    params["top"] = {"kernel": jnp.asarray(top), "bias": jnp.asarray(bias)}
    wants = _both(monkeypatch, jgm, "_PALLAS_ROUTER",
                  lambda p, x: jm.apply({"params": p}, *(x,) * n_mod),
                  params, jx)
    tm = Router(128, 12, n_mod, fused=True, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    kernels.reset_counts()
    got = tm(*(torch.from_numpy(x),) * n_mod)
    _engaged("fused_router_same")
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, **FTOL)


def test_router_top2_ties_go_to_the_first_occurrence():
    """The plain router's top-2 at 12 types with tied scores picks the
    same columns, in the same rank order, as the JAX router kernel's
    (jax.lax.top_k's order)."""
    from asr_model_tpu.ops.pallas.router_kernel import _topk2_hard
    rng = np.random.RandomState(27)
    s = rng.randn(64, 12).astype(np.float32)
    s[:16, [2, 5, 9]] = 3.0            # three-way tie for the top
    s[16:32, [0, 11]] = 3.0            # two-way tie for the top
    s[32:48, 4] = 3.0                  # a tie for the second place
    s[32:48, [6, 10]] = 2.0
    got = _topk_hard(torch.from_numpy(s), 2).numpy()
    want = np.asarray(_topk2_hard(jnp.asarray(s)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, atol=1e-7)


# --------------------------------------------------------------- gates

GATE_DIMS = [128, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2304, 3072,
             4096]
GATE_DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
               (torch.float16, jnp.float16)]


def _heads(d):
    """Head counts of width 128 to 512, and of width 64 (no gate admits
    it)."""
    return [d // w for w in (64, 128, 256, 384, 512) if d % w == 0]


def test_attention_gates_agree_with_jax(monkeypatch):
    monkeypatch.setattr(jam, "_PALLAS_XATTN", "on")
    admitted = 0
    for d in GATE_DIMS:
        for head in _heads(d):
            jm = JAttention(dims=d, head=head, layer=2,
                            n_type="AbbyNormal").bind({})
            tm = Attention(d, head, "AbbyNormal", fused=True, device="meta")
            for (tdt, jdt) in GATE_DTYPES:
                for b, t in ((1, 1), (8, 9), (8, 65), (8, 1001)):
                    x = torch.empty(b, t, d, dtype=tdt, device="meta")
                    jx = jax.ShapeDtypeStruct((b, t, d), jdt)
                    for tk in (9, 65, 256, 1001, 4096, 4097):
                        for elems, limit in ((head * tk * (d // head),
                                              KV_LIMIT_CACHED),
                                             (tk * d, KV_LIMIT_FULL)):
                            want = jm._fused_call_eligible(jx, elems, limit)
                            got = tm._fused_ok(x, elems, limit)
                            assert got == want, (d, head, b, t, tk, tdt)
                            if got:
                                admitted += 1
                                assert xattn.supports(d, head), (d, head)
    assert admitted > 100


def test_mlp_gates_agree_with_jax(monkeypatch):
    monkeypatch.setattr(jdm, "_PALLAS_MLP", "on")
    admitted = 0
    for d in GATE_DIMS:
        for nt in (1, 3, 8, 12):
            jm = JResidual(dims=d, head=max(1, d // 128), layer=4,
                           act="gelu", n_type="AbbyNormal",
                           num_types=nt).bind({})
            tm = Residual(d, max(1, d // 128), 4, "gelu", "AbbyNormal",
                          num_types=nt, fused_mlp=True, device="meta")
            for (tdt, jdt) in GATE_DTYPES:
                for b, t in ((1, 1), (8, 9), (8, 65), (8, 1001)):
                    x = torch.empty(b, t, d, dtype=tdt, device="meta")
                    want = jm._mlp_fused_eligible(
                        jax.ShapeDtypeStruct((b, t, d), jdt))
                    got = tm._mlp_fused_ok(x)
                    assert got == want, (d, nt, b, t, tdt)
                    if got:
                        admitted += 1
                        assert mlp.supports(d, nt), (d, nt)
    assert admitted > 50


def test_router_gates_agree_with_jax(monkeypatch):
    monkeypatch.setattr(jgm, "_PALLAS_ROUTER", "on")
    admitted = 0
    for d in GATE_DIMS:
        for nt in (2, 3, 8, 12):
            jm = JRouter(dims=d, num_types=nt).bind({})
            for n_mod in (1, 3):
                tm = Router(d, nt, n_mod, fused=True, device="meta")
                for (tdt, jdt) in GATE_DTYPES:
                    for b, t in ((1, 1), (8, 9), (8, 65), (8, 1001)):
                        x = torch.empty(b, t, d, dtype=tdt, device="meta")
                        jx = jax.ShapeDtypeStruct((b, t, d), jdt)
                        want = jm._fused_eligible((jx,) * n_mod)
                        got = tm._fused_ok((x,) * n_mod)
                        assert got == want, (d, nt, n_mod, b, t, tdt)
                        if got:
                            admitted += 1
                            assert router.supports(d, nt), (d, nt)
    assert admitted > 100
