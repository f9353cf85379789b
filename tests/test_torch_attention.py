"""The port's attention against the JAX package's: the flash kernel's
plain version against JAX ``sdpa`` (its XLA route, ``_sdpa_xla``) and
the Pallas ``flash_attention`` (interpret mode), then the whole
``Attention`` module (self, cross and cached K/V).  f32 throughout:
rtol 1e-5 against the XLA route; 2e-4 against the Pallas kernel, whose
online softmax sums in another order (tests/test_pallas.py uses the
same bound)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.models.attention import Attention as JAttention
from asr_model_tpu.models.attention import sdpa as jsdpa
from asr_model_tpu.ops.pallas.attention_kernel import flash_attention

from asr_model_tpu_torch.models.attention import Attention
from asr_model_tpu_torch.ops.cuda import attention as katt
from asr_model_tpu_torch.weights import from_jax_params


def _qkv(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, tq, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32))


def _plain(q, k, v, causal=False, valid=None):
    return katt.attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_valid=None if valid is None else torch.from_numpy(valid)).numpy()


# (causal, Tq, Tk, with kv_valid); the Pallas kernel aligns the causal
# mask top-left, so it joins only where Tq == Tk
CASES = [(False, 24, 24, False), (True, 24, 24, False),
         (False, 8, 40, True), (True, 24, 24, True),
         (False, 130, 70, False), (True, 9, 40, True)]


@pytest.mark.parametrize("causal,tq,tk,use_valid", CASES)
def test_sdpa_plain_matches_jax(causal, tq, tk, use_valid):
    q, k, v = _qkv(tq * 100 + tk, 2, 2, tq, tk, 16)
    valid = None
    if use_valid:
        valid = np.arange(tk)[None, :] < np.array([[tk - 3], [tk // 2]])
    want = np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal,
                            kv_valid=None if valid is None
                            else jnp.asarray(valid)))
    got = _plain(q, k, v, causal, valid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if causal and tq != tk:
        return
    flash = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_valid=None if valid is None else jnp.asarray(valid),
        interpret=True))
    np.testing.assert_allclose(got, flash, rtol=2e-4, atol=2e-5)


def test_sdpa_fully_masked_row_is_uniform_mean_of_v():
    """A row whose keys are all invalid: -1e30 logits, so softmax is
    uniform over every key -- the XLA route's value (the Pallas flash
    kernel returns zeros there, torch SDPA with -inf returns NaN)."""
    q, k, v = _qkv(7, 2, 1, 5, 12, 8)
    valid = np.ones((2, 12), bool)
    valid[1] = False
    want = np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            kv_valid=jnp.asarray(valid)))
    got = _plain(q, k, v, valid=valid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), got[1].shape), rtol=1e-5,
        atol=1e-6)


@pytest.fixture(scope="module")
def attn_pair():
    dims, head = 64, 2
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, dims).astype(np.float32)
    xa = rng.randn(2, 11, dims).astype(np.float32)
    jm = JAttention(dims, head, 4, n_type="AbbyNormal")
    params = jax.device_get(jm.init({"params": jax.random.key(1)},
                                    jnp.asarray(x), xa=jnp.asarray(xa))
                            ["params"])
    tm = Attention(dims, head, "AbbyNormal", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm, x, xa


@pytest.mark.parametrize("kind", ["self_causal", "cross", "cached"])
def test_attention_module_matches_jax(attn_pair, kind):
    jm, params, tm, x, xa = attn_pair
    v = {"params": params}
    valid = np.arange(x.shape[1])[None, :] < np.array([[7], [4]])
    xav = np.arange(xa.shape[1])[None, :] < np.array([[11], [6]])
    jx, jxa = jnp.asarray(x), jnp.asarray(xa)
    tx, txa = torch.from_numpy(x), torch.from_numpy(xa)
    if kind == "self_causal":
        want = jm.apply(v, jx, causal=True, kv_valid=jnp.asarray(valid))
        got = tm(tx, causal=True, kv_valid=torch.from_numpy(valid))
    elif kind == "cross":
        want = jm.apply(v, jx, xa=jxa, kv_valid=jnp.asarray(xav))
        got = tm(tx, xa=txa, kv_valid=torch.from_numpy(xav))
    else:
        kv = jm.apply(v, jxa, method=JAttention.precompute_kv)
        want = jm.apply(v, jx, cached_kv=kv, kv_valid=jnp.asarray(xav))
        tkv = tm.precompute_kv(txa)
        np.testing.assert_allclose(tkv[0].numpy(), np.asarray(kv[0]),
                                   rtol=1e-5, atol=1e-5)
        got = tm(tx, cached_kv=tkv, kv_valid=torch.from_numpy(xav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
