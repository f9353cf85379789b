"""The latent modules and the small public names of the port against the
JAX package's, on the CPU: ``models/extras.py`` (``create_attention_mask``,
``calculate_attention``, ``Curiosity``, ``AdaptiveSpan``,
``MyelinatedLayer``), ``Gate``, ``OneShot``, ``taylor_softmax``,
``rbf_scores``, ``ChannelLayerNorm``, ``Identity``, ``wideband_freqs``,
``init_w``, ``peak_normalize``, ``get_audio``, ``default_tokenizer_path``
and ``abcord`` / ``no_none`` / ``exact_div``.

Inputs are made with numpy from a seed; each module's flax params reach
the port through ``weights.from_jax_params`` (``strict=True``).  f32
values are held at rtol 1e-5 / atol 1e-5 (sums in other orders; the
masks and integer results exactly).  ``MyelinatedLayer`` is held in the
noise-free limit and with JAX's uniform jump draws (read from the key it
splits) in place of the port's ``jump_draws``, at a key where a jump is
taken."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu import utils as jutils
from asr_model_tpu.cli import default_tokenizer_path as jtok_path
from asr_model_tpu.data.audio_io import get_audio as jget_audio
from asr_model_tpu.models import attention as jatt
from asr_model_tpu.models import extras as jx
from asr_model_tpu.models import gates as jgates
from asr_model_tpu.models import norms as jnorms
from asr_model_tpu.models import rotary as jrot
from asr_model_tpu.models.model import init_w as jinit_w
from asr_model_tpu.ops.audio import peak_normalize as jpeak

from asr_model_tpu_torch import utils
from asr_model_tpu_torch.cli import default_tokenizer_path
from asr_model_tpu_torch.config import Dimensions, ModelConfig
from asr_model_tpu_torch.data.audio_io import get_audio
from asr_model_tpu_torch.models import attention as patt
from asr_model_tpu_torch.models import extras as px
from asr_model_tpu_torch.models import gates as pgates
from asr_model_tpu_torch.models import norms as pnorms
from asr_model_tpu_torch.models import rotary as prot
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.model import Model, init_w
from asr_model_tpu_torch.ops.audio import peak_normalize
from asr_model_tpu_torch.weights import from_jax_params, to_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arr(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def ported(module, variables):
    """``module`` with the flax params loaded, strictly."""
    module.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return module.eval()


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(kw or TOL))


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("causal", [True, False])
def test_create_attention_mask(causal):
    pad = np.asarray([[1, 1, 0, 0, 1], [1, 1, 1, 1, 1]], bool)
    for pm in (None, pad):
        want = jx.create_attention_mask(2, 5, causal, None if pm is None
                                        else jnp.asarray(pm))
        got = px.create_attention_mask(2, 5, causal, None if pm is None
                                       else torch.from_numpy(pm))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature,causal,tq,masked", [
    (1.0, True, 5, False), (0.5, True, 3, False), (2.0, False, 5, False),
    (1.0, False, 5, True)])
def test_calculate_attention(temperature, causal, tq, masked):
    rng = np.random.RandomState(0)
    q, k, v = arr(rng, 2, 3, tq, 8), arr(rng, 2, 3, 5, 8), arr(rng, 2, 3, 5, 8)
    mask = None
    if masked:
        mask = np.array(jx.create_attention_mask(
            2, 5, True, jnp.asarray([[1, 1, 1, 0, 0], [1] * 5], bool)))
    wo, ww = jx.calculate_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), temperature, causal)
    go, gw = px.calculate_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), temperature,
        causal)
    assert go.shape == (2, tq, 24)
    close(go, wo)
    close(gw, ww)


def test_taylor_softmax_and_rbf_scores():
    rng = np.random.RandomState(6)
    x = arr(rng, 3, 7)
    for order in (1, 2, 3):
        close(patt.taylor_softmax(torch.from_numpy(x), order),
              jatt.taylor_softmax(jnp.asarray(x), order))
    q, k = arr(rng, 1, 2, 4, 8), arr(rng, 1, 2, 6, 8)
    for sigma, ratio in ((1.0, 0.3), (2.0, 0.0), (0.5, 1.0)):
        close(patt.rbf_scores(torch.from_numpy(q), torch.from_numpy(k),
                              sigma, ratio),
              jatt.rbf_scores(jnp.asarray(q), jnp.asarray(k), sigma, ratio))


# --------------------------------------------------------------- modules

@pytest.mark.parametrize("with_mask", [False, True])
def test_curiosity(with_mask):
    rng = np.random.RandomState(1)
    x, xa = arr(rng, 2, 5, 16), arr(rng, 2, 7, 16)
    jm = jx.Curiosity(d=16, h=2)
    v = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(xa))
    # a gate away from 0.5, so that both branches count
    v["params"]["g"] = jnp.asarray([0.7, -1.2], jnp.float32)
    mask = None
    if with_mask:
        mask = np.triu(np.ones((5, 5), bool), 1)[None, None]
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(xa),
                    None if mask is None else jnp.asarray(mask))
    pm = ported(px.Curiosity(16, 2, device="cpu"), v)
    got = pm(torch.from_numpy(x), torch.from_numpy(xa),
             None if mask is None else torch.from_numpy(mask))
    close(got, want)


@pytest.mark.parametrize("span_len,sharpen", [(None, True), (5, True),
                                              (None, False), (0, True)])
def test_adaptive_span(span_len, sharpen):
    rng = np.random.RandomState(2)
    x = arr(rng, 2, 12, 16)
    jm = jx.AdaptiveSpan(dims=16, head=2, max_dist=8, sharpen=sharpen)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    v["params"]["span_scale"] = jnp.asarray(0.8, jnp.float32)
    wo, ww = jm.apply(v, jnp.asarray(x), span_len=span_len)
    pm = ported(px.AdaptiveSpan(16, 2, max_dist=8, sharpen=sharpen,
                                device="cpu"), v)
    go, gw = pm(torch.from_numpy(x), span_len=span_len)
    assert go.shape == wo.shape
    close(go, wo)
    assert (gw is None) == (ww is None)
    if gw is not None:
        close(gw, ww)


def _myelinated(seed=3):
    rng = np.random.RandomState(seed)
    x = arr(rng, 2, 6, 16)
    jm = jx.MyelinatedLayer(dims=16, head=2, layerA=3)
    v = jm.init({"params": jax.random.key(0), "jump": jax.random.key(1)},
                jnp.asarray(x))
    return x, jm, v, ported(px.MyelinatedLayer(16, 2, 3, device="cpu"), v)


def test_myelinated_layer_noise_free(monkeypatch):
    x, jm, v, pm = _myelinated()
    want = jm.apply(v, jnp.asarray(x))
    close(pm(torch.from_numpy(x)), want)
    # a generator whose draws are all 1 is the noise-free limit too
    monkeypatch.setattr(px, "jump_draws", lambda gen, s, b, device, dtype:
                        torch.ones(s, b, dtype=dtype))
    with stochastic.mode(gen=torch.Generator().manual_seed(0)):
        close(pm(torch.from_numpy(x)), want)


def test_myelinated_layer_with_jax_draws(monkeypatch):
    """JAX's own uniforms in place of the port's draws, at the first key
    whose draws take a jump (the output then differs from the noise-free
    one)."""
    x, jm, v, pm = _myelinated()
    free = np.asarray(jm.apply(v, jnp.asarray(x)))
    split = jax.random.split
    for seed in range(20):
        keys = []

        def spy(key, num=2):
            out = split(key, num)
            if num == jm.layerA:
                keys.append(out)
            return out
        monkeypatch.setattr(jax.random, "split", spy)
        want = np.asarray(jm.apply(v, jnp.asarray(x),
                                   rngs={"jump": jax.random.key(seed)}))
        monkeypatch.setattr(jax.random, "split", split)
        if not np.allclose(want, free):
            break
    else:
        pytest.fail("no key in 20 took a jump")
    assert len(keys) == 1
    u = np.stack([np.asarray(jax.random.uniform(keys[0][s], (x.shape[0],)))
                  for s in range(jm.layerA)])
    monkeypatch.setattr(px, "jump_draws",
                        lambda gen, s, b, device, dtype: torch.from_numpy(u))
    with stochastic.mode(gen=torch.Generator().manual_seed(0)):
        got = pm(torch.from_numpy(x))
    close(got, want)
    assert not np.allclose(got.numpy(), free)


def test_jump_draws_come_from_the_generator():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = px.jump_draws(g1, 3, 4, "cpu", torch.float32)
    b = px.jump_draws(g2, 3, 4, "cpu", torch.float32)
    assert a.shape == (3, 4) and torch.equal(a, b)
    assert bool(((a >= 0) & (a < 1)).all())


@pytest.mark.parametrize("num_types,num", [(4, 2), (3, 1), (2, 2)])
def test_gate(num_types, num):
    rng = np.random.RandomState(5)
    x = arr(rng, 2, 3, 16)
    jm = jgates.Gate(dims=16, num_types=num_types)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    v["params"]["alpha"] = jnp.asarray([0.3], jnp.float32)
    want = jm.apply(v, jnp.asarray(x), num)
    pm = ported(pgates.Gate(16, num_types, device="cpu"), v)
    close(pm(torch.from_numpy(x), num), want)


def test_oneshot_scale_forms():
    rng = np.random.RandomState(4)
    x, xa = arr(rng, 1, 4, 16), arr(rng, 1, 9, 16)
    for nf in (None, 4):
        jm = jgates.OneShot(dims=16, head=2, num_features=nf)
        v = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(xa))
        pm = ported(pgates.OneShot(16, 2, num_features=nf, device="cpu"), v)
        assert pm.default_scale == jm.default_scale
        close(pm(torch.from_numpy(x), torch.from_numpy(xa)),
              jm.apply(v, jnp.asarray(x), jnp.asarray(xa)))
        for s in (0.6, torch.tensor(0.6)):
            close(pm(torch.from_numpy(x), torch.from_numpy(xa), scale=s),
                  jm.apply(v, jnp.asarray(x), jnp.asarray(xa),
                           scale=jnp.asarray(0.6)))


def test_channel_layer_norm_and_identity():
    rng = np.random.RandomState(8)
    x = arr(rng, 2, 7, 12)
    jm = jnorms.ChannelLayerNorm(dims=12)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    v["params"]["LayerNorm_0"]["scale"] = jnp.asarray(arr(rng, 12))
    v["params"]["LayerNorm_0"]["bias"] = jnp.asarray(arr(rng, 12))
    pm = ported(pnorms.ChannelLayerNorm(12, device="cpu"), v)
    close(pm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))
    t = torch.from_numpy(x)
    assert pnorms.Identity()(t, 3, k=1) is t
    assert not dict(pnorms.Identity().named_parameters())


@pytest.mark.parametrize("dims,head,max_freq", [(512, 4, 8000.0),
                                                (64, 2, 4000.0)])
def test_wideband_freqs(dims, head, max_freq):
    got = prot.wideband_freqs(dims, head, max_freq)
    want = jrot.wideband_freqs(dims, head, max_freq)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_init_w_counts_as_jax_counts(capsys):
    """The port's count over its own state_dict names equals the JAX
    function's over the same weights' flax tree."""
    cfg = ModelConfig(chained_blocks=False)
    model = Model(Dimensions(tokens=64, mels=8, dims=16, head=2, layer=2),
                  cfg, device="cpu")
    params, _ = to_jax_params(model)
    want = jinit_w(params)
    got = init_w(model)
    assert got == want and got["Linear"] > 0 and got["LayerNorm"] > 0
    assert "Initialization summary:" in capsys.readouterr().out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", ["Curiosity", "AdaptiveSpan",
                                  "MyelinatedLayer", "Gate", "OneShot",
                                  "ChannelLayerNorm"])
def test_weights_map_both_ways(name):
    """``from_jax_params`` fills every parameter (strict) and
    ``to_jax_params`` gives the flax tree back, leaf for leaf."""
    rng = np.random.RandomState(10)
    x, xa = jnp.asarray(arr(rng, 2, 5, 16)), jnp.asarray(arr(rng, 2, 7, 16))
    jm, pm, args = {
        "Curiosity": (jx.Curiosity(d=16, h=2), px.Curiosity(16, 2), (x, xa)),
        "AdaptiveSpan": (jx.AdaptiveSpan(dims=16, head=2),
                         px.AdaptiveSpan(16, 2), (x,)),
        "MyelinatedLayer": (jx.MyelinatedLayer(dims=16, head=2),
                            px.MyelinatedLayer(16, 2), (x,)),
        "Gate": (jgates.Gate(dims=16, num_types=3), pgates.Gate(16, 3), (x,)),
        "OneShot": (jgates.OneShot(dims=16, head=2), pgates.OneShot(16, 2),
                    (x, xa)),
        "ChannelLayerNorm": (jnorms.ChannelLayerNorm(dims=16),
                             pnorms.ChannelLayerNorm(16), (x,))}[name]
    v = jm.init({"params": jax.random.key(2), "jump": jax.random.key(3)},
                *args)
    ported(pm, v)
    back, _ = to_jax_params(pm)
    want = dict(_flat(v["params"]))
    got = dict(_flat(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ----------------------------------------------------------- small helpers

def test_peak_normalize():
    rng = np.random.RandomState(9)
    for w in (arr(rng, 300) * 0.2, np.zeros(8, np.float32)):
        np.testing.assert_array_equal(
            peak_normalize(torch.from_numpy(w)).numpy(),
            np.asarray(jpeak(jnp.asarray(w))))


def test_get_audio():
    wav = np.sin(np.arange(3200) / 7.0).astype(np.float32) * 0.4
    item = {"array": wav, "sampling_rate": 16000}
    (got, gdur), (want, wdur) = get_audio(item), jget_audio(item)
    assert gdur == wdur == 0.2
    assert got["sampling_rate"] == want["sampling_rate"]
    np.testing.assert_array_equal(got["raw"], want["raw"])


def test_default_tokenizer_path_is_the_ports_own_copy():
    got = default_tokenizer_path()
    assert got.endswith(("asr_model_tpu_torch/assets/tokenizer.json"))
    with open(got, "rb") as a, open(jtok_path(), "rb") as b:
        assert a.read() == b.read()


def test_null_coalescing_helpers():
    for args in ((None, None, 3, 4), (1, None, None, 4), (None, 2, 3, 4),
                 (None, None, None, None)):
        assert utils.abcord(*args) == jutils.abcord(*args)
    d = {"a": 1, "b": None, "c": 0}
    assert utils.no_none(d) == jutils.no_none(d) == {"a": 1, "c": 0}
    assert utils.exact_div(12, 4) == jutils.exact_div(12, 4) == 3
    with pytest.raises((ValueError, AssertionError)):
        utils.exact_div(10, 4)
    with pytest.raises(AssertionError):
        jutils.exact_div(10, 4)
