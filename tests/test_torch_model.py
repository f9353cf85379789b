"""The slice as a whole: the port's Model and greedy buffer decode
against the golden reference (tests/golden/reference_parity.npz) and
against the JAX Model on random weights.

Weights go JAX -> port through ``weights.from_jax_params``: the golden
state_dict is transplanted into the JAX tree as
tests/test_reference_parity.py does, then into the port.  Tolerances,
relative to the largest reference logit: f32 2e-4 (the golden test's
own bound: f32 accumulation through the deep stack), f64 1e-6 (exact
math), bf16 0.2 (bf16 rounds at other places in the two frameworks:
the JAX side runs the XLA routes in bf16, the port's kernels' plain
versions compute in f32 inside; see the test); decoded tokens exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.compat import convert_state_dict
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JConfig
from asr_model_tpu.models import gates as jgates
from asr_model_tpu.models.generate import greedy_decode as jgreedy
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.models.model import cast_variables as jcast

from asr_model_tpu_torch.config import Dimensions
from asr_model_tpu_torch.models import gates
from asr_model_tpu_torch.models.generate import _bucket_sizes, greedy_decode
from asr_model_tpu_torch.models.model import Model, cast_variables
from asr_model_tpu_torch.weights import from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_parity.npz")


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()) \
        / max(1.0, float(np.abs(want).max()))


def _port(kw, variables, dtype=torch.float32):
    m = Model(Dimensions(**kw), device="cpu", dtype=dtype)
    m.load_state_dict(from_jax_params(variables["params"],
                                      variables.get("batch_stats")),
                      strict=True)
    return m


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------- golden

@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    kw = dict(tokens=int(g["cfg_tokens"]), mels=int(g["cfg_mels"]),
              dims=int(g["cfg_dims"]), head=int(g["cfg_head"]),
              layer=int(g["cfg_layer"]))
    jm = JModel(param=JDims(**kw), cfg=JConfig(dims=JDims(**kw)))
    skeleton = jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(g["in_text_ids"], jnp.int32),
        spectrogram=jnp.asarray(g["in_spectrogram"]),
        pitch=jnp.asarray(g["in_pitch"]),
        waveform=jnp.asarray(g["in_waveform"])))(jax.random.key(0))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd:")}
    variables = jax.device_get(convert_state_dict(
        sd, skeleton["params"], skeleton.get("batch_stats")))
    return g, kw, variables


def _golden_inputs(g, dtype):
    return dict(spectrogram=_t(g["in_spectrogram"], dtype),
                pitch=_t(g["in_pitch"], dtype),
                waveform=_t(g["in_waveform"], dtype))


def test_golden_forward_logits_and_loss_f32(golden):
    g, kw, variables = golden
    out = _port(kw, variables)(torch.from_numpy(g["in_text_ids"]),
                               labels=torch.from_numpy(g["in_labels"]),
                               **_golden_inputs(g, torch.float32))
    assert out["logits"].shape == g["out_logits"].shape
    assert _rel(out["logits"], g["out_logits"]) < 2e-4
    assert abs(float(out["loss"]) - float(g["out_loss"])) \
        / max(1.0, abs(float(g["out_loss"]))) < 1e-4


def test_golden_forward_logits_and_loss_f64(golden):
    g, kw, variables = golden
    out = _port(kw, variables, torch.float64)(
        torch.from_numpy(g["in_text_ids"]),
        labels=torch.from_numpy(g["in_labels"]),
        **_golden_inputs(g, torch.float64))
    # logits leave the head in f32, as on the JAX side (out_logits64 is
    # the f32 cast of f64 math)
    assert _rel(out["logits"], g["out_logits64"]) < 1e-6
    assert abs(float(out["loss"]) - float(g["out_loss64"])) \
        / max(1.0, abs(float(g["out_loss64"]))) < 1e-5


def test_golden_greedy_tokens(golden):
    g, kw, variables = golden
    ids = greedy_decode(_port(kw, variables),
                        max_new_tokens=int(g["max_new_tokens"]),
                        **_golden_inputs(g, torch.float32))
    ref = g["out_generate"][0]
    assert ids[0, :len(ref)].tolist() == ref.tolist()


# ----------------------------------------------------- random weights

RKW = dict(tokens=512, mels=16, dims=128, head=1, layer=4)
RB, RT = 2, 48


@pytest.fixture(scope="module")
def random_pair():
    """JAX model at dims=128 / one 128-wide head (the flagship head
    width), random init; the learned position table is redrawn from
    N(0, 10^2) (its init is all ones, under which every position decodes
    the same token) so the decode emits varied tokens.  Also returns the
    JAX f32 forward logits."""
    rng = np.random.RandomState(0)
    feats = dict(spectrogram=rng.randn(RB, 16, RT).astype(np.float32),
                 pitch=(100 + 50 * rng.rand(RB, 1, RT)).astype(np.float32)
                 / 100.0,
                 waveform=rng.randn(RB, 1, RT).astype(np.float32))
    ids = rng.randint(3, RKW["tokens"], size=(RB, 6))
    jm = JModel(param=JDims(**RKW), cfg=JConfig(dims=JDims(**RKW)))
    variables = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.ones((RB, 4), jnp.int32),
        **{k: jnp.asarray(v) for k, v in feats.items()}))(
            jax.random.key(0)))
    pos = variables["params"]["processor"]["position"]
    variables["params"]["processor"]["position"] = 10.0 * rng.randn(
        *pos.shape).astype(np.float32)
    logits = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(ids, jnp.int32),
        **{k: jnp.asarray(x) for k, x in feats.items()}))(
            jax.tree.map(jnp.asarray, variables))["logits"]
    return jm, variables, feats, ids, np.asarray(logits)


def test_random_forward_f32(random_pair):
    from asr_model_tpu.models.model import modality_slots as jslots
    from asr_model_tpu_torch.models.model import modality_slots
    jm, variables, feats, ids, want = random_pair
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    enc_w = jm.apply(variables, jslots(**jf), method=JModel.encode)
    pm = _port(RKW, variables)
    tf = {k: _t(v) for k, v in feats.items()}
    got = pm(torch.from_numpy(ids), **tf)["logits"]
    assert _rel(got, want) < 2e-4
    enc_g = pm.encode(modality_slots(**tf))
    for k in ("a", "b", "c"):
        assert _rel(enc_g[k], np.asarray(enc_w[k])) < 2e-4


def test_random_forward_bf16(random_pair):
    """bf16 through the whole stack moves the logits by ~10% of their
    largest value on both sides (routing choices of the norms flip on
    rounding); the port must stay as close to the JAX bf16 logits as
    that, and no farther from the f32 logits than twice the JAX bf16
    error."""
    jm, variables, feats, ids, want32 = random_pair
    jv = jcast(jax.tree.map(jnp.asarray, variables))
    want = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(ids, jnp.int32),
        **{k: jnp.asarray(x, jnp.bfloat16) for k, x in feats.items()}))(
            jv)["logits"]
    pm = cast_variables(_port(RKW, variables))
    got = pm(torch.from_numpy(ids),
             **{k: _t(v, torch.bfloat16) for k, v in feats.items()})["logits"]
    assert got.dtype == torch.float32
    assert np.all(np.isfinite(got.numpy()))
    want = np.asarray(want, np.float32)
    assert _rel(got, want) < 0.2
    assert _rel(got, want32) < 2.0 * _rel(want, want32)


@pytest.mark.parametrize("suppress_eos", [False, True])
def test_random_greedy_decode_tokens(random_pair, suppress_eos, monkeypatch):
    """Two prefix buckets (GRAFT_DECODE_STAGES=2 over 25 positions)."""
    monkeypatch.setenv("GRAFT_DECODE_STAGES", "2")
    assert _bucket_sizes(25, 2) == [13, 25]
    jm, variables, feats, ids, _ = random_pair
    want = np.asarray(jgreedy(jm, jax.tree.map(jnp.asarray, variables),
                              max_new_tokens=24, suppress_eos=suppress_eos,
                              **{k: jnp.asarray(v) for k, v in feats.items()}))
    got = greedy_decode(_port(RKW, variables), max_new_tokens=24,
                        suppress_eos=suppress_eos,
                        **{k: _t(v) for k, v in feats.items()}).numpy()
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    np.testing.assert_array_equal(got, want)


def test_bucket_sizes_match_jax():
    from asr_model_tpu.models.generate import _bucket_sizes as jbuckets
    for T in (9, 25, 65, 151):
        for n in (1, 2, 4, 8):
            assert _bucket_sizes(T, n) == jbuckets(T, n)
    assert _bucket_sizes(65, 8) == [9, 17, 25, 33, 41, 49, 57, 65]


def test_router_topk_ties_match_jax():
    """Exact ties in the top-2 scores break to the first occurrence in
    rank order, as jax.lax.top_k orders them."""
    scores = np.array([[1.0, 1.0, 1.0], [0.5, 2.0, 2.0], [3.0, 0.0, 3.0],
                       [0.0, 0.0, -1.0], [1.0, 2.0, 3.0]], np.float32)
    want = np.asarray(jgates._topk_hard(jnp.asarray(scores), 2))
    got = gates._topk_hard(torch.from_numpy(scores), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0].tolist() == [0.5, 0.5, 0.0]
