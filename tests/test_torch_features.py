"""The host features the port adds to ``extract_features`` against the
JAX package's, on the CPU: ``pitch_toks`` (every pooling mode),
``quantize_pitch`` (bins and the polar form), ``harmonics_and_aperiodics``
(WORLD's CheapTrick and D4C through the port's own native build),
``phase_track``, and ``extract_features`` with every flag, on a seeded
voiced tone with noise gaps; then ``collate`` on those features.

Both packages run the same C++ WORLD source (DIO, StoneMask, CheapTrick,
D4C) and the same numpy pooling, so those features are held exactly; the
log-mel at 2e-3 and the waveform at rtol 1e-5, as in
tests/test_torch_data.py."""

import os

import numpy as np
import pytest
import torch

from asr_model_tpu.data import collator as jcollator
from asr_model_tpu.data import features as jfeat
from asr_model_tpu.data.tokenizer import setup_tokenizer as jtokenizer

from asr_model_tpu_torch.data import collator, features
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
SR, HOP = 16000, 160


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tone():
    """0.6 s: a gliding voiced tone with two unvoiced noise gaps."""
    rng = np.random.RandomState(11)
    t = np.arange(int(0.6 * SR)) / SR
    x = 0.5 * np.sin(2 * np.pi * (140 + 60 * t) * t) \
        + 0.2 * np.sin(2 * np.pi * 2 * (140 + 60 * t) * t)
    for a, b in ((1800, 3000), (6400, 7200)):
        x[a:b] = 0.05 * rng.randn(b - a)
    return (x + 0.005 * rng.randn(len(t))).astype(np.float32)


@pytest.mark.parametrize("mode", ["mean", "median", "last"])
@pytest.mark.parametrize("n_tokens", [1, 7, 40])
def test_pitch_toks(tone, mode, n_tokens):
    labels = list(range(3, 3 + n_tokens))
    got = features.pitch_toks(tone, SR, labels, HOP, mode=mode)
    want = jfeat.pitch_toks(tone, SR, labels, HOP, mode=mode)
    assert got.shape == (n_tokens + 1,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_quantize_pitch(tone):
    pt = features.pitch_toks(tone, SR, list(range(12)), HOP)
    for p in (None, np.linspace(0.5, 2.0, pt.shape[0])):
        for kw in ({}, dict(num_bins=64, v_min=-1.0, v_max=3.0)):
            got = features.quantize_pitch(pt, p, **kw)
            want = jfeat.quantize_pitch(pt, p, **kw)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_harmonics_and_aperiodics(tone):
    h, a = features.harmonics_and_aperiodics(tone, SR, HOP)
    jh, ja = jfeat.harmonics_and_aperiodics(tone, SR, HOP)
    frames = 1 + len(tone) // HOP
    assert h.shape == a.shape == (128, frames)
    assert h.dtype == a.dtype == np.float32
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(a, ja)
    assert np.isfinite(h).all() and ((a >= 0) & (a <= 1)).all()


def test_phase_track(tone):
    got = features.phase_track(tone, SR, HOP)
    want = jfeat.phase_track(tone, SR, HOP)
    assert got.shape == (1 + len(tone) // HOP,)
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 2 * np.pi)).all()


@pytest.fixture(scope="module")
def both(tone):
    """Every flag on, the port and the JAX package."""
    tok = setup_tokenizer(os.path.join(ROOT, "asr_model_tpu_torch",
                                       "assets", "tokenizer.json"))
    jtok = jtokenizer(os.path.join(ROOT, "asr_model_tpu", "assets",
                                   "tokenizer.json"))
    item = {"audio": {"array": tone, "sampling_rate": SR},
            "transcription": "a rising tone with two gaps"}
    flags = dict(spectrogram=True, pitch=True, waveform=True, harmonics=True,
                 aperiodics=True, phase=True, pitch_tokens=True, mels=32,
                 hop_length=HOP, sample_rate=SR)
    return (features.extract_features(item, tok, device="cpu", **flags),
            jfeat.extract_features(item, jtok, **flags))


def test_extract_features_every_flag_matches_jax(both):
    got, want = both
    assert set(got) == set(want) == {
        "labels", "spectrogram", "pitch", "waveform", "harmonic",
        "aperiodic", "phase", "pitch_tokens"}
    assert list(got["labels"]) == list(want["labels"])
    for k in ("pitch", "harmonic", "aperiodic", "phase", "pitch_tokens"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["spectrogram"], want["spectrogram"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["waveform"], want["waveform"], rtol=1e-5,
                               atol=1e-7)


def test_collate_drops_what_jax_drops(both):
    got, want = both
    g = collator.collate([got, got], pad_to_multiple=16)
    w = jcollator.collate([want, want], pad_to_multiple=16)
    assert set(g) == set(w)
    assert not {"harmonic", "aperiodic", "phase"} & set(g)
    for k in ("text_ids", "labels", "pitch_tokens", "pitch"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
