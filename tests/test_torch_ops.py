"""The port's frontend ops against the JAX package's (on the CPU).

Inputs are made with numpy from a seed and go through both.  Tolerances:
mel-domain values 2e-3 (rtol and atol, the Pallas mel kernel's own
tolerance against the FFT path, tests/test_pallas.py); everything else
f32 at rtol 1e-5 unless a line says why not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.ops import audio as jaudio
from asr_model_tpu.ops import mel as jmel
from asr_model_tpu.ops import pitch as jpitch
from asr_model_tpu.ops.pallas.mel_kernel import pallas_mel_spectrogram

from asr_model_tpu_torch.ops import audio, mel, pitch
from asr_model_tpu_torch.ops.cuda import mel as kmel

SR = 16000


def _tones(batch, seconds=1.0, seed=0):
    """bench.py's synthetic utterances: a tone, its octave, a little
    noise; a different pitch per row."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    return np.stack([
        (np.sin(2 * np.pi * (150 + 30 * i) * t)
         + 0.3 * np.sin(2 * np.pi * 2 * (150 + 30 * i) * t)
         + 0.01 * rng.randn(len(t))).astype(np.float32)
        for i in range(batch)])


@pytest.fixture(scope="module")
def audio2():
    return _tones(2)


def test_mel_spectrogram_matches_jax(audio2):
    want = np.asarray(jax.vmap(lambda a: jmel.mel_spectrogram(
        a, n_mels=32))(jnp.asarray(audio2)))
    got = mel.mel_spectrogram(torch.from_numpy(audio2), n_mels=32).numpy()
    assert got.shape == want.shape == (2, 32, 101)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_plain_mel_matches_pallas_kernel(audio2):
    """The kernel's plain version against the Pallas kernel (windowed
    DFT as two products, interpret mode) at the same inputs."""
    for row in audio2:
        want = np.asarray(pallas_mel_spectrogram(jnp.asarray(row), n_mels=32,
                                                 interpret=True))
        got = kmel.mel_spectrogram_plain(torch.from_numpy(row)[None],
                                         n_mels=32)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_fft", [64, 1024])
def test_dft_bases_match_pallas_kernel(n_fft):
    """The CUDA kernel's window and twiddle table give the Pallas kernel's
    windowed DFT bases (cos and -sin halves) within f32 rounding."""
    from asr_model_tpu.ops.pallas.mel_kernel import _dft_bases
    wc, ws = _dft_bases(n_fft)
    tw = kmel.fft_twiddles(n_fft)
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    w = mel.hann_window(n_fft)[:, None]
    np.testing.assert_allclose(w * tw[k * f % n_fft, 0], wc, rtol=0,
                               atol=1.2e-7)
    np.testing.assert_allclose(w * tw[k * f % n_fft, 1], ws, rtol=0,
                               atol=1.2e-7)


@pytest.mark.parametrize("n_fft,n_mels", [(1024, 128), (1024, 80),
                                          (64, 40)])
def test_mel_band_table_reproduces_dense_filterbank(n_fft, n_mels):
    """The kernel's band table (first bin, length, offset, packed
    weights) gives the dense (F, n_mels) product within 1e-6."""
    fb = mel.mel_filterbank(n_fft // 2 + 1, 50.0, 8000.0, n_mels)
    band, w = kmel.mel_bands(fb)
    assert band.shape == (n_mels, 3) and band.dtype == np.int32
    assert w.size == band[:, 1].sum() >= np.count_nonzero(fb)
    power = np.random.RandomState(2).rand(7, fb.shape[0]) * 1e3
    dense = power.astype(np.float64) @ fb.astype(np.float64)
    got = np.stack([power[:, lo:lo + n] @ w[off:off + n].astype(np.float64)
                    for lo, n, off in band], axis=1)
    np.testing.assert_allclose(got, dense, rtol=1e-6,
                               atol=1e-6 * np.abs(dense).max())


@pytest.mark.parametrize("n_fft", [64, 1024, 4096])
def test_fft_twiddles_match_numpy(n_fft):
    tw = kmel.fft_twiddles(n_fft)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float32
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], want, rtol=0,
                               atol=6e-8)


def test_log_mel_per_utterance_matches_jax(audio2):
    """(B, N) input: Whisper compression with a per-utterance max, as
    bench.py's vmap over utterances computes it."""
    quiet = audio2.copy()
    quiet[1] *= 1e-3                  # a different max per row
    want = np.asarray(jax.vmap(lambda a: jmel.log_mel_spectrogram(
        a, n_mels=32))(jnp.asarray(quiet)))
    got = mel.log_mel_spectrogram(torch.from_numpy(quiet), n_mels=32).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    single = mel.log_mel_spectrogram(torch.from_numpy(quiet[1]),
                                     n_mels=32).numpy()
    np.testing.assert_allclose(single, want[1], rtol=2e-3, atol=2e-3)


def test_filterbank_and_window_match_jax():
    np.testing.assert_array_equal(mel.hann_window(1024),
                                  jmel.hann_window(1024))
    np.testing.assert_array_equal(mel.mel_filterbank(513, 50.0, 8000.0, 128),
                                  jmel.mel_filterbank(513, 50.0, 8000.0, 128))


def test_yin_f0_matches_jax(audio2):
    want = np.asarray(jax.vmap(lambda a: jpitch.yin_f0(
        a, fs=SR, frame_period=10.0)[0])(jnp.asarray(audio2)))
    f0, t = pitch.yin_f0(torch.from_numpy(audio2), fs=SR, frame_period=10.0)
    got = f0.numpy()
    assert got.shape == want.shape == (2, 101)
    assert t.shape == (101,)
    # the voicing decisions must agree exactly; the F0 values pass
    # through an FFT autocorrelation and a parabolic fit whose f32
    # rounding differs between the two FFT libraries
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # and the tones are found: 150 Hz and 180 Hz
    assert np.median(got[0][got[0] > 0]) == pytest.approx(150, rel=0.02)
    assert np.median(got[1][got[1] > 0]) == pytest.approx(180, rel=0.02)


def test_frame_rate_waveform_matches_jax(audio2):
    want = np.asarray(jax.vmap(lambda a: jaudio.frame_rate_waveform(
        a, SR, 160))(jnp.asarray(audio2)))
    got = audio.frame_rate_waveform(torch.from_numpy(audio2), SR, 160)
    assert got.shape == want.shape == (2, 1, 100)
    # cumulative sums over 16k samples: both sides round the running sum
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the upsampling branch (a signal shorter than its frame count)
    short = audio2[0, :50]
    np.testing.assert_allclose(
        audio.frame_rate_waveform(torch.from_numpy(short), 50, 1).numpy(),
        np.asarray(jaudio.frame_rate_waveform(jnp.asarray(short), 50, 1)),
        rtol=1e-5, atol=1e-6)


def test_sinusoids_match_jax():
    want = np.asarray(jaudio.sinusoids(1001, 512))
    got = audio.sinusoids(1001, 512).numpy()
    # angles up to ~1000 rad: one f32 ulp of the angle is ~6e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
