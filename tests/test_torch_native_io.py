"""The port's native FLAC decoder and WER engine against the source PCM
and the JAX package, on the CPU.

FLAC: ``asr_model_tpu_torch.native.read_flac`` bit-exact (tolerance 0:
the int16 PCM recovered as round(x * 32768)) against the PCM that
``tools/flac_encoder.py`` (an independent RFC 9639 encoder, numpy only)
wrote and against ``asr_model_tpu.native.read_flac`` on the same file,
over the subframe, partition, escape, block-size, wasted-bit and stereo
cases of ``tests/test_native.py``; ``load_wave`` of a FLAC equal to its
WAV twin; a malformed or truncated stream and a failed build raise.
WER: the native ``levenshtein`` equal to the Python DP
(``levenshtein_dp``) and ``wer_batch`` equal to the JAX package's, on
seeded word lists."""

import importlib.util
import os
import wave

import numpy as np
import pytest

from asr_model_tpu import native as jnative
from asr_model_tpu.train.metrics import wer_batch as jwer_batch

from asr_model_tpu_torch import native
from asr_model_tpu_torch.data.audio_io import load_wave
from asr_model_tpu_torch.train.metrics import (levenshtein, levenshtein_dp,
                                               wer_batch)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def enc():
    path = os.path.join(ROOT, "tools", "flac_encoder.py")
    spec = importlib.util.spec_from_file_location("flac_encoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tone_pcm(n=16000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    sig = 0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n)
    return np.clip(sig * 32767, -32768, 32767).astype(np.int16)


def _pcm(kw):
    if "stereo_mode" in kw:
        left = _tone_pcm(8000, seed=1)
        return np.stack([left, (left // 2).astype(np.int16)], 1)
    pcm = _tone_pcm()
    if kw.get("subframe") == "constant":
        pcm = np.full(5000, -321, np.int16)
    if kw.get("wasted_bits"):
        pcm = pcm & ~((1 << kw["wasted_bits"]) - 1)
    return pcm


@pytest.mark.parametrize("kw", [
    dict(), dict(subframe="verbatim"), dict(subframe="constant"),
    dict(subframe="fixed0"), dict(subframe="fixed1"),
    dict(subframe="fixed2"), dict(subframe="lpc2"), dict(subframe="lpc8"),
    dict(subframe="lpc12", partition_order=2), dict(partition_order=3),
    dict(force_escape=True), dict(block_size=256), dict(block_size=1000),
    dict(wasted_bits=3), dict(stereo_mode="independent"),
    dict(stereo_mode="left_side"), dict(stereo_mode="right_side"),
    dict(stereo_mode="mid_side")], ids=lambda kw: "-".join(
        f"{k}={v}" for k, v in kw.items()) or "auto")
def test_read_flac_bit_exact(tmp_path, enc, kw):
    pcm = _pcm(kw)
    path = str(tmp_path / "t.flac")
    enc.write_flac(path, pcm, 16000, **kw)
    data, sr = native.read_flac(path)
    want, want_sr = jnative.read_flac(path)
    assert sr == want_sr == 16000
    assert data.dtype == np.float32 and data.shape == want.shape
    np.testing.assert_array_equal(data, want)
    got = np.round(data * 32768).astype(np.int64)
    np.testing.assert_array_equal(got, pcm.astype(np.int64).T)


def test_load_wave_flac_equals_wav_twin(tmp_path, enc):
    pcm = _tone_pcm(12000, seed=2)
    fpath, wpath = str(tmp_path / "u.flac"), str(tmp_path / "u.wav")
    enc.write_flac(fpath, pcm, 16000)
    with wave.open(wpath, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype("<i2").tobytes())
    a, sa = load_wave(fpath)
    b, sb = load_wave(wpath)
    assert sa == sb == 16000
    np.testing.assert_array_equal(a, b)


def test_malformed_flac_and_failed_build_raise(tmp_path, enc, monkeypatch):
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"RIFF" + bytes(100))
    with pytest.raises(RuntimeError, match="not a FLAC stream"):
        native.read_flac(str(bad))
    good = str(tmp_path / "good.flac")
    enc.write_flac(good, _tone_pcm(), 16000)
    raw = open(good, "rb").read()
    cut = tmp_path / "cut.flac"
    cut.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(RuntimeError, match="FLAC decode failed"):
        native.read_flac(str(cut))
    with pytest.raises(RuntimeError):
        jnative.read_flac(str(cut))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ["-fno-such-flag-anywhere"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library("wer")


def test_wer_native_equals_dp_and_jax():
    rs = np.random.RandomState(0)
    words = ["the", "cat", "sat", "on", "a", "mat", "The", "dog"]
    refs, hyps = [], []
    for _ in range(300):
        r = list(rs.choice(words, size=rs.randint(0, 12)))
        h = list(rs.choice(words, size=rs.randint(0, 12)))
        assert levenshtein(r, h) == levenshtein_dp(r, h)
        refs.append(" ".join(r))
        hyps.append(" ".join(h))
    assert levenshtein(["a"] * 400, ["b"] * 300) == 400
    got, want = wer_batch(refs, hyps), jwer_batch(refs, hyps)
    assert got == want and 0 < got
    assert wer_batch(["", ""], ["a", ""]) == jwer_batch(["", ""], ["a", ""])
