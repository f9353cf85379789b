"""Host audio decode: the port's own copy of
``asr_model_tpu/data/audio_io.py``'s WAV reader and ``load_wave``.

WAV (PCM 8/16/24/32-bit) is decoded here and FLAC (the LibriSpeech
encoding) by the port's native decoder (``native.read_flac``), then
peak-normalised; other codecs go through ``soundfile`` where it is
installed.  ``strict_multichannel=True`` divides each channel by its
plain maximum, as the reference does; the default divides by the
absolute maximum.
"""

from __future__ import annotations

import wave
from typing import Tuple, Union

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32 in [-1, 1]: (samples,) or
    (channels, samples), and the sample rate."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) \
            / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        data = data.reshape(-1, nch).T
    return data, sr


def _read_any(path: str) -> Tuple[np.ndarray, int]:
    if path.lower().endswith(".wav"):
        try:
            return read_wav(path)
        except (wave.Error, ValueError):
            pass
    if path.lower().endswith(".flac"):
        from asr_model_tpu_torch.native import read_flac
        return read_flac(path)
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(
            f"cannot decode {path}: not a PCM WAV and soundfile is not "
            "installed") from e
    data, sr = sf.read(path, dtype="float32")
    return (data.T if data.ndim > 1 else data), sr


def load_wave(audio: Union[str, dict], sample_rate: int = 16000,
              strict_multichannel: bool = False) -> Tuple[np.ndarray, int]:
    """Decode and peak-normalise a file, or take a ``{"array",
    "sampling_rate"}`` dict as it is."""
    if isinstance(audio, str):
        wp, sr = _read_any(audio)
        if wp.ndim > 1:
            peak = wp.max(axis=-1, keepdims=True) if strict_multichannel \
                else np.abs(wp).max(axis=-1, keepdims=True)
            wp = np.where(peak > 0, wp / np.maximum(peak, 1e-12), wp)
        else:
            m = np.abs(wp).max()
            wp = wp / m if m > 0 else wp
        return wp.astype(np.float32), sr
    if isinstance(audio, dict):
        return (np.asarray(audio["array"], dtype=np.float32),
                int(audio["sampling_rate"]))
    raise TypeError("Invalid wave_data format.")


def get_audio(audio, sample_rate: int = 16000):
    """({"raw": ``load_wave``'s samples, "sampling_rate": sr}, the
    duration in seconds) of a file or a ``{"array", "sampling_rate"}``
    dict."""
    wav, sr = load_wave(audio, sample_rate)
    return {"raw": np.asarray(wav), "sampling_rate": sr}, wav.shape[-1] / sr
