"""Per-utterance feature extraction for training, the counterpart of
``asr_model_tpu/data/features.py:extract_features``.

* ``spectrogram``: the log-mel of ``ops/mel.py`` (n_fft 1024, 50-8000 Hz,
  Whisper compression), one 1-D utterance a call: on a CUDA device the
  mel kernel (``ops/cuda/mel.py``), one launch an utterance, as the JAX
  package calls its Pallas kernel;
* ``pitch``: (1, T) F0 at frame period hop / sr: "yin" through
  ``ops/pitch.py`` on the device, "dio" and "dio_host" through the
  native host DIO + StoneMask (``asr_model_tpu_torch/native``), as the
  JAX package routes its training features;
* ``waveform``: the frame-rate waveform of ``ops/audio.py``;
* ``pitch_tokens``: the F0 pooled over each token's time span and
  z-normalised over the voiced tokens, the BOS pitch first
  (``pitch_toks``);
* ``harmonics`` / ``aperiodics``: WORLD's CheapTrick envelope and D4C
  aperiodicity at fft_size 256, the first 128 bins transposed
  (``harmonics_and_aperiodics``; keys ``harmonic`` / ``aperiodic``);
* ``phase``: the F0-integrated phase track (``phase_track``).

The host features run the port's native DIO + StoneMask and WORLD
analyses (``asr_model_tpu_torch/native``; a failed build raises: there
is no STFT-envelope stand-in).  The features come back as numpy arrays
(the collator's input; it feeds none of the last four to the model, as
in the JAX package).  ``hilbert`` is accepted and unused, as in the
reference.  ``extract_features.calls`` counts the utterances featurised.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from asr_model_tpu_torch.data.audio_io import load_wave
from asr_model_tpu_torch.ops.audio import frame_rate_waveform
from asr_model_tpu_torch.ops.mel import log_mel_spectrogram
from asr_model_tpu_torch.utils import resolve_device

PITCH_ESTIMATORS = ("dio", "dio_host", "yin")


def pitch_track(audio: np.ndarray, sample_rate: int = 16000,
                hop_length: int = 160, estimator: str = "dio",
                device=None) -> np.ndarray:
    """(1, T) float32 F0 of one utterance."""
    if estimator in ("dio", "dio_host"):
        from asr_model_tpu_torch.native import pitch_track_host
        return pitch_track_host(audio, sample_rate, hop_length)
    if estimator != "yin":
        raise ValueError(f"unknown pitch estimator {estimator!r}")
    from asr_model_tpu_torch.ops.pitch import yin_f0
    x = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    f0, _t = yin_f0(x, fs=sample_rate,
                    frame_period=hop_length / sample_rate * 1000.0)
    return f0.cpu().numpy().astype(np.float32)[None, :]


def _dio_stonemask(audio, sample_rate: int, hop_length: int):
    """The native DIO track at frame period hop / sr and its StoneMask
    refinement: (f0, t) float64."""
    from asr_model_tpu_torch.native import world_dio, world_stonemask
    f0, t = world_dio(audio, sample_rate,
                      frame_period=hop_length / sample_rate * 1000.0)
    return world_stonemask(audio, f0, t, sample_rate), t


def pitch_toks(audio: np.ndarray, sample_rate: int, labels: List[int],
               hop_length: int, mode: str = "mean") -> np.ndarray:
    """Token-aligned pitch: the DIO + StoneMask track cut into
    ``len(labels)`` equal time spans, each span's voiced frames pooled
    (``mode`` "mean", "median" or the last), z-normalised over the voiced
    tokens, the first token's value prepended as the BOS pitch."""
    f0, t = _dio_stonemask(audio, sample_rate, hop_length)
    duration = len(audio) / sample_rate
    n = len(labels)
    tok_dur = duration / max(n, 1)
    starts = np.arange(n) * tok_dur
    si = np.searchsorted(t, starts, side="left")
    ei = np.searchsorted(t, starts + tok_dur, side="right")
    out = np.zeros(n, np.float32)
    for q in range(n):
        seg = f0[si[q]:max(si[q] + 1, ei[q])]
        v = seg[seg > 0]
        if len(v):
            out[q] = (v.mean() if mode == "mean" else np.median(v)
                      if mode == "median" else v[-1])
    voiced = out[out > 0]
    mean_p = voiced.mean() if len(voiced) else 0.0
    std_p = voiced.std(ddof=1) if len(voiced) > 1 else 1.0
    z = (out - mean_p) / (std_p + 1e-6)
    bos = z[0] if len(z) else 0.0
    return np.concatenate([[bos], z]).astype(np.float32)


def quantize_pitch(pt: np.ndarray, p: Optional[np.ndarray] = None,
                   num_bins: int = 256, v_min: float = -2.0,
                   v_max: float = 2.0) -> np.ndarray:
    """Normalised pitch rounded into ``num_bins`` linear bins over
    [v_min, v_max] (int64); with a magnitude track ``p``, the polar form
    p exp(i bin) as (..., 2) float32 real pairs."""
    idx = np.clip(np.round((pt - v_min) / (v_max - v_min)
                           * (num_bins - 1)), 0, num_bins - 1)
    if p is None:
        return idx.astype(np.int64)
    z = p * np.exp(1j * idx)
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def harmonics_and_aperiodics(audio: np.ndarray, sample_rate: int,
                             hop_length: int, n_bins: int = 128):
    """WORLD's spectral envelope (CheapTrick) and aperiodicity (D4C) of
    the DIO + StoneMask track at fft_size 256, each (n_bins, T)
    float32."""
    from asr_model_tpu_torch.native import world_cheaptrick, world_d4c
    f0, t = _dio_stonemask(audio, sample_rate, hop_length)
    sp = world_cheaptrick(audio, f0, t, sample_rate, fft_size=256)
    ap = world_d4c(audio, f0, t, sample_rate, fft_size=256)
    return (sp[:, :n_bins].T.astype(np.float32),
            ap[:, :n_bins].T.astype(np.float32))


def phase_track(audio: np.ndarray, sample_rate: int,
                hop_length: int) -> np.ndarray:
    """The F0-integrated phase cumsum(2 pi f0 dt) mod 2 pi of the DIO
    track (dt its mean frame step), (T,) float32."""
    from asr_model_tpu_torch.native import world_dio
    frame_period = hop_length / sample_rate * 1000.0
    f0, t = world_dio(audio, sample_rate, frame_period=frame_period)
    tframe = np.mean(np.diff(t)) if len(t) > 1 else frame_period / 1000.0
    phi = np.cumsum(2 * np.pi * f0 * tframe)
    return np.remainder(phi, 2 * np.pi).astype(np.float32)


def extract_features(batch: Dict[str, Any], tokenizer=None,
                     spectrogram: bool = False, pitch: bool = False,
                     waveform: bool = False, harmonics: bool = False,
                     aperiodics: bool = False, phase: bool = False,
                     hilbert: bool = False, pitch_tokens: bool = False,
                     hop_length: int = 160, sample_rate: int = 16000,
                     mels: int = 128, mode: str = "mean",
                     pitch_estimator: str = "dio",
                     dummy_audio: bool = False, dummy_text: bool = False,
                     device=None) -> Dict[str, Any]:
    """``batch``: {"audio": path or {"array", "sampling_rate"},
    "transcription" or "sentence": text}.  ``device`` None is the card
    (an error without one), "cpu" the plain route; the host features do
    not use it."""
    extract_features.calls += 1
    dev = resolve_device(device)
    if dummy_text:
        labels = [1] * 32
    else:
        text = batch["transcription" if "transcription" in batch
                     else "sentence"]
        labels = tokenizer.encode(text)
    audio, _sr = load_wave(batch["audio"], sample_rate)
    audio = np.asarray(audio, np.float32)
    if dummy_audio:
        audio = np.zeros_like(audio)
    out: Dict[str, Any] = {"labels": labels}
    if pitch_tokens:
        out["pitch_tokens"] = pitch_toks(audio, sample_rate, labels,
                                         hop_length, mode=mode)
    if harmonics or aperiodics:
        h, a = harmonics_and_aperiodics(audio, sample_rate, hop_length)
        if harmonics:
            out["harmonic"] = h
        if aperiodics:
            out["aperiodic"] = a
    if pitch:
        out["pitch"] = pitch_track(audio, sample_rate, hop_length,
                                   pitch_estimator, dev)
    x = torch.from_numpy(audio).to(dev) if spectrogram or waveform else None
    if spectrogram:
        out["spectrogram"] = log_mel_spectrogram(
            x, sample_rate, 1024, hop_length, mels, 50.0, 8000.0
        ).cpu().numpy()
    if phase:
        out["phase"] = phase_track(audio, sample_rate, hop_length)
    if waveform:
        out["waveform"] = frame_rate_waveform(
            x, sample_rate, hop_length).cpu().numpy()
    return out


extract_features.calls = 0
