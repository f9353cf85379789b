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
* ``waveform``: the frame-rate waveform of ``ops/audio.py``.

The features come back as numpy arrays (the collator's input).
``pitch_tokens``, ``harmonics``, ``aperiodics`` and ``phase`` are not
ported (ROADMAP Queue 1 item 9) and raise.  ``hilbert`` is accepted and
unused, as in the reference.  ``extract_features.calls`` counts the
utterances featurised.
"""

from __future__ import annotations

from typing import Any, Dict

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
    (an error without one), "cpu" the plain route."""
    for flag, name in ((pitch_tokens, "pitch_tokens"),
                       (harmonics, "harmonics"), (aperiodics, "aperiodics"),
                       (phase, "phase")):
        if flag:
            raise NotImplementedError(
                f"feature {name!r} is not ported yet (ROADMAP Queue 1 "
                "item 9)")
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
    if pitch:
        out["pitch"] = pitch_track(audio, sample_rate, hop_length,
                                   pitch_estimator, dev)
    x = torch.from_numpy(audio).to(dev) if spectrogram or waveform else None
    if spectrogram:
        out["spectrogram"] = log_mel_spectrogram(
            x, sample_rate, 1024, hop_length, mels, 50.0, 8000.0
        ).cpu().numpy()
    if waveform:
        out["waveform"] = frame_rate_waveform(
            x, sample_rate, hop_length).cpu().numpy()
    return out


extract_features.calls = 0
