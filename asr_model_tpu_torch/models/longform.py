"""Long-form chunked transcription, and the serving feature frontend.

The counterpart of ``asr_model_tpu/models/longform.py``:

* the waveform is cut into fixed ``chunk_sec`` windows with
  ``overlap_sec`` of overlap, the last one zero-padded, so every chunk
  has one shape;
* each chunk runs the frontend, the encoder and the greedy decode,
  prompted with the last ``carry_tokens`` tokens of the transcript so
  far (lexical continuity without attending across chunks);
* each chunk's prompt echo is stripped, its EOS / PAD dropped, and the
  chunks' tokens are joined.

``transcribe_long_sp`` is the sequence-parallel form: no chunks, the
whole utterance's features zero-padded to a multiple of the mesh axis
(each block at least the encoder's halo) and decoded once by
``generate.py:greedy_decode_sp``.

``features`` is the frontend ``Transcriber`` and the long-form decode
share: log-mel, the pitch track ("dio": DIO + StoneMask on the device,
``ops/dio.py``; "dio_host": the native host DIO + StoneMask of the
training features, ``asr_model_tpu_torch/native``; "yin":
``ops/pitch.py``) and the frame-rate waveform of a (B, L) batch, each
cast to the model's dtype.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from asr_model_tpu_torch.config import EOS_ID, PAD_ID
from asr_model_tpu_torch.models.generate import (greedy_decode_prompted,
                                                 greedy_decode_sp)
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops.audio import frame_rate_waveform
from asr_model_tpu_torch.ops.mel import log_mel_spectrogram

PITCH_MODES = ("dio", "dio_host", "yin")


def check_pitch_estimator(name: str) -> None:
    if name not in PITCH_MODES:
        raise ValueError(f"unknown pitch estimator {name!r}")


def features(audio: torch.Tensor, sample_rate: int, hop: int, mels: int,
             dtype, pitch_mode: Optional[str] = "dio"):
    """(mel (B, mels, T), pitch (B, 1, T) or None, waveform (B, 1, T'))
    of audio (B, L), cast to ``dtype``; ``pitch_mode`` None skips the
    pitch track."""
    mel = log_mel_spectrogram(audio, sample_rate, 1024, hop, mels)
    wave = frame_rate_waveform(audio, sample_rate, hop)
    T = mel.shape[-1]
    f0 = None
    if pitch_mode is not None:
        check_pitch_estimator(pitch_mode)
        period = hop / sample_rate * 1000.0
        if pitch_mode == "dio":
            from asr_model_tpu_torch.ops.dio import dio_pitch_track
            f0 = dio_pitch_track(audio, sample_rate, frame_period=period)[0]
        elif pitch_mode == "dio_host":
            # the native host DIO + StoneMask of the training features,
            # one row at a time
            from asr_model_tpu_torch.native import pitch_track_host
            rows = audio.detach().cpu().numpy()
            f0 = torch.from_numpy(np.concatenate(
                [pitch_track_host(r, sample_rate, hop) for r in rows])
            ).to(audio.device)
        else:
            from asr_model_tpu_torch.ops.pitch import yin_f0
            f0 = yin_f0(audio, fs=sample_rate, frame_period=period)[0]
        f0 = torch.nn.functional.pad(f0, (0, max(T - f0.shape[-1], 0)))
        f0 = f0[:, None, :T].to(dtype)
    return mel.to(dtype), f0, wave.to(dtype)


def chunk_audio(audio: np.ndarray, sample_rate: int = 16000,
                chunk_sec: float = 30.0, overlap_sec: float = 2.0
                ) -> List[np.ndarray]:
    """Fixed-size overlapping chunks (the last one zero-padded)."""
    n = len(audio)
    size = int(chunk_sec * sample_rate)
    stride = size - int(overlap_sec * sample_rate)
    chunks, start = [], 0
    while start < n:
        c = audio[start:start + size]
        if len(c) < size:
            c = np.pad(c, (0, size - len(c)))
        chunks.append(np.asarray(c, np.float32))
        if start + size >= n:
            break
        start += stride
    return chunks


@torch.no_grad()
def transcribe_long(model: Model, audio: np.ndarray, tokenizer=None,
                    sample_rate: int = 16000, chunk_sec: float = 30.0,
                    overlap_sec: float = 2.0,
                    max_new_tokens_per_chunk: int = 150,
                    carry_tokens: int = 8, hop: int = 160,
                    use_pitch: bool = True, use_waveform: bool = True,
                    pitch_estimator: str = "dio"):
    """Transcribe audio of any length on the model's device.  Returns
    (ids, text or None)."""
    check_pitch_estimator(pitch_estimator)
    # the features follow the weights' dtype (bf16 serving casts both)
    dev, dtype = model.device, next(model.parameters()).dtype
    out_ids: List[int] = []
    prompt: List[int] = []
    for chunk in chunk_audio(np.asarray(audio, np.float32), sample_rate,
                             chunk_sec, overlap_sec):
        mel, pitch, wave = features(
            torch.from_numpy(chunk)[None].to(dev), sample_rate, hop,
            model.dims.mels, dtype,
            pitch_estimator if use_pitch else None)
        ids = greedy_decode_prompted(
            model, torch.tensor([prompt], dtype=torch.long, device=dev),
            spectrogram=mel, pitch=pitch,
            waveform=wave if use_waveform else None,
            max_new_tokens=max_new_tokens_per_chunk)
        gen = ids[0, 1 + len(prompt):].tolist()
        out_ids.extend(t for t in gen if t not in (PAD_ID, EOS_ID))
        prompt = out_ids[-carry_tokens:] if carry_tokens else []
    text = tokenizer.decode(out_ids) if tokenizer is not None else None
    return out_ids, text


@torch.no_grad()
def transcribe_long_sp(model: Model, audio: np.ndarray, mesh, tokenizer=None,
                       sample_rate: int = 16000, hop: int = 160,
                       axis: str = "seq", max_new_tokens: int = 600,
                       use_pitch: bool = True, use_waveform: bool = True,
                       pitch_estimator: str = "dio"):
    """Single-pass sequence-parallel transcription over ``mesh``'s
    ``axis`` (every rank of it calls this with the whole audio).
    Returns (ids, text or None) as ``transcribe_long``."""
    from asr_model_tpu_torch.parallel.seq import encoder_halo
    check_pitch_estimator(pitch_estimator)
    dev, dtype = model.device, next(model.parameters()).dtype
    mel, pitch, wave = features(
        torch.from_numpy(np.asarray(audio, np.float32))[None].to(dev),
        sample_rate, hop, model.dims.mels, dtype,
        pitch_estimator if use_pitch else None)
    n = mesh.shape[axis]
    T = mel.shape[-1]
    t_local = max((T + n - 1) // n, encoder_halo(model.dims.layer))
    pad = lambda x: torch.nn.functional.pad(x, (0, t_local * n - x.shape[-1]))
    ids = greedy_decode_sp(
        model, mesh, spectrogram=pad(mel),
        pitch=pad(pitch) if use_pitch else None,
        waveform=pad(wave) if use_waveform else None, axis=axis,
        max_new_tokens=max_new_tokens)
    out = [t for t in ids[0, 1:].tolist() if t not in (PAD_ID, EOS_ID)]
    text = tokenizer.decode(out) if tokenizer is not None else None
    return out, text
