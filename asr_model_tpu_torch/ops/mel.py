"""Log-mel spectrogram frontend.

The reference feature pipeline: n_fft=1024, hop=160, periodic Hann
window, center=True with zero padding, power 2, HTK mel scale,
f_min=50, f_max=8000, 128 mels, no filterbank norm, then Whisper-style
compression ``clamp(1e-10).log10(); max(x, x.max() - 8); (x + 4) / 4``
with the max taken per utterance.

``mel_spectrogram`` runs the fused CUDA kernel on a CUDA tensor
(``ops/cuda/mel.py``) and the framing + rfft path on a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(
        np.float32)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int = 513, f_min: float = 50.0,
                   f_max: float = 8000.0, n_mels: int = 128,
                   sample_rate: int = 16000) -> np.ndarray:
    """Triangular HTK mel filterbank (n_freqs, n_mels), float32
    (torchaudio melscale_fbanks with norm=None, mel_scale='htk')."""
    all_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(..., N) -> (..., 1 + N // hop, n_fft) frames; center=True pads
    n_fft // 2 zeros on both sides."""
    if center:
        audio = F.pad(audio, (n_fft // 2, n_fft // 2))
    return audio.unfold(-1, n_fft, hop_length)


def power_spectrogram(audio: torch.Tensor, n_fft: int = 1024,
                      hop_length: int = 160) -> torch.Tensor:
    """|STFT|^2, shape (..., n_fft // 2 + 1, n_frames)."""
    frames = frame_signal(audio, n_fft, hop_length)
    window = torch.from_numpy(hann_window(n_fft)).to(audio.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16000,
                    n_fft: int = 1024, hop_length: int = 160,
                    n_mels: int = 128, f_min: float = 50.0,
                    f_max: float = 8000.0) -> torch.Tensor:
    """(N,) -> (n_mels, T) or (B, N) -> (B, n_mels, T) power mel."""
    from asr_model_tpu_torch.ops.cuda import mel as K
    single = audio.dim() == 1
    x = audio[None] if single else audio
    out = K.mel_spectrogram(x.contiguous(), sample_rate, n_fft, hop_length,
                            n_mels, f_min, f_max)
    return out[0] if single else out


def whisper_compress(mel: torch.Tensor) -> torch.Tensor:
    """log10 with a 1e-10 floor, clipped at the utterance's max - 8,
    then (x + 4) / 4.  The max is over the whole tensor: one utterance
    (see ``log_mel_spectrogram`` for a batch)."""
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    log_mel = torch.maximum(log_mel, log_mel.max() - 8.0)
    return (log_mel + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16000,
                        n_fft: int = 1024, hop_length: int = 160,
                        n_mels: int = 128, f_min: float = 50.0,
                        f_max: float = 8000.0) -> torch.Tensor:
    """The full frontend: power mel + Whisper compression, the max taken
    per utterance (per row of a (B, N) batch, as ``bench.py``'s vmap
    over utterances does)."""
    mel = mel_spectrogram(audio, sample_rate, n_fft, hop_length, n_mels,
                          f_min, f_max)
    if mel.dim() == 2:
        return whisper_compress(mel)
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    top = log_mel.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_mel, top - 8.0) + 4.0) / 4.0
