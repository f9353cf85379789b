"""Power mel spectrogram: the CUDA kernel ``csrc/mel.cu`` and its plain
PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/mel_kernel.py:pallas_mel_spectrogram``
(the fused frame / window / DFT / power / mel Pallas kernel).  The
function is bound by its f32 operations: a real FFT, the power and the
filterbank, about 160k per 1024-sample frame.  This kernel computes the
windowed DFT as the TPU kernel did, 4 * n_fft * (n_fft/2 + 1) operations
per frame, about 13x what an FFT needs, and so runs far above that
bound.  It reads frames straight from the waveform at the hop stride
(no framed copy in device memory) and keeps the power spectrum in
shared memory, so only the waveform and the mel output cross device
memory.  See the source for the design.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from asr_model_tpu_torch.ops.cuda import build as B

_DEVICE_CONSTS: dict = {}


@functools.lru_cache(maxsize=4)
def dft_bases(n_fft: int):
    """Hann-windowed DFT bases (n_fft, n_fft//2 + 1), float32: the cos
    and -sin halves of the real DFT with the window folded in."""
    from asr_model_tpu_torch.ops.mel import hann_window
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_fft)[:, None].astype(np.float64)
    f = np.arange(n_freqs)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * f / n_fft
    w = hann_window(n_fft).astype(np.float64)[:, None]
    return ((np.cos(ang) * w).astype(np.float32),
            (-np.sin(ang) * w).astype(np.float32))


def _consts(device, sample_rate, n_fft, n_mels, f_min, f_max):
    from asr_model_tpu_torch.ops.mel import mel_filterbank
    key = (str(device), sample_rate, n_fft, n_mels, f_min, f_max)
    if key not in _DEVICE_CONSTS:
        wc, ws = dft_bases(n_fft)
        fb = mel_filterbank(n_fft // 2 + 1, f_min, f_max, n_mels,
                            sample_rate)
        _DEVICE_CONSTS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (wc, ws, fb))
    return _DEVICE_CONSTS[key]


def mel_spectrogram_plain(audio, sample_rate: int = 16000,
                          n_fft: int = 1024, hop_length: int = 160,
                          n_mels: int = 128, f_min: float = 50.0,
                          f_max: float = 8000.0):
    """(B, N) f32 -> (B, n_mels, 1 + N // hop) power mel, through the
    FFT: frame, window, rfft, |.|^2, filterbank."""
    mel_spectrogram_plain.calls += 1
    from asr_model_tpu_torch.ops.mel import mel_filterbank, power_spectrogram
    spec = power_spectrogram(audio, n_fft, hop_length)         # (B, F, T)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, f_min, f_max,
                                         n_mels, sample_rate)).to(
        audio.device)
    return torch.einsum("...ft,fm->...mt", spec, fb)


mel_spectrogram_plain.calls = 0


def _launch():
    return B.function("asr_mel_spectrogram",
                      [B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I, B.I, B.I, B.I,
                       B.P])


def mel_spectrogram(audio, sample_rate: int = 16000, n_fft: int = 1024,
                    hop_length: int = 160, n_mels: int = 128,
                    f_min: float = 50.0, f_max: float = 8000.0):
    """(B, N) float32 audio -> (B, n_mels, 1 + N // hop_length) power mel
    spectrogram (center=True, zero padding; HTK filterbank).  One kernel
    launch for the whole batch on a CUDA tensor; the plain version on a
    CPU tensor."""
    if audio.device.type == "cpu":
        return mel_spectrogram_plain(audio, sample_rate, n_fft, hop_length,
                                     n_mels, f_min, f_max)
    if audio.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.dtype != torch.float32 \
            or not audio.is_contiguous():
        raise ValueError("mel_spectrogram kernel takes contiguous (B, N) "
                         f"float32 audio, got {tuple(audio.shape)} "
                         f"{audio.dtype}")
    if not 1 <= n_mels <= 128 or n_fft % 32:
        raise ValueError("mel_spectrogram kernel takes n_mels <= 128 and "
                         "n_fft a multiple of 32")
    wc, ws, fb = _consts(audio.device, sample_rate, n_fft, n_mels, f_min,
                         f_max)
    b, n = audio.shape
    out = torch.empty(b, n_mels, 1 + n // hop_length, device=audio.device,
                      dtype=torch.float32)
    rc = _launch()(audio.data_ptr(), wc.data_ptr(), ws.data_ptr(),
                   fb.data_ptr(), out.data_ptr(), b, n, hop_length, n_fft,
                   n_fft // 2 + 1, n_mels, B.stream_of(audio))
    B.check(rc, "asr_mel_spectrogram")
    mel_spectrogram.launches += 1 if b else 0
    return out


mel_spectrogram.launches = 0
