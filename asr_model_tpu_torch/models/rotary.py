"""Signal-adaptive rotary embedding.

The complex rotation's magnitude is the L2 norm of a conditioning
tensor, so q/k are rotated and rescaled per position.  Frequency
ladders: the acoustic gammatone scale for non-causal calls, theta-log
spacing for causal self-attention.  Only the first 2 * (hd // 2)
channels rotate; the rest pass through.  The magnitude is shaped
(B, 1, T, 1), correct for any batch size.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from asr_model_tpu_torch.config import THETA
from asr_model_tpu_torch.models.tlayers import param


def gammatone_freqs(dims: int, head: int, min_freq: float = 200.0,
                    max_freq: float = 8000.0) -> np.ndarray:
    """Log-spaced acoustic frequencies in kHz."""
    lin = np.linspace(0, 1, (dims // head) // 2, dtype=np.float32)
    f = (max_freq / min_freq) ** lin * min_freq
    return (f / 1000.0).astype(np.float32)


def wideband_freqs(dims: int, head: int,
                   max_freq: float = 8000.0) -> np.ndarray:
    """A mel-derived frequency ladder in kHz (head_dim // 2,)."""
    head_dim = dims // head
    mel_max = 2595.0 * np.log10(1.0 + max_freq / 700.0)
    mel_scale = 10.0 ** (np.linspace(0, mel_max, head_dim // 2)
                         / 2595.0) - 1.0
    return (700.0 * mel_scale / 1000.0).astype(np.float32)


def compute_freqs(dims: int, head: int, causal: bool, theta: float = THETA,
                  dtype=np.float32) -> np.ndarray:
    """Per-channel angular frequencies (head_dim // 2,).  float64
    reproduces the reference's float64 arithmetic (including the log of
    an f32 theta)."""
    head_dim = dims // head
    if np.dtype(dtype) == np.float64:
        if not causal:
            lin = np.linspace(0.0, 1.0, head_dim // 2)
            g = (8000.0 / 200.0) ** lin * 200.0 / 1000.0
            return 200.0 * g / 1000.0
        idx = np.arange(0, head_dim, 2, dtype=np.float64)
        log_theta = float(np.log(np.float32(theta), dtype=np.float32))
        return idx / head_dim * log_theta
    if not causal:
        return (200.0 * gammatone_freqs(dims, head) / 1000.0).astype(
            np.float32)
    idx = np.arange(0, head_dim, 2, dtype=np.float32)
    return (idx / head_dim * math.log(theta)).astype(np.float32)


class Rotary(nn.Module):
    def __init__(self, dims: int, head: int, theta: float = THETA,
                 device=None, dtype=None):
        super().__init__()
        self.dims, self.head, self.theta = dims, head, theta
        half = (dims // head) // 2
        # kept for checkpoint parity with the reference; never applied
        self.lin_kernel = param(dims, half, device=device, dtype=dtype)
        self.lin_bias = param(half, device=device, dtype=dtype)
        self._freqs: dict = {}

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.lin_kernel.zero_()
            self.lin_bias.zero_()

    def freqs(self, causal: bool, dtype, device) -> torch.Tensor:
        key = (causal, dtype, str(device))
        if key not in self._freqs:
            np_dt = np.float64 if dtype == torch.float64 else np.float32
            self._freqs[key] = torch.from_numpy(compute_freqs(
                self.dims, self.head, causal, self.theta, dtype=np_dt)).to(
                device)
        return self._freqs[key]

    def forward(self, x, cond, causal: bool, offset: int = 0):
        """x (B, H, T, hd) rotated by positions offset.. and scaled by
        ||cond|| per position (cond (B, T, D))."""
        half = (self.dims // self.head) // 2
        ft = torch.float64 if x.dtype == torch.float64 else torch.float32
        t = torch.arange(x.shape[2], dtype=ft, device=x.device) + offset
        f = t[:, None] * self.freqs(causal, ft, x.device)[None, :]
        sq = torch.sum(cond * cond, dim=-1, keepdim=True)[:, None]
        m = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq,
                                                       torch.ones_like(sq))),
                        torch.zeros_like(sq))
        cos = m * torch.cos(f)
        sin = m * torch.sin(f)
        x1 = x[..., :2 * half]
        a, b = x1[..., 0::2], x1[..., 1::2]
        rot = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
        rot = rot.reshape(x1.shape).to(x.dtype)
        return torch.cat([rot, x[..., 2 * half:]], dim=-1)
