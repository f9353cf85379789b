"""Audio-domain helpers: sinusoidal positions and the frame-rate
waveform (adaptive average pooling to the mel frame rate, or linear
interpolation when the signal is shorter than the target)."""

from __future__ import annotations

import torch

from asr_model_tpu_torch.config import THETA


def sinusoids(ctx: int, dims: int, theta: float = THETA,
              device=None) -> torch.Tensor:
    """(ctx, dims) float32 embedding, ``[sin | cos]`` halves,
    tscales = exp(-ln(theta) / (dims//2 - 1) * arange(dims//2))."""
    half = dims // 2
    # the rate in f32 arithmetic, as the reference computes it
    rate = -torch.log(torch.tensor(theta, dtype=torch.float32,
                                   device=device)) / (half - 1)
    tscales = torch.exp(rate * torch.arange(half, dtype=torch.float32,
                                            device=device))
    scaled = torch.arange(ctx, dtype=torch.float32,
                          device=device)[:, None] * tscales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def adaptive_avg_pool1d(x: torch.Tensor, target: int) -> torch.Tensor:
    """out[i] = mean(x[floor(i L / T) : ceil((i + 1) L / T)]) over the
    last axis (``F.adaptive_avg_pool1d``), through a cumulative sum.  The
    bin bounds are integer arithmetic: a float quotient rounds past an
    integer where i L is beyond float32's exact range, and a CUDA division
    by a scalar multiplies by its rounded reciprocal, which put the last
    bound one past the array (the JAX package's ``jnp.take`` then fills
    NaN)."""
    L = x.shape[-1]
    i = torch.arange(target, device=x.device)
    start = (i * L) // target
    end = ((i + 1) * L + target - 1) // target
    csum = torch.cumsum(x, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    total = csum[..., end] - csum[..., start]
    return total / (end - start).to(x.dtype)


def linear_interpolate(x: torch.Tensor, target: int) -> torch.Tensor:
    """Linear resampling of the last axis (align_corners=False)."""
    L = x.shape[-1]
    pos = (torch.arange(target, dtype=torch.float32, device=x.device) + 0.5) \
        * (L / target) - 0.5
    pos = torch.clamp(pos, 0.0, L - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=L - 1)
    w = pos - lo.float()
    return x[..., lo] * (1 - w) + x[..., hi] * w


def frame_rate_waveform(audio: torch.Tensor, sample_rate: int = 16000,
                        hop_length: int = 160) -> torch.Tensor:
    """(N,) -> (1, target) or (B, N) -> (B, 1, target), target =
    int((N / sr) * (sr // hop))."""
    n = audio.shape[-1]
    target = max(int((n / sample_rate) * (sample_rate // hop_length)), 1)
    x = audio.reshape(*audio.shape[:-1], 1, n)
    if n > target:
        return adaptive_avg_pool1d(x, target)
    return linear_interpolate(x, target)


def peak_normalize(w: torch.Tensor) -> torch.Tensor:
    """w / max|w| where that is positive, else w."""
    m = torch.max(torch.abs(w))
    return torch.where(m > 0, w / torch.where(m > 0, m, 1.0), w)
