"""YIN F0 estimation (de Cheveigne & Kawahara 2002) on the device.

The on-device pitch estimator of the main path: per frame the lag
difference function (through an FFT cross-correlation and a
cumulative-sum energy), the cumulative mean normalised difference, the
first dip under the threshold descended to its local minimum (else the
global minimum), parabolic interpolation, and a voicing decision.
Unvoiced frames are 0.0; voiced frames lie in [f0_floor, f0_ceil].
Plain PyTorch: the JAX package computes it in XLA, not in a kernel.
"""

from __future__ import annotations

import torch

F0_FLOOR = 71.0
F0_CEIL = 800.0


def _yin_difference(frames: torch.Tensor, max_lag: int) -> torch.Tensor:
    """d[t, tau] = sum_{j<W} (x_j - x_{j+tau})^2, tau < max_lag, W =
    frame_len - max_lag, as e0 + e_tau - 2 * acf."""
    W = frames.shape[-1] - max_lag
    base = frames[..., :W]
    n_fft = 1
    while n_fft < frames.shape[-1]:
        n_fft *= 2
    fr = torch.fft.rfft(frames, n=n_fft, dim=-1)
    ba = torch.fft.rfft(base, n=n_fft, dim=-1)
    acf = torch.fft.irfft(torch.conj(ba) * fr, n=n_fft, dim=-1)[..., :max_lag]
    sq = torch.cumsum(frames * frames, dim=-1)
    sq = torch.cat([torch.zeros_like(sq[..., :1]), sq], dim=-1)
    tau = torch.arange(max_lag, device=frames.device)
    e_tau = sq[..., tau + W] - sq[..., tau]
    return e_tau[..., :1] + e_tau - 2 * acf


def _cmnd(d: torch.Tensor) -> torch.Tensor:
    """Cumulative mean normalised difference (YIN eq. 8)."""
    tau = torch.arange(1, d.shape[-1], device=d.device, dtype=d.dtype)
    csum = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = d[..., 1:] * tau / torch.clamp(csum, min=1e-12)
    return torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def yin_f0(x: torch.Tensor, fs: int = 16000, frame_period: float = 10.0,
           f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL,
           threshold: float = 0.15):
    """(..., N) waveform -> (f0 (..., T), t (T,)): per-frame F0 in Hz
    (0 = unvoiced) and frame times in seconds, T = 1 + N // hop."""
    x = x.float()
    dev = x.device
    hop = int(fs * frame_period / 1000.0)
    max_lag = int(fs / f0_floor) + 2
    min_lag = max(int(fs / f0_ceil) - 1, 2)
    frame_len = 2 * max_lag

    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, frame_len))
    n_frames = 1 + n // hop
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(frame_len, device=dev)[None, :])
    frames = xp[..., torch.clamp(idx, max=xp.shape[-1] - 1)]
    frames = frames - frames.mean(dim=-1, keepdim=True)

    c = _cmnd(_yin_difference(frames, max_lag))
    lags = torch.arange(max_lag, device=dev)
    lag_valid = lags >= min_lag
    c_masked = torch.where(lag_valid, c, torch.full_like(c, float("inf")))

    under = c_masked < threshold
    first_under = _first_true(under)
    any_under = under.any(dim=-1)
    global_min = torch.argmin(c_masked, dim=-1)
    c_prev = torch.cat([c_masked[..., :1], c_masked[..., :-1]], dim=-1)
    c_next = torch.cat([c_masked[..., 1:],
                        torch.full_like(c_masked[..., :1], float("inf"))],
                       dim=-1)
    is_lmin = (c_masked <= c_prev) & (c_masked <= c_next) & lag_valid
    cand = is_lmin & (lags >= first_under[..., None])
    first_lmin = _first_true(cand)
    has_lmin = cand.any(dim=-1)
    tau = torch.where(any_under & has_lmin, first_lmin, global_min)

    tm1 = torch.clamp(tau - 1, 0, max_lag - 1)
    tp1 = torch.clamp(tau + 1, 0, max_lag - 1)

    def at(i):
        return torch.gather(c, -1, i[..., None])[..., 0]

    y0, y1, y2 = at(tm1), at(tau), at(tp1)
    denom = y0 - 2 * y1 + y2
    safe = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    offset = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / safe,
                         torch.zeros_like(denom))
    tau_f = tau.float() + torch.clamp(offset, -1.0, 1.0)

    f0 = fs / torch.clamp(tau_f, min=1.0)
    energy = (frames * frames).mean(dim=-1)
    voiced = (y1 < 0.45) & (energy > 1e-7) & (f0 >= f0_floor) \
        & (f0 <= f0_ceil)
    f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    t = torch.arange(n_frames, device=dev, dtype=torch.float32) \
        * (frame_period / 1000.0)
    return f0, t
