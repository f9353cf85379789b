"""DIO + StoneMask F0 estimation on the device, batched.

The counterpart of ``asr_model_tpu/ops/dio.py`` (Morise's DIO band
candidates and StoneMask's instantaneous-frequency refinement, the
reference's pyworld pair), computed for a whole batch at once: every
step runs over a (B, bands, ...) tensor, as the JAX code's ``vmap`` over
the rows and the bands.

1. The mean-removed signal's rFFT (``fft_n`` = next_pow2(n + 4 fs /
   f0_floor + 2)), a raised-cosine low cut at 25-50 Hz; per band a
   zero-phase Nuttall low-pass (the kernels' spectra built in numpy once
   per shape) and one batched irFFT.
2. Four event tracks a band: the negative- and positive-going zero
   crossings of the band signal and of its first difference, at
   sub-sample positions.  Events are packed into ``e_max`` = n / 8 slots
   through an int32 cumulative sum (event s sits where the count first
   reaches s + 1: ``searchsorted``); intervals between them give
   f0 = fs / interval at their midpoints.  Where a track has more than
   ``e_max`` events the first ``e_max`` are kept (the JAX code writes
   every later one into the last slot, with an unspecified winner).
3. Per frame each track is linearly interpolated (``searchsorted`` over
   the +inf-padded locations, the C++ interp1's clamped segment); a
   band's candidate is the tracks' mean, its score their relative
   spread; candidates outside [floor, ceil] or [boundary / 2, boundary]
   are rejected.  The best band a frame, if its score is under 0.12.
4. The contour fix (``ops/cuda/dio.py:dio_contour``): jump kill,
   short-run drop, and the forward and backward extension scans, one
   kernel launch on the card.
5. StoneMask over all frames at once: segments of 2 * 339 + 1 samples,
   an f0-adaptive Blackman window and its derivative, rFFTs at 2048, the
   harmonics' instantaneous frequencies; the second pass is computed for
   every frame and selected, as the JAX code does; a refinement that
   drifts more than 18% keeps the DIO value.

The FFTs are PyTorch's (the JAX package runs DIO in XLA, not Pallas).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from asr_model_tpu_torch.ops.cuda import dio as dio_kernel

F0_FLOOR = 71.0
F0_CEIL = 800.0
BAD_SCORE = 100000.0


def _next_pow2(v: int) -> int:
    n = 1
    while n < v:
        n *= 2
    return n


def _nuttall(t):
    return (0.355768 - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def band_kernels(n: int, fs: int, f0_floor: float, f0_ceil: float,
                 channels_in_octave: float):
    """The bands' low-pass spectra (nb, fft_n // 2 + 1) complex64, the
    low-cut gain (fft_n // 2 + 1,), the band boundaries (nb,) and
    fft_n, in numpy (``_band_tensors`` keeps them on the device)."""
    nb = int(np.ceil(channels_in_octave * np.log2(f0_ceil / f0_floor)))
    fft_n = _next_pow2(int(n + 4.0 * fs / f0_floor + 2))
    kspec = np.zeros((nb, fft_n // 2 + 1), np.complex128)
    for b in range(nb):
        boundary = f0_floor * 2.0 ** ((b + 1) / channels_in_octave)
        half_avg = int(round(fs / boundary / 2.0))
        klen = max(4 * half_avg, 4)
        w = _nuttall(np.arange(klen) / (klen - 1))
        w = w / w.sum()
        ker = np.zeros(fft_n)
        np.add.at(ker, (np.arange(klen) - klen // 2) % fft_n, w)
        kspec[b] = np.fft.rfft(ker)
    freqs = np.arange(fft_n // 2 + 1) * fs / fft_n
    lowcut = np.where(
        freqs >= 50.0, 1.0,
        np.where(freqs <= 25.0, 0.0,
                 0.5 - 0.5 * np.cos(np.pi * (freqs - 25.0) / 25.0)))
    boundaries = f0_floor * 2.0 ** ((np.arange(nb) + 1) / channels_in_octave)
    return (kspec.astype(np.complex64), lowcut.astype(np.float32),
            boundaries.astype(np.float32), fft_n)


@functools.lru_cache(maxsize=8)
def _band_tensors(n: int, fs: int, f0_floor: float, f0_ceil: float,
                  channels_in_octave: float, device: torch.device):
    """``band_kernels`` on ``device``, uploaded once per shape."""
    kspec, lowcut, bounds, fft_n = band_kernels(n, fs, f0_floor, f0_ceil,
                                                channels_in_octave)
    return (torch.from_numpy(kspec).to(device),
            torch.from_numpy(lowcut).to(device),
            torch.from_numpy(bounds).to(device)[None, :, None], fft_n)


def _interval_tracks(y, fs: int, e_max: int):
    """Four event tracks of each band signal y (B, nb, n): the sign
    changes of y and of its difference, each way.  Returns the interval
    midpoints in seconds (B, nb, 4, e_max - 1; +inf past the last), their
    f0 and the number of intervals (B, nb, 4)."""
    n = y.shape[-1]
    dy = torch.nn.functional.pad(y[..., 1:] - y[..., :-1], (0, 1))
    sig = torch.stack([y, -y, dy, -dy], dim=2)          # (B, nb, 4, n)
    a, b = sig[..., :-1], sig[..., 1:]
    mask = (a > 0.0) & (b <= 0.0)
    mask[..., 2:, -1] = False                           # dy has n - 1 values
    frac = torch.where(mask, a / torch.where(mask, a - b,
                                             torch.ones_like(a)),
                       torch.zeros_like(a))
    csum = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    cnt = torch.clamp(csum[..., -1], max=e_max)
    # event s is the first position where the count reaches s + 1; only
    # the first e_max events are kept
    slot = torch.arange(1, e_max + 1, dtype=torch.int32, device=y.device)
    slot = slot.expand(*mask.shape[:-1], e_max).contiguous()
    pos = torch.searchsorted(csum, slot)
    live = slot <= cnt[..., None]
    ev_k = torch.where(live, pos.to(torch.int32),
                       torch.full_like(slot, -1))
    ev_f = torch.where(live, frac.gather(-1, torch.clamp(pos, max=n - 2)),
                       torch.zeros(slot.shape, dtype=y.dtype,
                                   device=y.device))
    valid = (ev_k[..., 1:] >= 0) & (ev_k[..., :-1] >= 0)
    interval = (ev_k[..., 1:] - ev_k[..., :-1]).to(y.dtype) \
        + (ev_f[..., 1:] - ev_f[..., :-1])
    ahead = interval > 0
    f0 = torch.where(valid & ahead,
                     fs / torch.where(ahead, interval,
                                      torch.ones_like(interval)),
                     torch.zeros_like(interval))
    mid = 0.5 * (ev_k[..., 1:] + ev_k[..., :-1]).to(y.dtype) \
        + 0.5 * (ev_f[..., 1:] + ev_f[..., :-1])
    loc = torch.where(valid, mid / fs, torch.full_like(mid, math.inf))
    return loc, f0, torch.clamp(cnt - 1, min=0)


def _interp1(loc, val, cnt, tq):
    """The C++ interp1 per track: the segment of each query (clamped to
    the track's intervals), linear inter- and extrapolation."""
    q = tq.expand(*loc.shape[:-1], tq.shape[-1]).contiguous()
    j = torch.searchsorted(loc.contiguous(), q, right=True) - 1
    hi = torch.clamp(cnt - 2, min=0)[..., None].expand_as(j)
    j = torch.minimum(torch.clamp(j, min=0), hi)
    x0, x1 = loc.gather(-1, j), loc.gather(-1, j + 1)
    v0, v1 = val.gather(-1, j), val.gather(-1, j + 1)
    w = (q - x0) / torch.where(x1 > x0, x1 - x0, torch.ones_like(x0))
    return v0 + w * (v1 - v0)


def dio_candidates(x, fs: int, tpos, f0_floor: float, f0_ceil: float,
                   channels_in_octave: float):
    """Band candidates (B, nb, nf) and their scores for x (B, n) f32."""
    n = x.shape[-1]
    kspec, lowcut, bounds, fft_n = _band_tensors(
        n, fs, f0_floor, f0_ceil, channels_in_octave, x.device)
    e_max = max(n // 8, 16)

    x0 = x - x.mean(dim=-1, keepdim=True)
    X = torch.fft.rfft(x0, n=fft_n) * lowcut
    y = torch.fft.irfft(X[:, None] * kspec, n=fft_n)[..., :n]
    loc, f0, cnt = _interval_tracks(y, fs, e_max)
    vs = _interp1(loc, f0, cnt, tpos)                   # (B, nb, 4, nf)
    usable = (cnt >= 2).all(dim=-1)[..., None]
    avg = vs.mean(dim=2)
    ok = usable & (avg >= f0_floor) & (avg <= f0_ceil) \
        & (avg >= bounds * 0.5) & (avg <= bounds)
    dev_ = torch.sqrt(((vs - avg[:, :, None]) ** 2).sum(dim=2) / 3.0) \
        / torch.where(avg > 0, avg, torch.ones_like(avg))
    return (torch.where(ok, avg, torch.zeros_like(avg)),
            torch.where(ok, dev_, torch.full_like(dev_, BAD_SCORE)))


def _frames(n: int, fs: int, frame_period: float, device):
    nf = int(1000.0 * n / fs / frame_period) + 1
    return torch.arange(nf, dtype=torch.float32, device=device) \
        * (frame_period / 1000.0)


def contour_inputs(x, fs: int = 16000, frame_period: float = 10.0,
                   f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL,
                   channels_in_octave: float = 2.0):
    """What the contour fix takes for x (B, n) f32: the band candidates
    (B, nb, nf), the best candidate a frame where its score is under
    0.12 (B, nf), and the frame times (nf,)."""
    tpos = _frames(x.shape[-1], fs, frame_period, x.device)
    cand_f0, cand_score = dio_candidates(x, fs, tpos, f0_floor, f0_ceil,
                                         channels_in_octave)
    best = torch.argmin(cand_score, dim=1, keepdim=True)
    bscore = cand_score.gather(1, best)[:, 0]
    bf0 = cand_f0.gather(1, best)[:, 0]
    f0 = torch.where(bscore < 0.12, bf0, torch.zeros_like(bf0))
    return cand_f0.contiguous(), f0.contiguous(), tpos


def short_run(frame_period: float, f0_floor: float = F0_FLOOR) -> int:
    """Voiced runs shorter than this many frames are dropped."""
    return int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1


def dio_f0(x, fs: int = 16000, frame_period: float = 10.0,
           f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL,
           channels_in_octave: float = 2.0, allowed_range: float = 0.1):
    """DIO of x (B, n) or (n,): (f0 (B, nf) or (nf,), t (nf,)), nf =
    1 + floor(1000 n / fs / frame_period) frames, 0 = unvoiced."""
    x = x.float()
    one = x.dim() == 1
    cand_f0, f0, tpos = contour_inputs(x.reshape(-1, x.shape[-1]), fs,
                                       frame_period, f0_floor, f0_ceil,
                                       channels_in_octave)
    f0 = dio_kernel.dio_contour(cand_f0, f0, short_run(frame_period,
                                                       f0_floor),
                                allowed_range)
    return (f0[0] if one else f0), tpos


def _refine(x, fs: int, tpos, f0, max_half: int, fft_n: int):
    """One instantaneous-frequency pass over every frame: x (B, n), f0
    (B, nf) -> (B, nf), 0 where the window does not fit or f0 is 0."""
    n = x.shape[-1]
    dev = x.device
    half = torch.round(torch.clamp(1.5 * fs / torch.clamp(f0, min=1e-9),
                                   max=float(max_half))).to(torch.int32)
    center = torch.round(tpos * fs).to(torch.int32)[None]
    fits = (center - half >= 0) & (center + half < n) & (f0 > 0)

    j = torch.arange(-max_half, max_half + 1, device=dev)
    mask = j.abs() <= half[..., None]
    t = j.to(torch.float32) * f0[..., None] / (1.5 * fs)
    win = torch.where(mask, 0.42 + 0.5 * torch.cos(math.pi * t)
                      + 0.08 * torch.cos(2 * math.pi * t),
                      torch.zeros_like(t))
    zero = torch.zeros_like(win[..., :1])
    dwin = -(torch.cat([win[..., 1:], zero], -1)
             - torch.cat([zero, win[..., :-1]], -1)) / 2.0

    xp = torch.nn.functional.pad(x, (max_half, max_half))
    start = torch.clamp(center, 0, xp.shape[-1] - (2 * max_half + 1))
    idx = (start[..., None] + max_half + j).long()      # (1, nf, 2m+1)
    seg = xp[:, None, :].expand(-1, idx.shape[1], -1).gather(
        -1, idx.expand(x.shape[0], -1, -1))
    seg = torch.where(mask, seg, torch.zeros_like(seg))

    W = torch.fft.rfft(seg * win, n=fft_n)
    D = torch.fft.rfft(seg * dwin, n=fft_n)

    h = torch.arange(1, 7, device=dev)
    n_h = torch.clamp(0.5 * fs / torch.clamp(f0, min=1e-9),
                      max=6.0).to(torch.int32)
    k = torch.round(h * f0[..., None] / fs * fft_n).to(torch.int32)
    ok = (h <= n_h[..., None]) & (k < fft_n // 2)
    kc = torch.clamp(k, 0, fft_n // 2).long()
    Wk, Dk = W.gather(-1, kc), D.gather(-1, kc)
    power = torch.abs(Wk) ** 2
    ok = ok & (power > 1e-30)
    fk = k.to(torch.float32) * fs / fft_n
    cross = Dk.real * (-Wk.imag) + Dk.imag * Wk.real
    inst = fk + cross / torch.clamp(power, min=1e-30) * fs / (2.0 * math.pi)
    amp = torch.sqrt(power)
    num = torch.where(ok, inst * amp, torch.zeros_like(amp)).sum(-1)
    den = torch.where(ok, amp * h, torch.zeros_like(amp)).sum(-1)
    refined = torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                          torch.zeros_like(den))
    return torch.where(fits & (n_h >= 1), refined, torch.zeros_like(refined))


def stonemask_f0(x, f0, t, fs: int = 16000, f0_floor: float = F0_FLOOR):
    """StoneMask: two instantaneous-frequency passes a voiced frame; a
    refinement drifting more than 18% keeps the DIO value.  x (B, n) or
    (n,), f0 of the matching (B, nf) or (nf,)."""
    one = x.dim() == 1
    x = x.float().reshape(-1, x.shape[-1])
    cur = f0.float().reshape(x.shape[0], -1)
    t = t.float()
    max_half = int(1.5 * fs / f0_floor) + 1
    fft_n = _next_pow2(2 * max_half + 1) * 2
    r1 = _refine(x, fs, t, cur, max_half, fft_n)
    r2 = torch.where(r1 > 0, _refine(x, fs, t, r1, max_half, fft_n),
                     torch.zeros_like(r1))
    refined = torch.where(r2 > 0, r2, r1)
    keep = (refined <= 0) | ((refined - cur).abs() > 0.18 * cur)
    out = torch.where(cur <= 0, torch.zeros_like(cur),
                      torch.where(keep, cur, refined))
    return out[0] if one else out


def dio_pitch_track(audio, fs: int = 16000, frame_period: float = 10.0,
                    f0_floor: float = F0_FLOOR, f0_ceil: float = F0_CEIL):
    """DIO + StoneMask of audio (B, n) or (n,): (f0, t)."""
    f0, t = dio_f0(audio, fs, frame_period, f0_floor, f0_ceil)
    return stonemask_f0(audio, f0, t, fs, f0_floor), t
