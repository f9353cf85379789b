"""Power mel spectrogram: the CUDA kernel ``csrc/mel.cu`` and its plain
PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/mel_kernel.py:pallas_mel_spectrogram``
(the fused frame / window / DFT / power / mel Pallas kernel).  The
function is bound by its f32 operations: a real FFT, the power and the
filterbank's nonzero entries.  The TPU kernel computed the windowed DFT
as two products (13x the FFT's operations) to use the MXU; this kernel
does the real FFT in shared memory instead (a half-length complex
Stockham FFT and the real split), reads frames straight from the
waveform at the hop stride, and takes the mel product over each
filter's nonzero band (``mel_bands``).  Only the waveform and the mel
output cross device memory.  Any other ``n_fft`` from 64 to 4096 (odd
included; Whisper's 400) takes Bluestein's algorithm: the DFT as a
circular convolution of power-of-two length done by two FFTs
(``bluestein_tables``).  n_fft below 64 or past 4096, and more than 256
mels, take the direct DFT (``mel_dft_kernel``: a thread a frequency bin,
8 frames a block, as the Pallas kernel's basis products sum it).  Where
not even one frame and its power fit a block's shared memory (n_fft past
about 38,700) the same sums run over device memory: the global route's
two launches (``mel_dft_global_power``, a thread a bin of 8 frames, the
power into a scratch; ``mel_dft_global_bands``; ``launch_plan``,
``mel_spectrogram.routes["global"]``).  See the source for the design.
"""

from __future__ import annotations

import numpy as np
import torch

from asr_model_tpu_torch.ops.cuda import build as B

_DEVICE_CONSTS: dict = {}


def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float32: exp(-2 pi i k / n_fft) for k < n_fft, made in
    float64 (real, imaginary)."""
    w = np.exp(-2j * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


MIN_FFT, MAX_FFT, MAX_MELS = 64, 4096, 256   # the FFT routes' sizes
DFT_FRAMES = 8                                 # frames a DFT block
SMEM_MAX = 232448


def is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def dft_frames(n_fft: int, hop: int) -> int:
    """Frames a block of the direct-DFT route takes: 8, or 1 where 8
    frames' power would not fit in shared memory, 0 where not even one
    fits (``csrc/mel.cu:mel_dft_frames``)."""
    smem = lambda tf: 4 * ((tf - 1) * hop + n_fft + tf * (n_fft // 2 + 1))
    return (DFT_FRAMES if smem(DFT_FRAMES) <= SMEM_MAX
            else 1 if smem(1) <= SMEM_MAX else 0)


def route(n_fft: int, n_mels: int) -> str:
    """The kernel a size takes: "fft" (a power of two in 64..4096),
    "bluestein" (any other n_fft there), both up to 256 mels; else
    "dft"."""
    if MIN_FFT <= n_fft <= MAX_FFT and n_mels <= MAX_MELS:
        return "fft" if is_pow2(n_fft) else "bluestein"
    return "dft"


def launch_plan(b: int, n: int, n_fft: int, hop: int, n_mels: int) -> dict:
    """What a call on (b, n) audio launches: its ``route`` ("fft",
    "bluestein", "dft", or "global" where ``dft_frames`` is 0), the
    kernel launches, the frames and, on the global route, the bytes of
    its power scratch."""
    r = route(n_fft, n_mels)
    frames = 1 + (n + 2 * (n_fft // 2) - n_fft) // hop
    if r == "dft" and dft_frames(n_fft, hop) == 0:
        return dict(route="global", launches=2, frames=frames,
                    power_bytes=4 * b * frames * (n_fft // 2 + 1))
    return dict(route=r, launches=1, frames=frames)


def bluestein_len(n_fft: int) -> int:
    """The convolution length of Bluestein's algorithm: the least power
    of two >= 2 n_fft - 1 (``csrc/mel.cu:mel_bluestein_len``)."""
    return 1 << (2 * n_fft - 2).bit_length()


def bluestein_tables(n_fft: int):
    """The Bluestein kernel's tables, made in float64 and stored as
    (., 2) float32 (real, imaginary): wc[n] = win[n] exp(-i pi n^2 /
    n_fft) for n < n_fft, bf = FFT_L(b) / L of the chirp b[m] = exp(i pi
    m^2 / n_fft) wrapped to length L (b[L - m] = b[m] for 0 < m <
    n_fft), and the twiddles exp(-2 pi i k / L) for k < L / 2."""
    from asr_model_tpu_torch.ops.mel import hann_window
    n_len = bluestein_len(n_fft)
    n = np.arange(n_fft, dtype=np.int64)
    ph = np.pi * ((n * n) % (2 * n_fft)) / n_fft      # exact n^2 mod 2N
    win = hann_window(n_fft).astype(np.float64)
    wc = win * np.exp(-1j * ph)
    chirp = np.zeros(n_len, dtype=np.complex128)
    chirp[:n_fft] = np.exp(1j * ph)
    chirp[n_len - n_fft + 1:] = np.exp(1j * ph[1:])[::-1]
    bf = np.fft.fft(chirp) / n_len
    tw = np.exp(-2j * np.pi * np.arange(n_len // 2) / n_len)
    pack = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return pack(wc), pack(bf), pack(tw)


def mel_bands(fb: np.ndarray):
    """The (F, n_mels) filterbank as the kernel's band table: (n_mels, 3)
    int32 rows (first nonzero bin, band length, offset into the weights)
    and the bands' weights packed in mel order, float32."""
    rows, weights, off = [], [], 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        lo, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        rows.append((lo, n, off))
        weights.append(fb[lo:lo + n, m])
        off += n
    return (np.asarray(rows, dtype=np.int32),
            np.concatenate(weights).astype(np.float32))


def _consts(device, sample_rate, n_fft, n_mels, f_min, f_max):
    """The kernel's tables on the device: (win, tw, wc, bf, band, bw);
    win and tw of the power-of-two and direct-DFT kernels, or None, wc,
    bf and tw of the Bluestein one."""
    from asr_model_tpu_torch.ops.mel import hann_window, mel_filterbank
    key = (str(device), sample_rate, n_fft, n_mels, f_min, f_max)
    if key not in _DEVICE_CONSTS:
        band, bw = mel_bands(mel_filterbank(n_fft // 2 + 1, f_min, f_max,
                                            n_mels, sample_rate))
        if route(n_fft, n_mels) != "bluestein":
            win, tw, wc, bf = (hann_window(n_fft), fft_twiddles(n_fft),
                               None, None)
        else:
            win = None
            wc, bf, tw = bluestein_tables(n_fft)
        _DEVICE_CONSTS[key] = tuple(
            None if a is None
            else torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (win, tw, wc, bf, band, bw))
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
                      [B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I,
                       B.I, B.I, B.P])


def mel_spectrogram(audio, sample_rate: int = 16000, n_fft: int = 1024,
                    hop_length: int = 160, n_mels: int = 128,
                    f_min: float = 50.0, f_max: float = 8000.0):
    """(B, N) float32 audio -> (B, n_mels, T) power mel spectrogram
    (center=True, n_fft // 2 zeros a side: T = 1 + N // hop_length for an
    even n_fft; HTK filterbank).  One kernel launch for the whole batch
    on a CUDA tensor (``route``; any n_fft >= 2, any n_mels; two launches
    past the frame that fits in shared memory, ``launch_plan``); the
    plain version on a CPU tensor."""
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
    if n_mels < 1 or n_fft < 2 or hop_length < 1:
        raise ValueError("mel_spectrogram kernel takes n_mels >= 1 and an "
                         f"n_fft >= 2, got n_mels {n_mels}, n_fft {n_fft}")
    win, tw, wc, bf, band, bw = _consts(audio.device, sample_rate, n_fft,
                                        n_mels, f_min, f_max)
    b, n = audio.shape
    frames = 1 + (n + 2 * (n_fft // 2) - n_fft) // hop_length
    out = torch.empty(b, n_mels, frames, device=audio.device,
                      dtype=torch.float32)
    plan = launch_plan(b, n, n_fft, hop_length, n_mels)
    if plan["route"] == "global":
        if b > 65535:
            raise ValueError("mel_spectrogram's global route takes at most "
                             f"65535 rows, got {b}")
        ws, (pw,) = B.workspace(audio.device, [plan["power_bytes"]])
        rc = B.function("asr_mel_spectrogram_global",
                        [B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I,
                         B.I, B.I, B.P])(
            audio.data_ptr(), win.data_ptr(), tw.data_ptr(),
            band.data_ptr(), bw.data_ptr(), out.data_ptr(), pw, b, n,
            hop_length, n_fft, n_mels, B.stream_of(audio))
        B.check(rc, "asr_mel_spectrogram_global")
        n_l = plan["launches"] if b else 0
        mel_spectrogram.launches += n_l
        mel_spectrogram.routes["global"] += n_l
        return out
    if plan["route"] == "dft":
        rc = B.function("asr_mel_spectrogram_dft",
                        [B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I, B.I,
                         B.I, B.P])(
            audio.data_ptr(), win.data_ptr(), tw.data_ptr(),
            band.data_ptr(), bw.data_ptr(), out.data_ptr(), b, n,
            hop_length, n_fft, n_mels, B.stream_of(audio))
        B.check(rc, "asr_mel_spectrogram_dft")
    else:
        rc = _launch()(audio.data_ptr(), B.ptr(win), tw.data_ptr(),
                       B.ptr(wc), B.ptr(bf), band.data_ptr(), bw.data_ptr(),
                       out.data_ptr(), b, n, hop_length, n_fft, n_mels,
                       B.stream_of(audio))
        B.check(rc, "asr_mel_spectrogram")
    mel_spectrogram.launches += 1 if b else 0
    return out


mel_spectrogram.launches = 0
mel_spectrogram.routes = {"global": 0}
