"""The port's host-side native code: its own copies of the JAX package's
``native/world.cpp`` (DIO + StoneMask, the reference's pyworld pair),
``native/flac.cpp`` (the FLAC decoder LibriSpeech needs) and
``native/wer.cpp`` (the word-level edit distance of the eval WER), each
compiled by ``g++`` at first use into ``asr_model_tpu_torch/_build/
native/<hash of the source>/lib<name>.so`` (git-ignored) and loaded with
``ctypes``.  A failed build raises.  ``world_dio``, ``world_stonemask``,
``world_cheaptrick``, ``world_d4c``, ``read_flac`` and
``wer_levenshtein`` keep the JAX package's signatures
(``asr_model_tpu/native/__init__.py``)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD = Path(__file__).resolve().parents[1] / "_build" / "native"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
SOURCES = ("world", "flac", "wer")

_lock = threading.Lock()
_libs: dict = {}
_dbl = ctypes.POINTER(ctypes.c_double)
_i32 = ctypes.POINTER(ctypes.c_int32)
_int = ctypes.POINTER(ctypes.c_int)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "world":
        lib.world_dio.argtypes = [
            _dbl, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _dbl, _dbl]
        lib.world_dio.restype = ctypes.c_longlong
        lib.world_stonemask.argtypes = [
            _dbl, ctypes.c_longlong, ctypes.c_int, _dbl, _dbl,
            ctypes.c_longlong, _dbl]
        lib.world_stonemask.restype = ctypes.c_int
        for fn in (lib.world_cheaptrick, lib.world_d4c):
            fn.argtypes = [_dbl, ctypes.c_longlong, ctypes.c_int, _dbl,
                           _dbl, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_double, _dbl]
            fn.restype = ctypes.c_int
    elif name == "flac":
        lib.flac_info.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, _int, _int, _int,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.flac_info.restype = ctypes.c_int
        lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    _i32, ctypes.c_longlong]
        lib.flac_decode.restype = ctypes.c_longlong
    elif name == "wer":
        lib.wer_levenshtein.argtypes = [_i32, ctypes.c_int, _i32,
                                        ctypes.c_int]
        lib.wer_levenshtein.restype = ctypes.c_int


def library(name: str = "world") -> ctypes.CDLL:
    """Build (once per source version) and load the library of
    ``<name>.cpp`` (one of ``SOURCES``)."""
    if name not in SOURCES:
        raise ValueError(f"no native source {name!r} (one of {SOURCES})")
    with _lock:
        if name in _libs:
            return _libs[name]
        src = HERE / f"{name}.cpp"
        h = hashlib.sha256((" ".join(FLAGS)).encode() + src.read_bytes())
        out = BUILD / h.hexdigest()[:16] / f"lib{name}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *FLAGS, str(src), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
            except (OSError, subprocess.CalledProcessError) as e:
                raise RuntimeError(f"building {src.name} with g++ failed: "
                                   f"{getattr(e, 'stderr', e)}") from e
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(name, lib)
        _libs[name] = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_dbl)


def world_dio(x, fs: int, frame_period: float = 10.0,
              f0_floor: float = 71.0, f0_ceil: float = 800.0,
              channels_in_octave: float = 2.0, allowed_range: float = 0.1):
    """DIO F0 estimation: (f0, t) float64, 1 + floor(1000 n / fs /
    frame_period) frames."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64).reshape(-1))
    nf = int(1000.0 * x.shape[0] / fs / frame_period) + 1
    f0 = np.empty(nf, dtype=np.float64)
    t = np.empty(nf, dtype=np.float64)
    got = library("world").world_dio(
        _ptr(x), x.shape[0], fs, frame_period, f0_floor, f0_ceil,
        channels_in_octave, allowed_range, _ptr(f0), _ptr(t))
    if got < 0:
        raise RuntimeError("world_dio failed")
    return f0[:got], t[:got]


def world_stonemask(x, f0, t, fs: int):
    """StoneMask refinement of a DIO track: f0 float64."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64).reshape(-1))
    f0 = np.ascontiguousarray(np.asarray(f0, dtype=np.float64))
    t = np.ascontiguousarray(np.asarray(t, dtype=np.float64))
    out = np.empty_like(f0)
    rc = library("world").world_stonemask(
        _ptr(x), x.shape[0], fs, _ptr(f0), _ptr(t), f0.shape[0], _ptr(out))
    if rc != 0:
        raise RuntimeError("world_stonemask failed")
    return out


def _world_spectral(fname: str, x, f0, t, fs: int, fft_size: int,
                    knob: float):
    """One of WORLD's per-frame spectral analyses: (frames, fft_size // 2
    + 1) float64."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64).reshape(-1))
    f0 = np.ascontiguousarray(np.asarray(f0, dtype=np.float64))
    t = np.ascontiguousarray(np.asarray(t, dtype=np.float64))
    out = np.empty((f0.shape[0], fft_size // 2 + 1), dtype=np.float64)
    rc = getattr(library("world"), fname)(
        _ptr(x), x.shape[0], fs, _ptr(f0), _ptr(t), f0.shape[0], fft_size,
        knob, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"{fname} failed")
    return out


def world_cheaptrick(x, f0, t, fs: int, fft_size: int = 256,
                     q1: float = -0.15):
    """CheapTrick spectral envelope of a DIO + StoneMask track: (frames,
    fft_size // 2 + 1) float64 power."""
    return _world_spectral("world_cheaptrick", x, f0, t, fs, fft_size, q1)


def world_d4c(x, f0, t, fs: int, fft_size: int = 256,
              threshold: float = 0.85):
    """D4C band aperiodicity of a DIO + StoneMask track: (frames,
    fft_size // 2 + 1) float64 in [0, 1]."""
    return _world_spectral("world_d4c", x, f0, t, fs, fft_size, threshold)


def pitch_track_host(audio, sample_rate: int = 16000,
                     hop_length: int = 160) -> np.ndarray:
    """DIO + StoneMask at frame period hop / sr * 1000 ms on the host:
    (1, T) float32 (the JAX package's ``pitch_track(..., "dio")``)."""
    period = hop_length / sample_rate * 1000.0
    f0, t = world_dio(audio, sample_rate, frame_period=period)
    f0 = world_stonemask(audio, f0, t, sample_rate)
    return np.asarray(f0, dtype=np.float32)[None, :]


def read_flac(path: str):
    """Decode a FLAC file: (data, sample_rate), data float32 in [-1, 1),
    (samples,) mono or (channels, samples).  A malformed stream raises
    RuntimeError."""
    lib = library("flac")
    with open(path, "rb") as f:
        raw = f.read()
    sr, ch, bps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    total = ctypes.c_longlong()
    rc = lib.flac_info(raw, len(raw), ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(bps), ctypes.byref(total))
    if rc != 0:
        raise RuntimeError(f"not a FLAC stream: {path}")
    # total_samples may be 0 (unknown): over-allocate from the byte size
    n = int(total.value) or (len(raw) * 8 // max(bps.value, 1) + 65536)
    cap = n * ch.value
    out = np.empty(cap, dtype=np.int32)
    got = lib.flac_decode(raw, len(raw), out.ctypes.data_as(_i32), cap)
    if got < 0:
        raise RuntimeError(f"FLAC decode failed ({got}) for {path}")
    data = (out[: got * ch.value].astype(np.float32)
            / float(1 << (bps.value - 1)))
    if ch.value > 1:
        data = data.reshape(-1, ch.value).T
    return data, int(sr.value)


def wer_levenshtein(ref, hyp) -> int:
    """Edit distance between two sequences of int32 word ids."""
    r = np.ascontiguousarray(np.asarray(ref, dtype=np.int32).reshape(-1))
    h = np.ascontiguousarray(np.asarray(hyp, dtype=np.int32).reshape(-1))
    return int(library("wer").wer_levenshtein(
        r.ctypes.data_as(_i32), r.shape[0], h.ctypes.data_as(_i32),
        h.shape[0]))
