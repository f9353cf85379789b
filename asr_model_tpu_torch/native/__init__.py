"""The port's host-side native code: its own copy of the JAX package's
``native/world.cpp`` (DIO + StoneMask, the reference's pyworld pair),
compiled by ``g++`` at first use into ``asr_model_tpu_torch/_build/
native/<hash of the source>/libworld.so`` (git-ignored) and loaded with
``ctypes``.  ``world_dio`` and ``world_stonemask`` keep the JAX
package's signatures (``asr_model_tpu/native/__init__.py``)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "world.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build" / "native"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_dbl = ctypes.POINTER(ctypes.c_double)


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the WORLD library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256((" ".join(FLAGS)).encode() + SRC.read_bytes())
        out = BUILD / h.hexdigest()[:16] / "libworld.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
            except (OSError, subprocess.CalledProcessError) as e:
                raise RuntimeError(f"building {SRC.name} with g++ failed: "
                                   f"{getattr(e, 'stderr', e)}") from e
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.world_dio.argtypes = [
            _dbl, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _dbl, _dbl]
        lib.world_dio.restype = ctypes.c_longlong
        lib.world_stonemask.argtypes = [
            _dbl, ctypes.c_longlong, ctypes.c_int, _dbl, _dbl,
            ctypes.c_longlong, _dbl]
        lib.world_stonemask.restype = ctypes.c_int
        _lib = lib
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
    got = library().world_dio(_ptr(x), x.shape[0], fs, frame_period,
                              f0_floor, f0_ceil, channels_in_octave,
                              allowed_range, _ptr(f0), _ptr(t))
    if got < 0:
        raise RuntimeError("world_dio failed")
    return f0[:got], t[:got]


def world_stonemask(x, f0, t, fs: int):
    """StoneMask refinement of a DIO track: f0 float64."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float64).reshape(-1))
    f0 = np.ascontiguousarray(np.asarray(f0, dtype=np.float64))
    t = np.ascontiguousarray(np.asarray(t, dtype=np.float64))
    out = np.empty_like(f0)
    rc = library().world_stonemask(_ptr(x), x.shape[0], fs, _ptr(f0),
                                   _ptr(t), f0.shape[0], _ptr(out))
    if rc != 0:
        raise RuntimeError("world_stonemask failed")
    return out


def pitch_track_host(audio, sample_rate: int = 16000,
                     hop_length: int = 160) -> np.ndarray:
    """DIO + StoneMask at frame period hop / sr * 1000 ms on the host:
    (1, T) float32 (the JAX package's ``pitch_track(..., "dio")``)."""
    period = hop_length / sample_rate * 1000.0
    f0, t = world_dio(audio, sample_rate, frame_period=period)
    f0 = world_stonemask(audio, f0, t, sample_rate)
    return np.asarray(f0, dtype=np.float32)[None, :]
