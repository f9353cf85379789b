"""Checkpoint restore, without ``flax`` or ``msgpack``.

The JAX training loop saves its state with ``flax.serialization.to_bytes``:
one msgpack document holding a nested map (``params``, ``opt_state``,
``batch_stats``, ``step``) whose array leaves are msgpack extension
objects (``flax/serialization.py:_msgpack_ext_pack``): type 1 an ndarray
packed again in msgpack as ``[shape, dtype name, C-order bytes]``, type 2
a complex as ``[real, imag]``, type 3 a numpy scalar packed as an
ndarray.  ``read_msgpack`` decodes that (nil, bool, int, float, str, bin,
array, map, ext) with the standard library; a ``bfloat16`` leaf is read
as its uint16 bits and widened to float32 exactly, so a bf16 cast of the
model restores the stored values.

``restore_model`` maps ``params`` / ``batch_stats`` onto the port's
model through ``weights.from_jax_params`` and ``load_state_dict(strict=
True)``; the optimizer state is read and dropped.  Saving comes with the
port's training slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",          # bin
        0xd9: ">B", 0xda: ">H", 0xdb: ">I",          # str
        0xdc: ">H", 0xdd: ">I",                      # array
        0xde: ">H", 0xdf: ">I",                      # map
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}          # ext
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _LEN:
            n = self.unpack(_LEN[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b >= 0xd9 and b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b in (0xdc, 0xdd):
                return [self.obj() for _ in range(n)]
            if b in (0xde, 0xdf):
                return self._map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, raw = read_msgpack(data)
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = read_msgpack(data)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack document (with flax's array extensions)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def _check_unchunked(tree, path=()) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(
                f"checkpoint leaf {'/'.join(path)} is split into chunks "
                "(over 2**30 bytes); the port does not read those")
        for k, v in tree.items():
            _check_unchunked(v, path + (str(k),))


def restore_checkpoint(path: str) -> dict:
    """The checkpoint's nested state: maps of numpy arrays and scalars."""
    with open(path, "rb") as f:
        state = read_msgpack(f.read())
    _check_unchunked(state)
    return state


def restore_model(model, path: str,
                  mono_stem: bool = True) -> Tuple[dict, int]:
    """Load a JAX checkpoint's ``params`` and ``batch_stats`` into the
    port's ``model`` (``load_state_dict(strict=True)``).  A parameter the
    checkpoint lacks is an error.  The one exception is the mono-channel
    stem ``enc.conv2`` when ``mono_stem`` is False: a model trained
    without pitch and waveform has none (flax creates only the modules a
    model runs), and the model keeps its own values there.  Returns (the
    checkpoint's state, its step)."""
    from asr_model_tpu_torch.weights import from_jax_params
    state = restore_checkpoint(path)
    sd = from_jax_params(state["params"], state.get("batch_stats") or {})
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing and (mono_stem or any(not k.startswith("enc.conv2.")
                                     for k in missing)):
        raise KeyError(f"checkpoint {path} lacks {missing}")
    sd.update({k: own[k] for k in missing})
    model.load_state_dict(sd, strict=True)
    return state, int(state.get("step", 0))
