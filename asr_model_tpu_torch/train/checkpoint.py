"""Checkpoints in the JAX package's format, without ``flax`` or
``msgpack``.

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

``write_msgpack`` is the inverse: it emits the same document (arrays as
type-1 extensions), so ``flax.serialization.from_bytes`` reads what the
port saves.  ``save_checkpoint`` / ``save_model_checkpoint`` /
``latest_checkpoint`` keep the JAX loop's names and layout: ``params``
and ``batch_stats`` in the flax trees (``weights.to_jax_params``),
``opt_state`` as optax's MaxFactor state (``step``, ``row_var``,
``col_var``, ``v``, each a tree like ``params``; wrapped in optax's
``MultiSteps`` state under gradient accumulation), ``step``, and ``rng``
(the train generator's state bytes, which the JAX loop does not save
and its restore ignores).

``restore_model`` maps ``params`` / ``batch_stats`` onto the port's
model through ``weights.from_jax_params`` and ``load_state_dict(strict=
True)``; ``load_opt_state`` puts a saved optimizer state back into the
port's ``MaxFactor``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Optional, Tuple

import numpy as np
import torch

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
    state = restore_checkpoint(path)
    return load_model_state(model, state, mono_stem, path), \
        int(state.get("step", 0))


def load_model_state(model, state: dict, mono_stem: bool = True,
                     path: str = "the state") -> dict:
    """``restore_model``'s load of an already read ``state``."""
    from asr_model_tpu_torch.weights import from_jax_params
    sd = from_jax_params(state["params"], state.get("batch_stats") or {})
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing and (mono_stem or any(not k.startswith("enc.conv2.")
                                     for k in missing)):
        raise KeyError(f"checkpoint {path} lacks {missing}")
    sd.update({k: own[k] for k in missing})
    model.load_state_dict(sd, strict=True)
    return state


# ------------------------------------------------------------------ writing

def _pack_len(out: list, n: int, small: int, fix: int, codes) -> None:
    if n < small:
        out.append(struct.pack(">B", fix | n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[0], n))
    else:
        out.append(struct.pack(">BI", codes[1], n))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(struct.pack(">B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            out.append(struct.pack(">BQ", 0xcf, obj))
        else:
            out.append(struct.pack(">Bq", 0xd3, obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        if len(raw) < 32:
            out.append(struct.pack(">B", 0xa0 | len(raw)))
        elif len(raw) < 256:
            out.append(struct.pack(">BB", 0xd9, len(raw)))
        else:
            out.append(struct.pack(">BI", 0xdb, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(struct.pack(">BI", 0xc6, len(obj)))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 16, 0x90, (0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 16, 0x80, (0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        payload = write_msgpack([list(arr.shape), arr.dtype.name,
                                 np.ascontiguousarray(arr).tobytes()])
        out.append(struct.pack(">BIb", 0xc9, len(payload),
                               1 if isinstance(obj, np.ndarray) else 3))
        out.append(payload)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


def write_msgpack(obj) -> bytes:
    """Encode nested dicts / lists / scalars / numpy arrays as flax's
    ``to_bytes`` does (arrays as extension type 1, numpy scalars 3)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def opt_state_tree(opt, model) -> dict:
    """The optimizer state as optax lays it out (see the module doc),
    in the JAX layout of ``weights.jax_layout``."""
    from asr_model_tpu_torch.optim.maxfactor import MultiSteps
    from asr_model_tpu_torch.weights import jax_layout, set_path, to_jax_array
    inner = opt.inner if isinstance(opt, MultiSteps) else opt
    layout = jax_layout(model)
    trees = {"row_var": {}, "col_var": {}, "v": {}}
    acc = {}
    zero = np.zeros((), np.float32)
    for name, p in model.named_parameters():
        _coll, path, perm = layout[name]
        st = inner.state.get(p) or inner.init_state(p)
        for key in trees:
            got = st.get(key)
            set_path(trees[key], path,
                     zero if got is None else to_jax_array(got, None))
        if isinstance(opt, MultiSteps):
            a = opt.acc.get(p)
            set_path(acc, path, to_jax_array(
                torch.zeros_like(p) if a is None else a, perm))
    tree = {"step": np.asarray(inner.step_count, np.int32)} | trees
    if isinstance(opt, MultiSteps):
        return {"mini_step": np.asarray(opt.mini_step, np.int32),
                "gradient_step": np.asarray(opt.gradient_step, np.int32),
                "inner_opt_state": tree, "acc_grads": acc,
                "skip_state": {}}
    return tree


def load_opt_state(opt, model, tree: dict) -> None:
    """Put a saved optimizer state (``opt_state_tree``'s layout, the
    port's or the JAX loop's) back into ``opt``."""
    from asr_model_tpu_torch.optim.maxfactor import MultiSteps
    from asr_model_tpu_torch.weights import jax_layout
    inner = opt.inner if isinstance(opt, MultiSteps) else opt
    if isinstance(opt, MultiSteps):
        opt.mini_step = int(tree["mini_step"])
        opt.gradient_step = int(tree["gradient_step"])
        acc, tree = tree["acc_grads"], tree["inner_opt_state"]
    inner.step_count = int(tree["step"])
    layout = jax_layout(model)

    def at(t, path):
        for k in path:
            t = t[k]
        return t

    for name, p in model.named_parameters():
        _coll, path, perm = layout[name]
        st = inner.init_state(p)
        for key in st:
            st[key].copy_(torch.from_numpy(np.asarray(
                at(tree[key], path))).reshape(st[key].shape))
        inner.state[p] = st
        if isinstance(opt, MultiSteps):
            a = torch.from_numpy(np.asarray(at(acc, path))).to(p.device)
            inv = None if perm is None else tuple(np.argsort(perm))
            opt.acc[p] = (a if inv is None else a.permute(*inv)).to(
                p.dtype).contiguous()


def training_state(model, opt, step: int, gen=None) -> dict:
    """The saved state of a run: params, batch_stats, opt_state, step
    and (when given) the generator's state as ``rng``."""
    from asr_model_tpu_torch.weights import to_jax_params
    params, batch_stats = to_jax_params(model)
    state = {"params": params, "opt_state": opt_state_tree(opt, model),
             "batch_stats": batch_stats, "step": int(step)}
    if gen is not None:
        state["rng"] = gen.get_state().numpy()
    return state


def save_checkpoint(path: str, state: dict) -> str:
    """Write ``state`` (nested dicts of numpy arrays and scalars) to
    ``path`` atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(write_msgpack(state))
    os.replace(tmp, path)
    return path


def save_model_checkpoint(checkpoint_dir: str, global_step: int,
                          state: dict) -> str:
    """``checkpoint_step_{global_step}.msgpack`` in ``checkpoint_dir``."""
    return save_checkpoint(os.path.join(
        checkpoint_dir, f"checkpoint_step_{global_step}.msgpack"), state)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The ``checkpoint_step_*`` file of the highest step, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    cands = [f for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint_step_") and f.endswith(".msgpack")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f.split("_")[-1].split(".")[0]))
    return os.path.join(checkpoint_dir, cands[-1])
