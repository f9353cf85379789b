"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``asr_model_tpu_torch/csrc/`` is compiled for
``sm_90a`` by ``nvcc`` (one process per source, all started together)
and linked into one shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use, from the package's
sources only, into ``asr_model_tpu_torch/_build/<hash>/`` where the
hash covers the sources and the flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is.

Nothing here runs at import time: a machine without ``nvcc`` or a card
imports the package and runs the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libasr_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path."""
    out_dir = BUILD / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *CFLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, failed = [], []
        for src, obj, p in procs:
            log, _ = p.communicate()
            if verbose or p.returncode:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode:
                failed.append(src.name)
            objs.append(obj)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)      # atomic: concurrent builds agree
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.asr_cuda_error_string.restype = ctypes.c_char_p
            _lib.asr_cuda_error_string.argtypes = [ctypes.c_int]
        return _lib


_fns: dict = {}


def function(name: str, argtypes):
    """A C entry point of the library with its argument types set."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return fn


def eval_only(name: str, gate: str, tensors) -> None:
    """Refuse a call autograd would need a gradient of: the eval-only
    kernels (every one but flash) have no backward, and the model routes
    around them off the eval route (``gate``).  ``tensors`` is a
    callable returning the call's tensors, read only where grad mode is
    on (the decode runs under no_grad and pays no more than the test)."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors()):
        raise RuntimeError(
            f"{name} is an eval-only kernel (no backward) and autograd "
            f"needs a gradient of its inputs; the model calls it only on "
            f"the eval route ({gate}): run it under torch.no_grad, or "
            "train through Model.forward(train=True)")


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().asr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")


PP = ctypes.POINTER(ctypes.c_void_p)


def ptr_array(ptrs):
    """A C array of device pointers (None for an absent entry)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def workspace(device, nbytes):
    """One device allocation carved into 256-byte-aligned pieces of the
    given sizes: (the buffer, which the caller keeps until its launches
    are enqueued, and the pieces' pointers)."""
    import torch
    offs, total = [], 0
    for n in nbytes:
        offs.append(total)
        total += -(-int(n) // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offs]


TC_KC = 64


def tc_ring_bytes(mt: int, nj: int, a_smem: bool, w_kn: bool,
                  stages: int) -> int:
    """Bytes of the bf16 operand ring of ``csrc/mma.cuh:tc_gemm`` for a
    tile of 16 mt rows and 64 nj / mt columns, ``stages`` k chunks deep
    (``tc_ring_elems``)."""
    cols = 64 * nj // mt
    a = 0 if a_smem else 16 * mt * (TC_KC + 8)
    w = TC_KC * (cols + 8) if w_kn else cols * (TC_KC + 8)
    return 2 * stages * (a + w)
