"""Package rules of the PyTorch port: it imports nothing of JAX or of the
JAX package, its entry points run on the CUDA device unless the caller
asks for the CPU, and a kernel wrapper given a CPU tensor takes its
plain version without counting a launch."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_model_tpu_torch.config import Dimensions
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.ops.cuda import (abby, attention, build, dio, mel,
                                          mlp, router, sheath, xattn)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "asr_model_tpu", "regex",
             "tokenizers", "msgpack")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN and top != "asr_model_tpu_torch"


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "asr_model_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    # the training slice's modules are among them
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"asr_model_tpu_torch/{m}" for m in (
        "cli.py", "native/__init__.py", "optim/maxfactor.py",
        "optim/schedules.py", "train/loop.py", "train/metrics.py",
        "train/checkpoint.py", "data/features.py", "data/collator.py",
        "data/dataset.py", "data/librispeech.py",
        "compat/torch_import.py")} <= names
    bad = [(str(f.relative_to(ROOT)), n) for f in files
           for n in _imports(f) if _forbidden(n)]
    assert not bad, bad


def test_training_modules_load_no_jax():
    """Importing the training CLI, the loop and the data pipeline (and
    building the native DIO) leaves every JAX module out of the
    process."""
    import subprocess
    import sys
    script = (
        "import sys\n"
        "import asr_model_tpu_torch.cli, asr_model_tpu_torch.train.loop\n"
        "import asr_model_tpu_torch.data.dataset\n"
        "import asr_model_tpu_torch.data.librispeech\n"
        "import asr_model_tpu_torch.compat\n"
        "from asr_model_tpu_torch.native import library\n"
        "for name in ('world', 'flac', 'wer'):\n"
        "    library(name)\n"
        "print(sorted(m for m in ('jax', 'flax', 'optax', 'msgpack', "
        "'asr_model_tpu') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_every_kernel_source_is_built():
    names = {p.name for p in build.sources()}
    assert names == {"abby.cu", "flash_attention.cu", "mel.cu", "sheath.cu",
                     "xattn.cu", "xattn_wide.cu", "mlp.cu", "router.cu",
                     "dio.cu"}
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert headers == {"common.cuh", "abby_tail.cuh", "abby_cluster.cuh",
                       "mma.cuh", "global_attn.cuh", "xattn.cuh"}
    assert "-gencode" in build.CFLAGS and \
        "arch=compute_90a,code=sm_90a" in build.CFLAGS
    assert len(build.source_hash()) == 16


TINY = Dimensions(tokens=32, mels=8, dims=16, head=2, layer=4)


def test_model_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        assert Model(TINY).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(TINY)
    m = Model(TINY, device="cpu")
    rng = np.random.RandomState(0)
    out = m(torch.from_numpy(rng.randint(3, 32, size=(2, 5))),
            spectrogram=torch.from_numpy(rng.randn(2, 8, 12).astype(np.float32)),
            pitch=torch.from_numpy(rng.rand(2, 1, 12).astype(np.float32)),
            waveform=torch.from_numpy(rng.randn(2, 1, 12).astype(np.float32)))
    assert out["logits"].shape == (2, 5, 32)
    assert torch.isfinite(out["logits"]).all()


def _cpu_calls():
    rng = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    d, D = 16, 256
    norm = lambda n: {"n_w1": t(n, n), "n_b1": t(n), "n_w2": t(3, n),
                      "n_b2": t(3)}
    wq = norm(D) | {"proj_w": t(D, D), "proj_b": t(D)}
    wkv = norm(D) | {"proj_w": t(2 * D, D), "proj_b": t(2 * D)}
    wh, wo = norm(128), {"proj_w": t(D, D), "proj_b": t(D)}
    return {
        "mel_spectrogram": lambda: mel.mel_spectrogram(t(2, 1600), n_mels=8),
        "flash_attention": lambda: attention.flash_attention(
            t(1, 2, 3, 8), t(1, 2, 5, 8), t(1, 2, 5, 8)),
        "fused_abby": lambda: abby.fused_abby(
            t(4, d), t(d, d), t(d), t(3, d), t(3), 3, 1e-4, 1.0, 0.75),
        "fused_sheath_scan": lambda: sheath.fused_sheath_scan(
            t(6, d), 2, None, t(d), torch.tensor(1, dtype=torch.int32),
            torch.tensor([0.1, 0.05, 0.01]),
            {"ln_scale": t(4, d), "ln_bias": t(4, d), "gate_w": t(4, d),
             "gate_b": t(4), "mkey": t(4, 8, d), "mval": t(4, 8),
             "vmlp1_w": t(4, d, d // 2), "vmlp1_b": t(4, d // 2),
             "vmlp2_w": t(4, d // 2), "vmlp2_b": t(4), "vcat_w": t(4, 2),
             "vcat_b": t(4), "adapt_w": t(2, d, d), "adapt_b": t(2, d),
             "memgate_w": t(d), "memgate_b": t(1)}, 4, 0.3),
        "fused_attn_cached": lambda: xattn.fused_attn_cached(
            t(2, 3, D), t(2, 2, 5, 128), t(2, 2, 5, 128), None, t(64),
            wq, wh, wo, 2, 13, 7, 1e-4, 1.0, 0.75),
        "fused_attn_full": lambda: xattn.fused_attn_full(
            t(2, 3, D), t(2, 4, D), None, t(64), wq, wkv, wh, wo, 2, 13, 7,
            1e-4, 1.0, 0.75, False),
        "fused_mlp_residual": lambda: mlp.fused_mlp_residual(
            t(4, d), (t(d, d), t(d), t(3, d), t(3)), t(3, d), t(3),
            [(t(d, d), t(d)) for _ in range(3)], t(3 * d, d), t(3 * d),
            t(d, 3 * d), t(d), 3, 1e-4, 1.0, 0.75),
        "fused_router_same": lambda: router.fused_router_same(
            t(4, d), t(3, 3 * d), t(3), t(3, 3 * d), t(3), t(1), 3),
        "fused_abby_tail": lambda: abby.fused_abby_tail(
            t(4, d), t(4, 3), 3, 1e-4, 1.0, 0.75),
        "dio_contour": lambda: dio.dio_contour(
            100 + 10 * t(2, 7, 30).abs(), 100 + t(2, 30).abs(), 3, 0.1),
    }


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_wrapper_on_cpu_tensor_calls_plain_and_counts_no_launch(name):
    kernels.reset_counts()
    out = _cpu_calls()[name]()
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"
    assert torch.isfinite(first.float()).all()
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 1}


def test_wrapper_refuses_other_devices():
    """No silent fallback: a tensor on a device that is neither the CPU
    nor CUDA is an error, not a plain-version call."""
    q = torch.empty(1, 1, 2, 8, device="meta")
    kernels.reset_counts()
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)
    assert kernels.counts()["flash_attention"]["plain_calls"] == 0


@pytest.mark.parametrize("bh,tq,tk,want", [
    (32, 1001, 1001, 1),      # encoder: 512 blocks fill 132 SMs
    (32, 65, 1001, 4),        # decode cached cross: 32 blocks, 16 key tiles
    (32, 9, 1001, 4),         # the first bucket's width: 32 blocks
    (32, 65, 65, 1),          # decode self: 2 key tiles, under 4 a split
    (4, 9, 40, 1),            # one key tile: nothing to split
    (8, 64, 64 * 20, 5),      # 4 key tiles a split
    (1, 64, 64 * 80, 16),     # at most 16, evened: 16 x 5 tiles
])
def test_flash_key_splits(bh, tq, tk, want):
    n = attention.splits(bh, tq, tk, 132)
    assert n == want
    nkt = -(-tk // attention.TILE)
    per = -(-nkt // n)
    assert (n - 1) * per < nkt          # every split has a key tile
    assert n == 1 or per >= attention.MIN_SPLIT_TILES


def test_mel_wrapper_shapes_on_cpu():
    a = torch.zeros(1600)
    assert mel.mel_spectrogram(a[None], n_mels=8).shape == (1, 8, 11)
    assert math.isclose(float(mel.mel_spectrogram(a[None], n_mels=8).sum()),
                        0.0)
