"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These tests need an NVIDIA GPU (``cuda`` marker): without one
they skip.  ``python3 chip_smoke.py`` runs the same comparisons at the
main path's shapes on the card.

Tolerances: f32 1e-4 relative to the output's scale (sums in another
order), bf16 storage 2e-2 (one bf16 rounding of the output), mel 2e-3
(the kernel's DFT against the FFT path)."""

import numpy as np
import pytest
import torch

from asr_model_tpu_torch.ops.cuda import abby, attention, mel, sheath

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def test_mel_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3, 16000, device=dev, generator=g)
    got = mel.mel_spectrogram(x, n_mels=128)
    want = mel.mel_spectrogram_plain(x, n_mels=128)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,tk", [(False, 100, 100), (True, 65, 65),
                                          (False, 65, 300), (True, 9, 40)])
def test_flash_kernel(dev, dtype, causal, tq, tk):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 2, tq, 128, device=dev, generator=g).to(dtype)
    k = torch.randn(2, 2, tk, 128, device=dev, generator=g).to(dtype)
    v = torch.randn(2, 2, tk, 128, device=dev, generator=g).to(dtype)
    valid = torch.arange(tk, device=dev)[None] < torch.tensor(
        [[tk], [tk // 2]], device=dev)
    if tq == 9:
        valid[1] = False                    # fully masked rows
    got = attention.flash_attention(q, k, v, causal=causal, kv_valid=valid)
    want = attention.attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, kv_valid=valid)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abby_kernel(dev, d, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s, sc=1.0: (sc * torch.randn(*s, device=dev, generator=g)
                            ).to(dtype)
    args = (r(100, d, sc=2.0), r(d, d, sc=d ** -0.5), r(d, sc=0.1),
            r(3, d, sc=d ** -0.5), r(3, sc=0.1))
    size = abby.window_size(d)
    got = abby.fused_abby(*args, size, 1e-4, 1.0, 0.75)
    want = abby.abby_plain(*args, size, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("use_valid", [False, True])
def test_sheath_kernel(dev, use_valid):
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(256, 2, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(3))
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4 * 33, 256, device=dev, generator=g)
    valid = (torch.arange(33, device=dev)[None] < torch.tensor(
        [[33], [20], [1], [9]], device=dev)) if use_valid else None
    w = m.scan_weights()
    sampled = torch.tensor(2, dtype=torch.int32, device=dev)
    args = (x, 4, valid, w["mem0"], sampled, w["jump_s"],
            {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
    got, act_g, js_g = sheath.fused_sheath_scan(*args)
    want, act_w, js_w = sheath.sheath_scan_plain(*args)
    assert _rel(got, want) < 1e-4
    assert act_g.tolist() == act_w.tolist()
    assert js_g.tolist() == js_w.tolist()
