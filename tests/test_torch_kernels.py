"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These tests need an NVIDIA GPU (``cuda`` marker): without one
they skip.  ``python3 chip_smoke.py`` runs the same comparisons at the
main path's shapes on the card.

Tolerances: f32 1e-4 relative to the output's scale (sums in another
order), bf16 storage 2e-2 (one bf16 rounding of the output, and of the softmax
weights before the PV product in flash), mel 2e-3 (the kernel's f32
shared-memory FFT against torch's FFT path).  The whole-call decode kernels
(attention, MLP, router) chain several products and norms: f32 1e-4,
bf16 5e-2 (a bf16 rounding at each stage, where a near tie may round or
route a value the other way)."""

import numpy as np
import pytest
import torch

from asr_model_tpu_torch.ops.cuda import (abby, attention, dio, mel, mlp,
                                          router, sheath, xattn)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("shape", [(2, 160000), (3, 16000)])
def test_mel_kernel(dev, shape, n_mels):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*shape, device=dev, generator=g)
    got = mel.mel_spectrogram(x, n_mels=n_mels)
    want = mel.mel_spectrogram_plain(x, n_mels=n_mels)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_fft", [64, 256, 2048, 4096])
def test_mel_kernel_fft_sizes(dev, n_fft):
    """Every stage mix of the FFT: M = n_fft / 2 = 32 (8 x 4), 128 (8 x 8
    x 2), 1024 (8^3 x 2), 2048 (8^3 x 4)."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(2, 8000, device=dev, generator=g)
    kw = dict(n_fft=n_fft, hop_length=n_fft // 4, n_mels=40)
    got = mel.mel_spectrogram(x, **kw)
    want = mel.mel_spectrogram_plain(x, **kw)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# n_fft no power of two (Bluestein's algorithm): Whisper's 400 at 80
# mels, odd sizes, the largest; 1024 at 256 mels (the power-of-two kernel,
# two passes of its mel product)
@pytest.mark.parametrize("n_fft,n_mels", [(400, 80), (401, 64), (1000, 128),
                                          (4095, 256), (1024, 256),
                                          (96, 40)])
def test_mel_kernel_any_n_fft(dev, n_fft, n_mels):
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(2, 16000, device=dev, generator=g)
    kw = dict(n_fft=n_fft, hop_length=160, n_mels=n_mels)
    got = mel.mel_spectrogram(x, **kw)
    want = mel.mel_spectrogram_plain(x, **kw)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# the direct-DFT route: n_fft below 64 (16, 48) and past 4096 (4097,
# 6000, the power of two 8192), 512 mels at n_fft 2048
@pytest.mark.parametrize("n_fft,n_mels", [(16, 8), (48, 20), (4097, 128),
                                          (6000, 128), (8192, 128),
                                          (2048, 512)])
def test_mel_kernel_direct_dft(dev, n_fft, n_mels):
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(2, 16000, device=dev, generator=g)
    kw = dict(n_fft=n_fft, hop_length=160, n_mels=n_mels)
    assert mel.route(n_fft, n_mels) == "dft"
    got = mel.mel_spectrogram(x, **kw)
    want = mel.mel_spectrogram_plain(x, **kw)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_mel_kernel_refuses_other_n_fft(dev):
    """An n_fft below 2 and no mels raise (an n_fft whose single frame
    does not fit in shared memory takes the global route:
    ``test_mel_kernel_global_route``)."""
    x = torch.zeros(1, 16000, device=dev)
    for kw in (dict(n_fft=1), dict(n_mels=0)):
        with pytest.raises(ValueError):
            mel.mel_spectrogram(x, **kw)


# ------------------------------- the routes past the shared-memory plans

# n_fft past one frame in shared memory: the first (38,742) at 128 mels,
# 40,000 at 80; one and two utterances
@pytest.mark.parametrize("n_fft,n_mels,b", [(38742, 128, 1), (40000, 80, 2)])
def test_mel_kernel_global_route(dev, n_fft, n_mels, b):
    g = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn(b, 24000, device=dev, generator=g)
    kw = dict(n_fft=n_fft, hop_length=160, n_mels=n_mels)
    assert mel.launch_plan(b, 24000, n_fft, 160, n_mels)["route"] == "global"
    before = mel.mel_spectrogram.routes["global"]
    got = mel.mel_spectrogram(x, **kw)
    assert mel.mel_spectrogram.routes["global"] - before == 2
    want = mel.mel_spectrogram_plain(x, **kw)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# head widths past 1024: the first even one past (1026), 1088 and 2048,
# causal with a fully masked batch row, cross with a prefix mask
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,tq,tk,hd,causal,lens", [
    (2, 2, 70, 70, 1026, True, [70, 0]),
    (2, 1, 33, 200, 1088, False, [200, 120]),
    (1, 2, 100, 100, 2048, True, None)])
def test_flash_global_route(dev, dtype, b, h, tq, tk, hd, causal, lens):
    g = torch.Generator(device=dev).manual_seed(29)
    q, k, v = (torch.randn(b, h, t, hd, device=dev, generator=g).to(dtype)
               for t in (tq, tk, tk))
    valid = None if lens is None else (
        torch.arange(tk, device=dev)[None]
        < torch.tensor(lens, device=dev)[:, None])
    assert attention.launch_plan(b, h, tq, tk, hd, dtype)["route"] == \
        "global"
    before = attention.flash_attention.routes["global"]
    got = attention.flash_attention(q, k, v, causal=causal, kv_valid=valid)
    assert attention.flash_attention.routes["global"] - before == 3
    want = attention.attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, kv_valid=valid)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


# AbbyNormal's global route through its launch sequence at widths whose
# cluster plan fits too (the route's kernels in both dtypes, with and
# without the residual the MLP adds), and past the bf16 plan (59,520)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(33, 512), (8, 4096), (3, 100)])
def test_abby_global_route_kernels(dev, dtype, n, d):
    r = _rand(dev, 30, dtype)
    x, res = r(n, d, sc=2.0), r(n, d)
    w = tuple(_norm_w(r, d).values())
    size = abby.window_size(d)
    want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
    got = torch.empty_like(x)
    abby.abby_global(x, *w, None, got, size, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < _tol(dtype)
    abby.abby_global(x, *w, res, got, size, 1e-4, 1.0, 0.75)
    want = (res.float() + abby.abby_values(x, *w, size, 1e-4, 1.0, 0.75)
            ).to(dtype)
    assert _rel(got, want) < _tol(dtype)


def test_abby_global_route_past_the_plan(dev):
    n, d = 4, 59520
    assert abby.is_global(d, torch.bfloat16)
    assert not abby.is_global(59392, torch.bfloat16)
    r = _rand(dev, 31, torch.bfloat16)
    x = r(n, d, sc=2.0)
    w = tuple(_norm_w(r, d).values())
    size = abby.window_size(d)
    before = abby.fused_abby.routes["global"]
    got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
    assert abby.fused_abby.routes["global"] - before == 3
    want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < _tol(torch.bfloat16)


# more than 12 TGate types: the first past (13), 16 and 40, tensor-core
# linears (bf16, aligned) and CUDA-core ones (f32, D 100)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,nt", [(8 * 9, 512, 13), (33, 256, 16),
                                    (40, 100, 40), (8, 2304, 16)])
def test_mlp_kernel_many_types(dev, dtype, n, d, nt):
    r = _rand(dev, 32, dtype)
    args = _mlp_args(r, n, d, nt * d, nt)
    plan = mlp.launch_plan(n, d, nt * d, dtype, nt)
    assert plan["types"] == "many" and plan["launches"] == 6
    before = mlp.fused_mlp_residual.routes["types"]
    got = mlp.fused_mlp_residual(*args)
    assert mlp.fused_mlp_residual.routes["types"] - before == 6
    want = mlp.mlp_residual_plain(*args)
    assert _rel(got, want) < _tol(dtype)


# the whole attention calls past head width 1024 (the attention through
# the global route): D 2048 with one head, D 2176 with two of 1088
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads", [(2048, 1), (2176, 2)])
def test_attn_calls_global_route(dev, dtype, d, heads):
    args, kw = _cached_args(dev, dtype, 3, 9, 130, d, True, seed=33,
                            hd=d // heads)
    plan = xattn.launch_plan_cached(3, 9, 130, d, dtype, True, 132, heads)
    assert plan["route"] == "global" and plan["launches"] == 7
    before = xattn.fused_attn_cached.routes["global"]
    got = xattn.fused_attn_cached(*args, **kw)
    assert xattn.fused_attn_cached.routes["global"] - before == 7
    assert _rel(got, xattn.attn_cached_plain(*args, **kw)) < _tol(dtype)
    r = _rand(dev, 34, dtype)
    wq, wkv, wh, wo = _attn_weights(r, d, heads)
    x = r(3, 17, d, sc=0.5)
    valid = torch.arange(17, device=dev)[None] < torch.tensor(
        [[17], [9], [1]], device=dev)
    fargs = (x, x, valid, _freqs(dev, d, heads, True), wq, wkv, wh, wo)
    before = xattn.fused_attn_full.routes["global"]
    got = xattn.fused_attn_full(*fargs, causal=True, **kw)
    assert xattn.fused_attn_full.routes["global"] - before == 10
    want = xattn.attn_full_plain(*fargs, causal=True, **kw)
    assert _rel(got, want) < _tol(dtype)


# the MSheath row kernel past its shared memory: D 8448 (the first
# multiple of 128 past 8,320), both x dtypes, with and without a mask
@pytest.mark.parametrize("dtype,masked", [(torch.float32, True),
                                          (torch.bfloat16, False)])
def test_sheath_kernel_global_route(dev, dtype, masked):
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    d = 8448
    m = MSheath(d, 66, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(35))
    w = m.scan_weights()
    g = torch.Generator(device=dev).manual_seed(36)
    x = torch.randn(2 * 9, d, device=dev, generator=g).to(dtype)
    valid = (torch.arange(9, device=dev)[None] < torch.tensor(
        [[9], [4]], device=dev)) if masked else None
    assert sheath.launch_plan(18, d, d // 2, m.mem)["route"] == "global"
    sampled = torch.tensor(2, dtype=torch.int32, device=dev)
    args = (x, 2, valid, w["mem0"], sampled, w["jump_s"],
            {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
    before = sheath.fused_sheath_scan.routes["global"]
    got, act_g, js_g = sheath.fused_sheath_scan(*args)
    assert sheath.fused_sheath_scan.routes["global"] - before == 9
    want, act_w, js_w = sheath.sheath_scan_plain(*args)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)
    assert act_g.tolist() == act_w.tolist()
    assert js_g.tolist() == js_w.tolist()


# (B, H, Tq, Tk, hd, causal, valid keys per batch row (0: a fully masked
# row), or None for no kv_valid)
FLASH_CASES = {
    "self_100": (2, 2, 100, 100, 128, False, [100, 50]),
    "causal_65": (2, 2, 65, 65, 128, True, [65, 32]),
    "cross_65x300": (2, 2, 65, 300, 128, False, [300, 150]),
    "causal_9x40_masked_row": (2, 2, 9, 40, 128, True, [40, 0]),
    "self_1001": (1, 4, 1001, 1001, 128, False, None),
    "cross_65x1001_masked_row": (2, 4, 65, 1001, 128, False, [1001, 0]),
    "causal_65x300": (2, 2, 65, 300, 128, True, [300, 150]),
    "hd64": (2, 2, 100, 130, 64, False, [130, 70]),
    "hd80_causal": (2, 2, 100, 130, 80, True, None),
    "tk_ragged": (3, 2, 70, 77, 128, False, [77, 40, 1]),
    # Tq under one 64-row query tile, keys split over blocks and merged
    "cross_9x1001_split_masked_row": (2, 4, 9, 1001, 128, False, [600, 0]),
    "causal_33x700_split": (2, 2, 33, 700, 128, True, [700, 350]),
    # head width 256: the encoder-length self call and the decode's cached
    # cross call (keys split over blocks) at 2 heads of a 512-wide model
    "hd256_self_1001": (8, 2, 1001, 1001, 256, False, None),
    "hd256_cross_65x1001_masked_row": (8, 2, 65, 1001, 256, False,
                                       [1001] * 7 + [0]),
    # head widths 384 and 512 (flash_wide_kernel, both dtypes): the
    # encoder-length self call, causal with a prefix mask, and the decode's
    # cached cross call with a fully masked row
    "hd384_causal_1001_valid": (8, 4, 1001, 1001, 384, True,
                                [1001, 1000, 900, 800, 700, 500, 300, 1]),
    "hd512_causal_1001_valid": (2, 4, 1001, 1001, 512, True, [1001, 600]),
    "hd512_cross_65x1001_masked_row": (2, 4, 65, 1001, 512, False,
                                       [1001, 0]),
    # causal past head width 256 with a fully masked batch row: its key
    # tiles past the diagonal are kept (the uniform mean of V)
    "hd384_causal_200_masked_row": (2, 4, 200, 200, 384, True, [200, 0]),
    # the streaming decode's step: one query row against the 65-position
    # self/xa caches with the prefix mask, and against the 1001-frame
    # audio caches (keys split over blocks)
    "stream_1x65_prefix": (8, 4, 1, 65, 128, False, [33] * 8),
    "stream_1x1001": (8, 4, 1, 1001, 128, False, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel(dev, dtype, case):
    b, h, tq, tk, hd, causal, lens = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(b, h, t, hd, device=dev, generator=g).to(dtype)
               for t in (tq, tk, tk))
    valid = None
    if lens is not None:
        valid = torch.arange(tk, device=dev)[None] < torch.tensor(
            lens, device=dev)[:, None]
    got = attention.flash_attention(q, k, v, causal=causal, kv_valid=valid)
    want = attention.attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, kv_valid=valid)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


def test_flash_stream_step_split_counters(dev):
    """One query row against 1001 keys splits the keys over blocks; the
    merge leaves its tile counters zero for the next call, and two calls
    give the same bits."""
    g = torch.Generator(device=dev).manual_seed(28)
    q, k, v = (torch.randn(8, 4, t, 128, device=dev, generator=g).bfloat16()
               for t in (1, 1001, 1001))
    assert attention.splits(32, 1, 1001, torch.cuda.get_device_properties(
        dev).multi_processor_count) > 1
    got = attention.flash_attention(q, k, v)
    again = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert all(int(buf.abs().sum()) == 0
               for buf in attention._COUNTERS.values())
    want = attention.attention_plain(q.float(), k.float(), v.float())
    assert _rel(got, want) < 2e-2


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


# the decode paths' shapes: width 65 and 9 at the flagship width, the
# per-head norms at width 65, the encoder; 33 rows: one full 32-row tile
# and one row; D 100: rows that are no 16-byte multiple (loads, not
# cp.async) and a window of 5 taps (the kernel's general tail); D 768 and
# 1024: 128-column slices, two MMA passes a CTA (6 and 8 CTAs a cluster);
# D 1280 and 2048: 192- and 256-column slices (7 and 8 CTAs), W1's
# chunks through the ring, f32 rows half a tile at a time, windows of 65
# and 103 taps (the tail from the row)
ABBY_PATH = [(520, 512), (72, 512), (2080, 128), (8008, 512), (33, 512),
             (33, 100), (72, 768), (100, 1024), (72, 1280), (520, 2048),
             # past D 2048 the rows stay in device memory (x streamed
             # through the W1 ring in bf16, 512 columns at a time in f32),
             # windows of 115 and 205 taps
             (72, 2304), (520, 4096),
             # the streaming decode's step: 8 rows, the heads' 8 * 4
             (8, 512), (32, 128)]


@pytest.mark.parametrize("n,d", ABBY_PATH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abby_kernel_path_shapes(dev, n, d, dtype):
    g = torch.Generator(device=dev).manual_seed(12)
    r = lambda *s, sc=1.0: (sc * torch.randn(*s, device=dev, generator=g)
                            ).to(dtype)
    args = (r(n, d, sc=2.0), r(d, d, sc=d ** -0.5), r(d, sc=0.1),
            r(3, d, sc=d ** -0.5), r(3, sc=0.1))
    size = abby.window_size(d)
    got = abby.fused_abby(*args, size, 1e-4, 1.0, 0.75)
    want = abby.abby_plain(*args, size, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abby_kernel_deterministic(dev, dtype):
    """The slices' partial logits are summed in a fixed order: two calls
    give the same bits."""
    r = _rand(dev, 13, dtype)
    d = 512
    args = (r(520, d, sc=2.0), r(d, d, sc=d ** -0.5), r(d, sc=0.1),
            r(3, d, sc=d ** -0.5), r(3, sc=0.1), abby.window_size(d), 1e-4,
            1.0, 0.75)
    assert torch.equal(abby.fused_abby(*args), abby.fused_abby(*args))


def test_launch_plans_match_kernels(dev):
    """The wrappers' shared-memory formulas are the kernels' own."""
    from asr_model_tpu_torch.ops.cuda import build as B
    abby_smem = B.function("asr_abby_smem_bytes", [B.I, B.I])
    abby_cluster = B.function("asr_abby_cluster_size", [B.I])
    sheath_smem = B.function("asr_sheath_smem_bytes", [B.I, B.I, B.I])
    for d in (16, 100, 128, 512, 600, 1024, 1280, 2048, 2304, 4096, 8192):
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            plan = abby.launch_plan(1, d, dtype)
            assert abby_smem(code, d) == plan["smem"]
            assert abby_cluster(d) == plan["cluster"]
    r_rpc = B.function("asr_router_rows_per_cta", [B.I])
    r_vpl = B.function("asr_router_vpl", [B.I, B.I, B.I])
    r_fold = B.function("asr_router_fold_in_smem", [B.I, B.I, B.I])
    r_smem = B.function("asr_router_smem_bytes", [B.I, B.I, B.I])
    t_rpc = B.function("asr_abby_tail_rows_per_cta", [B.I])
    t_in = B.function("asr_abby_tail_rows_in_smem", [B.I, B.I, B.I])
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        for n in (1, 4, 72, 260, 520, 8008):
            for d in (128, 512, 2304, 4096, 8192):
                tp = abby.tail_launch_plan(n, d, dtype)
                assert t_rpc(n) == tp["rows_per_cta"]
                assert t_in(n, d, code) == tp["rows_in_smem"]
                for nt in (2, 3, 8, 12):
                    rp = router.launch_plan(n, d, nt, dtype)
                    assert r_rpc(n) == rp["rows_per_cta"]
                    assert r_vpl(d, n, code) == rp["vpl"]
                    assert r_fold(d, nt, code) == rp["fold_in_smem"]
                    assert r_smem(d, nt, code) == rp["smem"]
    rows_smem = B.function("asr_xattn_rows_smem", [B.I, B.I])
    attend_smem = B.function("asr_xattn_attend_smem", [B.I, B.I, B.I])
    gates_smem = B.function("asr_mlp_gates_tc_smem", [])
    gate_cols = B.function("asr_mlp_gate_cols", [B.I])
    cached_smem = B.function("asr_xattn_cached_smem",
                             [B.I, B.I, B.I, B.I])
    for hd in xattn.HEAD_DIMS:
        for d in (128, 512, 1024, 1280, 2048):
            assert rows_smem(d, hd) == xattn.rows_smem(d, hd)
            for ta in (9, 65, 256, 1024):
                assert attend_smem(d, ta, hd) == xattn.attend_smem(d, ta, hd)
        for qr in (16, 32, 64, 80):
            for tk in (1, 129, 1001, 4096):
                for ns in (1, 2, 4, 8):
                    assert cached_smem(qr, tk, ns, hd) == xattn.cached_smem(
                        qr, tk, ns, hd)
    assert gates_smem() == mlp.gates_tc_smem()
    for nt in range(1, mlp.MAX_TYPES + 1):
        assert gate_cols(nt) == mlp.gate_cols(nt)
    for d in (100, 256, 512, 1024, 2304, 4096):
        for rows in sheath.ROW_TILES:
            for passes in (1, 2, 3):
                assert sheath_smem(rows, d, passes) == sheath.smem_bytes(
                    rows, d, passes)


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


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 5e-2


def _rand(dev, seed, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *s, sc=1.0: (sc * torch.randn(*s, device=dev, generator=g)
                               ).to(dtype)


def _norm_w(r, n):
    return {"n_w1": r(n, n, sc=n ** -0.5), "n_b1": r(n, sc=0.1),
            "n_w2": r(3, n, sc=n ** -0.5), "n_b2": r(3, sc=0.1)}


# the tail's rows: the flagship's decode widths, rows wider than its
# old one-warp-a-row limit (4608, windows of 229 taps), four rows of
# 8192 (one row a CTA), the encoder's 8008 rows (32 a CTA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(8 * 65, 512), (8 * 9, 512), (250, 2048),
                                 (8 * 9, 4608), (4, 8192), (8008, 512)])
def test_abby_tail_kernel(dev, dtype, n, d):
    r = _rand(dev, 5, dtype)
    x, lg = r(n, d, sc=2.0), r(n, 3).float()
    size = abby.window_size(d)
    got = abby.fused_abby_tail(x, lg, size, 1e-4, 1.0, 0.75)
    want = abby.abby_tail_plain(x, lg, size, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)


def test_abby_tail_kernel_unaligned_rows(dev):
    """Rows of no 16-byte multiple (D 100) copied element by element."""
    r = _rand(dev, 17, torch.bfloat16)
    x, lg = r(70, 100, sc=2.0), r(70, 3).float()
    got = abby.fused_abby_tail(x, lg, 5, 1e-4, 1.0, 0.75)
    want = abby.abby_tail_plain(x, lg, 5, 1e-4, 1.0, 0.75)
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_mod", [1, 3])
def test_router_kernel(dev, dtype, n_mod):
    r = _rand(dev, 6, dtype)
    d = 512
    args = (r(8 * 65, d), r(3, n_mod * d, sc=d ** -0.5), r(3, sc=0.1),
            r(3, n_mod * d, sc=d ** -0.5), r(3, sc=0.1), r(1), n_mod)
    got = router.fused_router_same(*args)
    want = router.router_same_plain(*args)
    assert _rel(got, want) < _tol(dtype)


# (rows, D, types): the flagship's widths 65 and 9 at nt 2, 3, 8 and 12
# (4 and 8 types a pass, two passes at 12), the streaming decode's
# step (8 rows), rows wider than the
# registers hold (D 4096 at two rows a CTA: read again), nt 8 at (8*9,
# 4096) (bf16: the fold in shared memory, 128 KB; f32: past it, folded
# into a workspace first), one row, rows of no 16-byte multiple, four
# rows a CTA (2080 rows; at D 2048, 12 types, read again, the f32 fold
# in a workspace)
ROUTER_SHAPES = [(8 * 65, 512, 2), (8 * 65, 512, 3), (8 * 9, 512, 3),
                 (8, 512, 3),
                 (8 * 65, 512, 8), (8 * 9, 512, 12), (8 * 65, 512, 12),
                 (520, 4096, 3), (8 * 9, 4096, 8), (1, 512, 3),
                 (40, 100, 5), (2080, 512, 3), (2080, 2048, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,nt", ROUTER_SHAPES)
def test_router_kernel_shapes(dev, dtype, n, d, nt):
    r = _rand(dev, 18, dtype)
    n_mod = 3
    args = (r(n, d), r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1),
            r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1), r(1), n_mod)
    got = router.fused_router_same(*args)
    want = router.router_same_plain(*args)
    assert _rel(got, want) < _tol(dtype)


def test_router_kernel_ties_and_determinism(dev):
    """Equal top scores (identical weight rows) route as the plain
    version does -- the first occurrence ranks first -- and two calls
    give the same bits."""
    r = _rand(dev, 19, torch.float32)
    d, nt, n_mod = 512, 6, 2
    tw = r(nt, n_mod * d, sc=d ** -0.5)
    tw[3] = tw[1]
    tw[5] = tw[1]
    args = (r(8 * 65, d), tw, torch.zeros(nt, device=dev),
            r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1),
            torch.full((1,), 0.3, device=dev), n_mod)
    got = router.fused_router_same(*args)
    assert _rel(got, router.router_same_plain(*args)) < 1e-4
    assert torch.equal(got, router.fused_router_same(*args))


def _mlp_args(r, n, d, hid=None, nt=3):
    hid = hid or 3 * d
    return (r(n, d), tuple(_norm_w(r, d).values()), r(nt, d, sc=d ** -0.5),
            r(nt, sc=0.1), [(r(d, d, sc=d ** -0.5), r(d, sc=0.1))
                            for _ in range(nt)],
            r(hid, d, sc=d ** -0.5), r(hid, sc=0.1),
            r(d, hid, sc=hid ** -0.5), r(d, sc=0.1),
            abby.window_size(d), 1e-4, 1.0, 0.75)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [12, 8 * 65, 8 * 9, 8])
def test_mlp_kernel(dev, dtype, n):
    r = _rand(dev, 7, dtype)
    args = _mlp_args(r, n, 512)
    got = mlp.fused_mlp_residual(*args)
    want = mlp.mlp_residual_plain(*args)
    assert _rel(got, want) < _tol(dtype)


# rows no 16-byte multiple (the CUDA-core products in bf16 too), one to
# eight gates, a hidden width of no 64-column
# multiple, D 1280 and 2048 (hidden 6144: the CUDA-core product's rows in
# two 2048-column pieces)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,hid,nt", [(40, 100, 300, 1), (33, 256, 776, 4),
                                        (70, 1024, 3072, 2),
                                        (8 * 65, 512, 1536, 8),
                                        (40, 256, 776, 7),
                                        (40, 1280, 3840, 3),
                                        (33, 2048, 6144, 3),
                                        # past D 2048: the norms' rows in
                                        # device memory, the CUDA-core
                                        # gates 2048 columns of h0 a time
                                        (8 * 9, 2304, 6912, 3),
                                        (8 * 9, 4096, 12288, 3),
                                        # 12 gates: 8 columns of each a
                                        # tensor-core CTA
                                        (40, 256, 776, 12)])
def test_mlp_kernel_other_widths(dev, dtype, n, d, hid, nt):
    r = _rand(dev, 15, dtype)
    args = _mlp_args(r, n, d, hid, nt)
    got = mlp.fused_mlp_residual(*args)
    want = mlp.mlp_residual_plain(*args)
    assert _rel(got, want) < _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_kernel_deterministic(dev, dtype):
    """Sums in a fixed order, no float atomics: two calls, same bits."""
    args = _mlp_args(_rand(dev, 16, dtype), 8 * 65, 512)
    assert torch.equal(mlp.fused_mlp_residual(*args),
                       mlp.fused_mlp_residual(*args))


def _attn_weights(r, d, heads):
    wq = _norm_w(r, d) | {"proj_w": r(d, d, sc=d ** -0.5),
                          "proj_b": r(d, sc=0.1)}
    wkv = _norm_w(r, d) | {"proj_w": r(2 * d, d, sc=d ** -0.5),
                           "proj_b": r(2 * d, sc=0.1)}
    wo = {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    return wq, wkv, _norm_w(r, d // heads), wo


def _freqs(dev, d, heads, causal):
    from asr_model_tpu_torch.models.rotary import compute_freqs
    return torch.from_numpy(compute_freqs(d, heads, causal)).to(dev)


KW = dict(head=4, size_d=abby.window_size(512),
          size_h=abby.window_size(128), alpha=1e-4, k=1.0, beta=0.75)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_attn_cached_kernel(dev, dtype, masked):
    r = _rand(dev, 8, dtype)
    wq, _, wh, wo = _attn_weights(r, 512, 4)
    x, kn, v = r(3, 20, 512, sc=0.5), r(3, 4, 150, 128), r(3, 4, 150, 128)
    valid = (torch.arange(150, device=dev)[None] < torch.tensor(
        [[150], [70], [0]], device=dev)) if masked else None
    args = (x, kn, v, valid, _freqs(dev, 512, 4, False), wq, wh, wo)
    got = xattn.fused_attn_cached(*args, **KW)
    want = xattn.attn_cached_plain(*args, **KW)
    assert _rel(got, want) < _tol(dtype)


def _cached_args(dev, dtype, b, t, tk, d, masked, seed=24, hd=128):
    """A cached call's arguments: x (b, t, d), a processed cache of tk
    keys a head of width hd, the decode's prefix mask with the last row
    fully masked."""
    r = _rand(dev, seed, dtype)
    heads = d // hd
    wq, _, wh, wo = _attn_weights(r, d, heads)
    x = r(b, t, d, sc=0.5)
    kn, v = r(b, heads, tk, hd), r(b, heads, tk, hd)
    valid = None
    if masked:
        lens = (tk - 3 * torch.arange(b, device=dev)).clamp(min=1)
        lens[-1] = 0
        valid = torch.arange(tk, device=dev)[None] < lens[:, None]
    args = (x, kn, v, valid, _freqs(dev, d, heads, False), wq, wh, wo)
    return args, dict(KW, head=heads, size_d=abby.window_size(d),
                      size_h=abby.window_size(hd))


# the key-split cluster across every key count the gate admits at D 512
# (up to 4096): one key, one key block short and whole, one past a
# whole number of blocks, the flagship's 1001, the gate's limit
@pytest.mark.parametrize("tk", [1, 9, 1001, 1024, 1025, 4096])
@pytest.mark.parametrize("width", [65, 9])
def test_attn_cached_kernel_keys(dev, tk, width):
    args, kw = _cached_args(dev, torch.bfloat16, 8, width, tk, 512, tk > 1)
    before = xattn.fused_attn_cached.launches
    got = xattn.fused_attn_cached(*args, **kw)
    assert xattn.fused_attn_cached.launches - before == 2
    want = xattn.attn_cached_plain(*args, **kw)
    assert _rel(got, want) < _tol(torch.bfloat16)


# the fused decode's cached calls at the flagship shapes, both dtypes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [65, 9])
def test_attn_cached_kernel_flagship(dev, dtype, width):
    args, kw = _cached_args(dev, dtype, 8, width, 1001, 512, True)
    got = xattn.fused_attn_cached(*args, **kw)
    want = xattn.attn_cached_plain(*args, **kw)
    assert _rel(got, want) < _tol(dtype)


def test_attn_cached_kernel_deterministic(dev):
    """Partials summed in rank order, no float atomics: two calls, the
    same bits."""
    args, kw = _cached_args(dev, torch.bfloat16, 8, 65, 1001, 512, True)
    assert torch.equal(xattn.fused_attn_cached(*args, **kw),
                       xattn.fused_attn_cached(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,cross", [(False, False), (True, False),
                                          (False, True)])
def test_attn_full_kernel(dev, dtype, causal, cross):
    r = _rand(dev, 9, dtype)
    wq, wkv, wh, wo = _attn_weights(r, 512, 4)
    x = r(3, 33, 512, sc=0.5)
    ta = 47 if cross else 33
    xa = r(3, ta, 512, sc=0.5) if cross else x
    valid = torch.arange(ta, device=dev)[None] < torch.tensor(
        [[ta], [17], [1]], device=dev)
    args = (x, xa, valid, _freqs(dev, 512, 4, causal), wq, wkv, wh, wo)
    got = xattn.fused_attn_full(*args, causal=causal, **KW)
    want = xattn.attn_full_plain(*args, causal=causal, **KW)
    assert _rel(got, want) < _tol(dtype)


def _flagship_sheath(dev):
    """The flagship's MSheath (D 512, M 64, D2 256, L 4) in bf16, whose
    upcast weights are exact in TF32."""
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(512, 4, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(14))
    return m.to(torch.bfloat16)


@pytest.mark.parametrize("width,masked", [(65, True), (9, False)])
def test_sheath_kernel_flagship(dev, width, masked):
    m = _flagship_sheath(dev)
    w = m.scan_weights()
    assert not sheath.kernel_weights(
        {k: w[k] for k in sheath.WEIGHT_NAMES}, 4)["split"]
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(8 * width, 512, device=dev, generator=g).bfloat16()
    valid = None
    if masked:
        valid = (torch.arange(width, device=dev)[None]
                 < torch.arange(8, device=dev)[:, None] + 40)
    for act in (0, 2):
        sampled = torch.tensor(act, dtype=torch.int32, device=dev)
        args = (x, 8, valid, w["mem0"], sampled, w["jump_s"],
                {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
        got, act_g, js_g = sheath.fused_sheath_scan(*args)
        want, act_w, js_w = sheath.sheath_scan_plain(*args)
        assert _rel(got, want) < 2e-2
        assert act_g.tolist() == act_w.tolist()
        assert js_g.tolist() == js_w.tolist()


# more batch rows than one pass of the memory EMA holds (64): the
# decode widths 9 and 65 and the encoder's 1001 frames at B = 128
@pytest.mark.parametrize("width,masked", [(9, False), (65, True),
                                          (1001, True)])
def test_sheath_kernel_batch_128(dev, width, masked):
    m = _flagship_sheath(dev)
    w = m.scan_weights()
    g = torch.Generator(device=dev).manual_seed(25)
    b = 128
    x = torch.randn(b * width, 512, device=dev, generator=g).bfloat16()
    valid = None
    if masked:
        valid = (torch.arange(width, device=dev)[None]
                 < (width - torch.arange(b, device=dev)[:, None] % width))
    for act in (0, 2):
        sampled = torch.tensor(act, dtype=torch.int32, device=dev)
        args = (x, b, valid, w["mem0"], sampled, w["jump_s"],
                {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
        got, act_g, js_g = sheath.fused_sheath_scan(*args)
        want, act_w, js_w = sheath.sheath_scan_plain(*args)
        assert _rel(got, want) < 2e-2
        assert act_g.tolist() == act_w.tolist()
        assert js_g.tolist() == js_w.tolist()


def test_sheath_kernel_ragged_width(dev):
    """D 100: a last weight chunk of 4 rows, score and adapter columns
    padded to 128 (a cluster of 2), f32 weights split three ways."""
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(100, 2, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(18))
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn(3 * 21, 100, device=dev, generator=g)
    w = m.scan_weights()
    sampled = torch.tensor(1, dtype=torch.int32, device=dev)
    args = (x, 3, None, w["mem0"], sampled, w["jump_s"],
            {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
    got, act_g, js_g = sheath.fused_sheath_scan(*args)
    want, act_w, js_w = sheath.sheath_scan_plain(*args)
    assert _rel(got, want) < 1e-4
    assert act_g.tolist() == act_w.tolist()
    assert js_g.tolist() == js_w.tolist()


@pytest.mark.parametrize("flagship", [False, True])
def test_sheath_kernel_deterministic(dev, flagship):
    """Every reduction runs in a fixed order: two calls give the same
    bits (x, actions and jstat)."""
    if flagship:
        m, d, x_dtype = _flagship_sheath(dev), 512, torch.bfloat16
    else:
        from asr_model_tpu_torch.models.sheath import MSheath
        from asr_model_tpu_torch.models.tlayers import reset_all
        m, d, x_dtype = MSheath(256, 2, 4, device=dev), 256, torch.float32
        reset_all(m, torch.Generator(device=dev).manual_seed(16))
    w = m.scan_weights()
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(8 * 1001 if flagship else 4 * 33, d, device=dev,
                    generator=g).to(x_dtype)
    sampled = torch.tensor(1, dtype=torch.int32, device=dev)
    args = (x, 8 if flagship else 4, None, w["mem0"], sampled, w["jump_s"],
            {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
    a, b = sheath.fused_sheath_scan(*args), sheath.fused_sheath_scan(*args)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("width,masked", [(65, True), (9, False)])
def test_sheath_kernel_bf16_exact_f32(dev, width, masked):
    """The main path's two-product variant at f32 accuracy: the flagship
    MSheath's weights rounded to bf16 but kept as f32 parameters, f32 x,
    so the kernel streams bf16 weights and splits only the activations
    (1e-4, as test_sheath_kernel holds the three-product variant)."""
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(512, 4, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(20))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(p.bfloat16().float())
    w = m.scan_weights()
    sw = {k: w[k] for k in sheath.WEIGHT_NAMES}
    assert not sheath.kernel_weights(sw, 4)["split"]
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(8 * width, 512, device=dev, generator=g)
    valid = None
    if masked:
        valid = (torch.arange(width, device=dev)[None]
                 < torch.arange(8, device=dev)[:, None] + 40)
    for act in (0, 2):
        sampled = torch.tensor(act, dtype=torch.int32, device=dev)
        args = (x, 8, valid, w["mem0"], sampled, w["jump_s"], sw, 4, 0.3)
        got, act_g, js_g = sheath.fused_sheath_scan(*args)
        want, act_w, js_w = sheath.sheath_scan_plain(*args)
        assert _rel(got, want) < 1e-4
        assert act_g.tolist() == act_w.tolist()
        assert js_g.tolist() == js_w.tolist()


# (D, M): more than 8 slices of 64 columns, two passes a CTA (768 and
# 1024 channels; three and four at 1280 and 2048; M + D2 = 936 at D 512: memory logits on CTAs 0-7, and
# on CTAs 0-2 again in the second pass, slice 10 part memory, part MLP);
# memory logits on three CTAs (M 160); D 90, rows that are no multiple
# of four values
SHEATH_WIDE = [(768, 64), (1024, 64), (512, 680), (256, 160), (90, 64),
               (1280, 64), (2048, 64)]


@pytest.mark.parametrize("d,mem", SHEATH_WIDE)
def test_sheath_kernel_wide(dev, d, mem):
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(d, 2, 4, mem=mem, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(22))
    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(4 * 21, d, device=dev, generator=g)
    valid = (torch.arange(21, device=dev)[None] < torch.tensor(
        [[21], [13], [2], [8]], device=dev))
    w = m.scan_weights()
    for act in (0, 1):
        sampled = torch.tensor(act, dtype=torch.int32, device=dev)
        args = (x, 4, valid, w["mem0"], sampled, w["jump_s"],
                {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
        got, act_g, js_g = sheath.fused_sheath_scan(*args)
        want, act_w, js_w = sheath.sheath_scan_plain(*args)
        assert _rel(got, want) < 1e-4
        assert act_g.tolist() == act_w.tolist()
        assert js_g.tolist() == js_w.tolist()


# past D 2048 (the rows in the f32 state, read from L2): the first and
# the last widths the decode gate's 1M elements admit there, (8*9, 2304)
# and (8*17, 4096), with a prefix mask; f32 weights (split products) and
# the bf16 model's (bf16 x, weights exact in bf16)
@pytest.mark.parametrize("b,t,d", [(8, 9, 2304), (8, 17, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sheath_kernel_past_2048(dev, b, t, d, dtype):
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(d, 2, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(28))
    m = m.to(dtype)
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(b * t, d, device=dev, generator=g).to(dtype)
    valid = (torch.arange(t, device=dev)[None]
             < torch.arange(b, device=dev)[:, None] % t + 1)
    w = m.scan_weights()
    assert sheath.launch_plan(b * t, d, d // 2, 64)["wide"]
    for act in (0, 2):
        sampled = torch.tensor(act, dtype=torch.int32, device=dev)
        args = (x, b, valid, w["mem0"], sampled, w["jump_s"],
                {k: w[k] for k in sheath.WEIGHT_NAMES}, 4, 0.3)
        got, act_g, js_g = sheath.fused_sheath_scan(*args)
        want, act_w, js_w = sheath.sheath_scan_plain(*args)
        assert _rel(got, want) < (1e-4 if dtype == torch.float32 else 2e-2)
        assert act_g.tolist() == act_w.tolist()
        assert js_g.tolist() == js_w.tolist()


def _full_args(dev, dtype, b, t, ta, d, cross, causal, masked, seed=17,
               hd=128):
    r = _rand(dev, seed, dtype)
    heads = d // hd
    wq, wkv, wh, wo = _attn_weights(r, d, heads)
    x = r(b, t, d, sc=0.5)
    xa = r(b, ta, d, sc=0.5) if cross else x
    valid = None
    if masked:                     # the decode's prefix mask, one row empty
        lens = (ta - torch.arange(b, device=dev)).clamp(min=1)
        lens[-1] = 0
        valid = torch.arange(ta, device=dev)[None] < lens[:, None]
    args = (x, xa, valid, _freqs(dev, d, heads, causal), wq, wkv, wh, wo)
    kw = dict(KW, head=heads, size_d=abby.window_size(d),
              size_h=abby.window_size(hd))
    return args, kw


# the fused decode's full calls at the flagship width: the self calls
# (causal with the prefix mask, non-causal) and the g block's cross call
# (and the streaming model's causal one, x and xa position-aligned), at
# the last and the first bucket's width
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [65, 9])
@pytest.mark.parametrize("causal,cross", [(True, False), (False, False),
                                          (False, True), (True, True)])
def test_attn_full_kernel_flagship(dev, dtype, width, causal, cross):
    args, kw = _full_args(dev, dtype, 8, width, width, 512, cross, causal,
                          True)
    got = xattn.fused_attn_full(*args, causal=causal, **kw)
    want = xattn.attn_full_plain(*args, causal=causal, **kw)
    assert _rel(got, want) < _tol(dtype)


# the longest key sets the gate admits (256 at D 512, 1024 at D 128), one
# past the one-pass limit (the CUDA-core launches), D 1024 (8 heads)
@pytest.mark.parametrize("b,t,ta,d", [(2, 65, 256, 512), (2, 33, 1024, 128),
                                      (2, 9, 1025, 128), (2, 20, 40, 1024)])
def test_attn_full_kernel_long_keys(dev, b, t, ta, d):
    args, kw = _full_args(dev, torch.bfloat16, b, t, ta, d, True, False,
                          True)
    got = xattn.fused_attn_full(*args, causal=False, **kw)
    want = xattn.attn_full_plain(*args, causal=False, **kw)
    assert _rel(got, want) < _tol(torch.bfloat16)


# D 1280 (10 heads: a launch-2 cluster of 8, two CTAs with two heads) and
# 2048 (16 heads, two each; the longest key set the gate admits there),
# both whole calls in both dtypes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,ta", [(1280, 65), (2048, 64)])
def test_attn_kernels_wide(dev, dtype, d, ta):
    args, kw = _full_args(dev, dtype, 2, 33, ta, d, True, False, True)
    got = xattn.fused_attn_full(*args, causal=False, **kw)
    want = xattn.attn_full_plain(*args, causal=False, **kw)
    assert _rel(got, want) < _tol(dtype)
    args, kw = _cached_args(dev, dtype, 2, 33, 1024, d, True)
    got = xattn.fused_attn_cached(*args, **kw)
    want = xattn.attn_cached_plain(*args, **kw)
    assert _rel(got, want) < _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_full_kernel_deterministic(dev, dtype):
    """Sums in a fixed order, no float atomics: two calls, same bits."""
    args, kw = _full_args(dev, dtype, 8, 65, 65, 512, False, True, True)
    assert torch.equal(xattn.fused_attn_full(*args, causal=True, **kw),
                       xattn.fused_attn_full(*args, causal=True, **kw))


# head width 256 (a 512-wide model with 2 heads): both whole calls at the
# decode widths, the cached call against 1001 keys and the 4096 the gate
# admits, both dtypes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [65, 9])
@pytest.mark.parametrize("causal,cross", [(True, False), (False, True)])
def test_attn_full_kernel_hd256(dev, dtype, width, causal, cross):
    args, kw = _full_args(dev, dtype, 8, width, width, 512, cross, causal,
                          True, hd=256)
    got = xattn.fused_attn_full(*args, causal=causal, **kw)
    want = xattn.attn_full_plain(*args, causal=causal, **kw)
    assert _rel(got, want) < _tol(dtype)


# the widths past the two-launch routes (the wide route), at the
# first bucket's width (x (8, 9, D), inside the gate's 400k elements):
# D 1536 with 4 heads of 384, D 2048 with 4 of 512, D 4096 with 32 of
# 128; the cached call against 1001 keys (512 at D 4096, the most its
# kv_limit admits), the full call self causal with the prefix mask and
# cross against the most keys its kv_limit (256 * 512) admits
WIDE_ATTN = [(1536, 384, 1001, 85), (2048, 512, 1001, 64),
             (4096, 128, 512, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hd,tk,ta", WIDE_ATTN)
def test_attn_kernels_wide_heads(dev, dtype, d, hd, tk, ta):
    args, kw = _cached_args(dev, dtype, 8, 9, tk, d, True, hd=hd)
    before = xattn.fused_attn_cached.launches
    got = xattn.fused_attn_cached(*args, **kw)
    plan = xattn.launch_plan_cached(8, 9, tk, d, dtype, True, 132, d // hd)
    assert xattn.fused_attn_cached.launches - before == plan["launches"]
    assert _rel(got, xattn.attn_cached_plain(*args, **kw)) < _tol(dtype)
    for t, ta_, cross, causal in ((9, 9, False, True), (9, ta, True, False)):
        args, kw = _full_args(dev, dtype, 8, t, ta_, d, cross, causal, True,
                              hd=hd)
        got = xattn.fused_attn_full(*args, causal=causal, **kw)
        want = xattn.attn_full_plain(*args, causal=causal, **kw)
        assert _rel(got, want) < _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,tk", [(65, 1001), (9, 1001), (65, 4096)])
def test_attn_cached_kernel_hd256(dev, dtype, width, tk):
    args, kw = _cached_args(dev, dtype, 8, width, tk, 512, True, hd=256)
    got = xattn.fused_attn_cached(*args, **kw)
    want = xattn.attn_cached_plain(*args, **kw)
    assert _rel(got, want) < _tol(dtype)


def _contour_inputs(dev, b, nb, nf, seed):
    """DIO-like band candidates (a slow contour, 40% holes) and the best
    candidate a frame with gaps, short runs and 1.5x jumps."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = 120 + 60 * torch.sin(torch.arange(nf, device=dev) / 17.0)
    cand = base * (1 + 0.08 * torch.randn(b, nb, nf, device=dev,
                                          generator=g))
    cand = torch.where(torch.rand(b, nb, nf, device=dev, generator=g) < 0.4,
                       torch.zeros_like(cand), cand)
    f0 = cand[:, 0].clone()
    f0 = torch.where(torch.rand(b, nf, device=dev, generator=g) < 0.3,
                     torch.zeros_like(f0), f0)
    jump = torch.rand(b, nf, device=dev, generator=g) < 0.05
    return cand.contiguous(), torch.where(jump, 1.5 * f0, f0).contiguous()


# the serve path's 8 x 10 s batch, a 30 s long-form chunk, 90 s
# utterances and a tiny band count
@pytest.mark.parametrize("b,nb,nf", [(8, 7, 1001), (1, 7, 3001),
                                     (3, 7, 9000), (2, 3, 17)])
def test_dio_contour_kernel(dev, b, nb, nf):
    """The contour fix only compares and selects: exactly the plain
    version's output."""
    cand, f0 = _contour_inputs(dev, b, nb, nf, seed=nf)
    dio.dio_contour.launches = 0
    got = dio.dio_contour(cand, f0, 3, 0.1)
    want = dio.dio_contour_plain(cand, f0, 3, 0.1)
    torch.cuda.synchronize()
    assert dio.dio_contour.launches == 1
    assert torch.equal(got, want)



# ---- training: flash under autograd, the eval-only kernels refuse it

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_plain_route(dev, dtype, causal):
    """The train step's encoder-length call: the kernel forward (one
    launch) inside ``FlashTrain`` against the plain version (f32 1e-4,
    bf16 2e-2 of the output's scale), and dq / dk / dv against the plain
    route's autograd, which run the same plain backward on the same
    inputs and cotangent (1e-6 f32, 1e-3 bf16 of each gradient's
    scale)."""
    g = torch.Generator(device=dev).manual_seed(41)
    b, h, t, hd = 8, 4, 1001, 128
    q, k, v = (torch.randn(b, h, t, hd, device=dev, generator=g).to(dtype)
               for _ in range(3))
    w = torch.randn(b, h, t, hd, device=dev, generator=g)
    lens = torch.tensor([1001, 990, 950, 900, 800, 700, 600, 1], device=dev)
    valid = torch.arange(t, device=dev)[None] < lens[:, None]

    def route(fn):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, causal=causal, kv_valid=valid)
        (out.float() * w).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    attention.flash_attention.launches = 0
    got, gk = route(attention.flash_attention)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == 1
    want, gp = route(attention.attention_plain)
    want32 = attention.attention_plain(q.float(), k.float(), v.float(),
                                       causal=causal, kv_valid=valid)
    assert _rel(got, want32) < (1e-4 if dtype == torch.float32 else 2e-2)
    for a, c in zip(gk, gp):
        assert _rel(a, c) <= (1e-6 if dtype == torch.float32 else 1e-3)


def _eval_only_calls():
    t = lambda: torch.zeros(1, device="cuda")
    return {
        "fused_abby": lambda x: abby.fused_abby(x, t(), t(), t(), t(), 3,
                                                1e-4, 1.0, 0.75),
        "fused_abby_tail": lambda x: abby.fused_abby_tail(x, t(), 3, 1e-4,
                                                          1.0, 0.75),
        "fused_sheath_scan": lambda x: sheath.fused_sheath_scan(
            x, 1, None, t(), t(), t(), {}, 2, 0.3),
        "fused_attn_cached": lambda x: xattn.fused_attn_cached(
            x, t(), t(), None, t(), {}, {}, {}, 2, 3, 3, 1e-4, 1.0, 0.75),
        "fused_attn_full": lambda x: xattn.fused_attn_full(
            x, t(), None, t(), {}, {}, {}, {}, 2, 3, 3, 1e-4, 1.0, 0.75,
            False),
        "fused_mlp_residual": lambda x: mlp.fused_mlp_residual(
            x, (), t(), t(), [], t(), t(), t(), t(), 3, 1e-4, 1.0, 0.75),
        "fused_router_same": lambda x: router.fused_router_same(
            x, t(), t(), t(), t(), t(), 2)}


@pytest.mark.parametrize("name", sorted(_eval_only_calls()))
def test_eval_only_kernels_refuse_autograd(dev, name):
    """The eval-only kernels (no backward) raise, naming their gate,
    when autograd would need a gradient of their inputs; the model
    routes around them off the eval route."""
    x = torch.randn(4, 128, device=dev, requires_grad=True)
    with torch.enable_grad(), pytest.raises(RuntimeError, match="eval-only"):
        _eval_only_calls()[name](x)


@pytest.mark.parametrize("n", [4800, 8000, 21347, 31999, 480000])
def test_frame_rate_waveform_on_the_card(dev, n):
    """The data pipeline's frame-rate waveform at utterance lengths the
    synthetic dataset draws: its pooling bins (integer bounds) equal
    ``F.adaptive_avg_pool1d``'s on the card too."""
    from asr_model_tpu_torch.ops.audio import adaptive_avg_pool1d
    target = max(int((n / 16000) * (16000 // 160)), 1)
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(1, 1, n, device=dev, generator=g, dtype=torch.float64)
    got = adaptive_avg_pool1d(x, target)
    want = torch.nn.functional.adaptive_avg_pool1d(x, target)
    assert float((got - want).abs().max()) < 1e-12
