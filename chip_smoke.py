#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   CUDA kernels from ``asr_model_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card at
   the shapes of the main path, with the tolerance stated beside it, and
   times kernel, plain version and (where one PyTorch call computes the
   same function) that call.
3. Drives the main path at the flagship config (40k vocab, 512 dims, 4
   heads, 4 layers, bf16, seeded random weights): 8 x 10 s synthetic
   tones -> log-mel + YIN pitch + frame-rate waveform -> AudioEncoder ->
   per-slot re-encode and cross K/V -> greedy buffer decode of 64 tokens
   with EOS suppressed.  Every kernel must have launched in that run and
   no plain version may have run.  Then times 5 more runs (RTFx from
   their median), checks the output ids, the first decode step's
   logits on the kernel route against the plain route on the card (the
   flagship in bf16 and in f32, argmax identical in every row), and a
   small f32 model on the card against the same model's plain route on
   the CPU.
4. Prints the ``kernels`` JSON line, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR, HOP, UTT_SEC, BATCH, NEW_TOKENS = 16000, 160, 10.0, 8, 64
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12         # H100 SXM device-memory bytes/s

FAILURES: list = []


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    log(("ok    " if ok else "FAIL  ") + what)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def tones(batch: int, seconds: float):
    """bench.py's workload: per row a tone, its octave and a little
    noise, from a seed."""
    rng = np.random.RandomState(0)
    t = np.arange(int(SR * seconds)) / SR
    return np.stack([
        (np.sin(2 * np.pi * (150 + 30 * i) * t)
         + 0.3 * np.sin(2 * np.pi * 2 * (150 + 30 * i) * t)
         + 0.01 * rng.randn(len(t))).astype(np.float32)
        for i in range(batch)])


def close_rows(got, want, rtol: float, atol_frac: float, row: int):
    """Elementwise |got - want| <= rtol |want| + atol_frac max|want| over
    rows of ``row`` values; returns (max abs err, rows out of tolerance,
    rows)."""
    g = got.float().reshape(-1, row)
    w = want.float().reshape(-1, row)
    err = (g - w).abs()
    lim = rtol * w.abs() + atol_frac * float(w.abs().max())
    bad = int((err > lim).any(dim=1).sum())
    return float(err.max()), bad, g.shape[0]


# ------------------------------------------------------------ kernels

def check_kernels(model):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from asr_model_tpu_torch.ops.cuda import abby, attention, mel, sheath
    from asr_model_tpu_torch.ops.mel import mel_filterbank
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = []

    # ---- mel: (8, 160000) f32 -> (8, 128, 1001)
    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(dev)
    got = mel.mel_spectrogram(audio)
    want = mel.mel_spectrogram_plain(audio)
    err = (got - want).abs()
    ok = bool((err <= 2e-3 + 2e-3 * want.abs()).all())
    check(ok, f"mel_spectrogram (8, 160000): max abs err {float(err.max()):.3e}"
              " (tolerance |err| <= 2e-3 + 2e-3 |plain|, the FFT path)")
    window = torch.hann_window(1024, device=dev)
    fb = torch.from_numpy(mel_filterbank(513, 50.0, 8000.0, 128)).to(dev)

    def lib_mel():
        s = torch.stft(audio, 1024, 160, window=window, center=True,
                       pad_mode="constant", return_complex=True)
        return torch.einsum("bft,fm->bmt", s.real ** 2 + s.imag ** 2, fb)

    # what the function needs: per frame a real FFT (~2.5 n log2 n), the
    # power and the filterbank; the audio read once, the mel written once
    T = got.shape[-1]
    flops = BATCH * T * (2.5 * 1024 * 10 + 3 * 513 + 2.0 * 513 * 128)
    b_ms, b_by = bound_ms(flops, nbytes(audio, got), F32_PEAK)
    out.append(dict(
        name="mel_spectrogram", route="cuda",
        source="asr_model_tpu_torch/csrc/mel.cu",
        replaces="asr_model_tpu/ops/pallas/mel_kernel.py:119",
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: mel.mel_spectrogram(audio)),
        plain_ms=cuda_ms(lambda: mel.mel_spectrogram_plain(audio)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_mel),
        shape="audio (8, 160000) f32"))

    # ---- flash attention, bf16: encoder, decode self, cached cross
    H, hd = 4, 128
    shapes = [("encoder self (8,4,1001,128)", 1001, 1001, False, False),
              ("decode self causal (8,4,65,128) + kv_valid", 65, 65, True,
               True),
              ("decode cached cross (8,4,65,128)x(8,4,1001,128)", 65, 1001,
               False, False)]
    entries = []
    for label, tq, tk, causal, masked in shapes:
        q = torch.randn(BATCH, H, tq, hd, device=dev, generator=g).bfloat16()
        k = torch.randn(BATCH, H, tk, hd, device=dev, generator=g).bfloat16()
        v = torch.randn(BATCH, H, tk, hd, device=dev, generator=g).bfloat16()
        valid = None
        if masked:
            lens = torch.arange(BATCH, device=dev) * 3 + 40
            valid = torch.arange(tk, device=dev)[None] < lens[:, None]
        got = attention.flash_attention(q, k, v, causal, valid)
        want = attention.attention_plain(q.float(), k.float(), v.float(),
                                         causal, valid)
        e, bad, rows = close_rows(got, want, 8e-3, 2e-3, hd)
        check(bad == 0, f"flash_attention {label}: max abs err {e:.3e}, "
              f"{bad}/{rows} rows out (tolerance 8e-3 |plain| + 2e-3 "
              "max|plain|: one bf16 rounding of the output)")
        pairs = tq * tk if not causal else sum(
            min(tk, i + 1 + tk - tq) for i in range(tq))
        b_ms, b_by = bound_ms(4.0 * BATCH * H * pairs * hd,
                              nbytes(q, k, v, got, valid), BF16_PEAK)
        mask = None
        if causal or masked:
            mask = torch.ones(BATCH, 1, tq, tk, dtype=torch.bool, device=dev)
            if causal:
                mask = mask & torch.ones(tq, tk, dtype=torch.bool,
                                         device=dev).tril(tk - tq)
            if masked:
                mask = mask & valid[:, None, None, :]
        entries.append(dict(
            shape=label, max_abs_err=e,
            ms=cuda_ms(lambda: attention.flash_attention(q, k, v, causal,
                                                         valid)),
            plain_ms=cuda_ms(lambda: attention.attention_plain(
                q, k, v, causal, valid)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))))
    out.append(dict(name="flash_attention", route="cuda",
                    source="asr_model_tpu_torch/csrc/flash_attention.cu",
                    replaces="asr_model_tpu/ops/pallas/attention_kernel.py:156",
                    **{k: entries[0][k] for k in entries[0] if k != "shape"},
                    shape=entries[0]["shape"], shapes=entries))

    # ---- fused_abby, bf16, with the flagship block's norm weights
    blk = model.processor.block
    entries = []
    for label, n, norm in [("decode (8*65, 512)", BATCH * 65, blk.ln),
                           ("decode head norm (8*4*65, 128)",
                            BATCH * 4 * 65, blk.attn.head_norm),
                           ("encoder (8*1001, 512)", BATCH * 1001, blk.ln)]:
        d = norm.dims
        x = (2 * torch.randn(n, d, device=dev, generator=g)).bfloat16()
        w = (norm.router_in.weight, norm.router_in.bias,
             norm.router_out.weight, norm.router_out.bias)
        size = abby.window_size(d)
        got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
        want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
        e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
        check(bad <= rows // 1000, f"fused_abby {label}: max abs err {e:.3e}, "
              f"{bad}/{rows} rows out (tolerance 8e-3 |plain| + 1e-3 "
              "max|plain| per element, one bf16 rounding; at most 0.1% of "
              "rows may route differently on a near tie)")
        flops = 2.0 * n * d * d + 2.0 * n * d * 3 + n * d * (2 * size + 12)
        b_ms, b_by = bound_ms(flops, nbytes(x, got, *w), BF16_PEAK)
        entries.append(dict(
            shape=label, max_abs_err=e,
            ms=cuda_ms(lambda: abby.fused_abby(x, *w, size, 1e-4, 1.0,
                                               0.75)),
            plain_ms=cuda_ms(lambda: abby.abby_plain(x, *w, size, 1e-4, 1.0,
                                                     0.75)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    out.append(dict(name="fused_abby", route="cuda",
                    source="asr_model_tpu_torch/csrc/abby.cu",
                    replaces="asr_model_tpu/ops/pallas/abby_kernel.py:180",
                    **{k: entries[0][k] for k in entries[0] if k != "shape"},
                    shape=entries[0]["shape"], shapes=entries))

    # ---- fused_sheath_scan, bf16 x, the flagship block's MSheath
    jump = blk.jump
    w = jump.scan_weights()
    entries = []
    for label, ctx, lens in [("decode (8*65, 512) + valid", 65, 40),
                             ("encoder (8*1001, 512)", 1001, None)]:
        x = torch.randn(BATCH, ctx, 512, device=dev, generator=g).bfloat16()
        valid = None
        if lens is not None:
            valid = (torch.arange(ctx, device=dev)[None]
                     < (torch.arange(BATCH, device=dev)[:, None] + lens))
        from asr_model_tpu_torch.models.sheath import masked_mean
        pooled = masked_mean(x, valid, dim=1)[:, 0]
        sampled = torch.argmax(jump.pnet(pooled).mean(0)).to(torch.int32)
        args = (x.reshape(-1, 512), BATCH, valid, w["mem0"], sampled,
                w["jump_s"], {kk: w[kk] for kk in sheath.WEIGHT_NAMES},
                jump.layer, jump.thresh)
        got, act_k, js_k = sheath.fused_sheath_scan(*args)
        want, act_p, js_p = sheath.sheath_scan_plain(*args)
        e, bad, rows = close_rows(got, want, 8e-3, 1e-3, 512)
        same = act_k.tolist() == act_p.tolist() \
            and js_k.tolist() == js_p.tolist()
        check(bad <= rows // 1000 and same,
              f"fused_sheath_scan {label}: max abs err {e:.3e}, {bad}/{rows} "
              f"rows out, actions {act_k.tolist()} vs {act_p.tolist()} "
              "(tolerance 8e-3 |plain| + 1e-3 max|plain| per element, one "
              "bf16 rounding; at most 0.1% of rows may cross the ion "
              "threshold on a near tie; actions and jstat exact)")
        # executed slots, from this run's actions
        slots, i = [], 0
        for a in act_k.tolist():
            if i >= jump.layer:
                break
            slots.append(i)
            i = min(i + a + 1, jump.layer) if a > 0 else i + 1
        n, d, d2, m = BATCH * ctx, 512, 256, jump.mem
        flops = sum(2.0 * n * d * (m + d2) + (2.0 * n * d * d if s % 2 == 0
                                             else 0) + 30.0 * n * d
                    for s in slots)
        b_ms, b_by = bound_ms(flops, nbytes(x, got, valid, *w.values()),
                              F32_PEAK)
        entries.append(dict(
            shape=label, max_abs_err=e, slots=len(slots),
            ms=cuda_ms(lambda: sheath.fused_sheath_scan(*args)),
            plain_ms=cuda_ms(lambda: sheath.sheath_scan_plain(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    out.append(dict(name="fused_sheath_scan", route="cuda",
                    source="asr_model_tpu_torch/csrc/sheath.cu",
                    replaces="asr_model_tpu/ops/pallas/sheath_kernel.py:180",
                    **{k: entries[0][k] for k in entries[0]
                       if k not in ("shape", "slots")},
                    shape=entries[0]["shape"], shapes=entries))
    return out


# ---------------------------------------------------------- main path

def frontend(audio, dtype=None):
    """log-mel, YIN pitch and the frame-rate waveform, on the device,
    cast to ``dtype`` (bf16 by default: bench.py's frontend)."""
    import torch
    from asr_model_tpu_torch.ops.audio import frame_rate_waveform
    from asr_model_tpu_torch.ops.mel import log_mel_spectrogram
    from asr_model_tpu_torch.ops.pitch import yin_f0
    mel = log_mel_spectrogram(audio, SR, 1024, HOP, 128)
    T = mel.shape[-1]
    f0 = yin_f0(audio, fs=SR, frame_period=HOP / SR * 1000.0)[0][:, None]
    f0 = torch.nn.functional.pad(f0, (0, max(T - f0.shape[-1], 0)))[..., :T]
    wav = frame_rate_waveform(audio, SR, HOP)
    dtype = dtype or torch.bfloat16
    return mel.to(dtype), f0.to(dtype), wav.to(dtype)


def transcribe(model, audio):
    from asr_model_tpu_torch.models.generate import greedy_decode
    mel, f0, wav = frontend(audio)
    return greedy_decode(model, spectrogram=mel, pitch=f0, waveform=wav,
                         max_new_tokens=NEW_TOKENS, suppress_eos=True)


def plain_route():
    """Point every kernel wrapper at its plain version (for comparing the
    two routes on the card); returns the undo."""
    from asr_model_tpu_torch.ops.cuda import abby, attention, mel, sheath
    saved = [(abby, "fused_abby", abby.fused_abby),
             (attention, "flash_attention", attention.flash_attention),
             (mel, "mel_spectrogram", mel.mel_spectrogram),
             (sheath, "fused_sheath_scan", sheath.fused_sheath_scan)]
    abby.fused_abby = abby.abby_plain
    attention.flash_attention = attention.attention_plain
    mel.mel_spectrogram = mel.mel_spectrogram_plain
    sheath.fused_sheath_scan = sheath.sheath_scan_plain

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def first_step_logits(model, audio, dtype):
    from asr_model_tpu_torch.config import BOS_ID
    from asr_model_tpu_torch.models.generate import decode_step, prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    import torch
    mel, f0, wav = frontend(audio, dtype)
    xa_kv = prepare_cross(model, modality_slots(f0, mel, wav))
    ids = torch.full((audio.shape[0], 9), 0, dtype=torch.long,
                     device=audio.device)
    ids[:, 0] = BOS_ID
    return decode_step(model, ids, xa_kv, 1)


def route_check(model, audio, dtype, tol: float, why: str) -> float:
    """The first decode step's logits on the kernel route against the
    plain route on the card: fails past ``tol`` of the largest logit or
    when any row's argmax differs."""
    import torch
    lk = first_step_logits(model, audio, dtype)
    undo = plain_route()
    try:
        lp = first_step_logits(model, audio, dtype)
    finally:
        undo()
    rel = float((lk - lp).abs().max()) / float(lp.abs().max())
    same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    check(bool(torch.isfinite(lk).all()) and rel < tol and same,
          f"first decode step logits, kernel vs plain route "
          f"({str(dtype).replace('torch.', '')}): max abs err / max|plain| "
          f"= {rel:.3e} (tolerance {tol:g}: {why}); argmax "
          f"{'identical' if same else 'DIFFERS'} in the {lk.shape[0]} rows")
    return rel


def main_path(model):
    import torch
    from asr_model_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
    from asr_model_tpu_torch.models.generate import prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops import cuda as kernels
    dev = torch.device("cuda")
    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(dev)

    transcribe(model, audio)                 # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    ids = transcribe(model, audio)
    torch.cuda.synchronize()
    counts = kernels.counts()
    log("kernels " + json.dumps(counts))
    for name, c in counts.items():
        check(c["launches"] > 0, f"main path launched {name} "
              f"{c['launches']} times")
        check(c["plain_calls"] == 0, f"main path made no plain {name} call "
              f"({c['plain_calls']})")

    vocab = model.dims.tokens
    check(tuple(ids.shape) == (BATCH, 1 + NEW_TOKENS),
          f"output ids shape {tuple(ids.shape)}")
    check(bool((ids[:, 0] == BOS_ID).all()) and bool((ids >= 0).all())
          and bool((ids < vocab).all()), "ids start with BOS, in vocab")
    check(not bool((ids[:, 1:-1] == EOS_ID).any())
          and not bool((ids[:, 1:] == PAD_ID).any()),
          "no EOS before the budget (suppressed), no PAD")

    times = []                      # seconds per batch, each synchronised
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = transcribe(model, audio)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    total = float(np.median(times))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel, f0, wav = frontend(audio)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepare_cross(model, modality_slots(f0, mel, wav))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    front_ms, prep_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    step_ms = (total * 1e3 - front_ms - prep_ms) / NEW_TOKENS
    rtfx = BATCH * UTT_SEC / total
    log(f"main path: median {total * 1e3:.3f} ms per batch of {BATCH} x "
        f"{UTT_SEC:.0f} s (runs: "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f") -> RTFx {rtfx:.3f}; frontend {front_ms:.3f} ms, "
        f"encode + re-encode + cross K/V {prep_ms:.3f} ms, decode "
        f"{step_ms:.3f} ms per step; ids {tuple(ids.shape)}")

    rel = route_check(model, audio, torch.bfloat16, 7e-2,
                      "bf16 rounds at other places on the two routes")
    return dict(rtfx=rtfx, ms_per_batch=total * 1e3,
                ms_per_batch_runs=[t * 1e3 for t in times],
                frontend_ms=front_ms,
                prepare_ms=prep_ms, decode_ms_per_step=step_ms,
                counts=counts, first_step_rel_err=rel)


def small_reference():
    """A small f32 model: kernel route on the card against the plain
    route on the CPU (the route the CPU tests hold against the JAX
    package)."""
    import torch
    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.models.model import Model
    dims = Dimensions(tokens=512, mels=16, dims=128, head=1, layer=4)
    rng = np.random.RandomState(0)
    feats = dict(spectrogram=rng.randn(2, 16, 48).astype(np.float32),
                 pitch=rng.rand(2, 1, 48).astype(np.float32),
                 waveform=rng.randn(2, 1, 48).astype(np.float32))
    ids = torch.from_numpy(rng.randint(3, 512, size=(2, 6)))
    cpu = Model(dims, device="cpu", seed=1)
    gpu = Model(dims, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    want = cpu(ids, **{k: torch.from_numpy(v) for k, v in feats.items()})
    got = gpu(ids.cuda(), **{k: torch.from_numpy(v).cuda()
                             for k, v in feats.items()})
    rel = float((got["logits"].cpu() - want["logits"]).abs().max()) \
        / float(want["logits"].abs().max())
    check(rel < 1e-3, f"small f32 model, card kernels vs CPU plain: max abs "
          f"err / max|ref| = {rel:.3e} (tolerance 1e-3: f32 sums in other "
          "orders through the stack)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.models.model import Model, cast_variables
    from asr_model_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    log(f"built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")

    model = cast_variables(Model(Dimensions(), device="cuda", seed=0))
    kernels = check_kernels(model)
    result = main_path(model)
    result["first_step_rel_err_f32"] = route_check(
        Model(Dimensions(), device="cuda", seed=0),
        torch.from_numpy(tones(BATCH, UTT_SEC)).cuda(), torch.float32, 6e-5,
        "f32 sums in other orders")
    for k in kernels:
        k["launches"] = result["counts"][k["name"]]["launches"]
    small_reference()

    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed")
        return 1
    log(json.dumps({"main_path": {k: v for k, v in result.items()
                                  if k != "counts"}, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
