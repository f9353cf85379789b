#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   CUDA kernels from ``asr_model_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card at
   the shapes of the decode paths (and at shapes past the flagship's:
   B 128, D 1280, head width 256, the mel at Whisper's n_fft 400 and at
   256 mels, a cache of 4096 keys; and one phase a shape past each
   kernel's earlier limits: AbbyNormal, the MSheath scan and the MLP at
   D 2304, head width 384 in flash and both attention calls, the mel at
   n_fft 16, the router at 12 types and at D 4096, the tail at D 4608),
   with the tolerance stated beside it,
   and times kernel, plain version and (where one PyTorch call computes
   the same function) that call, each as device time (``cuda_ms``); for
   the mel, flash, AbbyNormal, MSheath, full-attention and residual-MLP
   kernels also the achieved TFLOP/s and the share of the bound, and
   (where the toolkit has ``cuobjdump``) the tensor-core instructions in
   each kernel of ``MMA_KERNELS``.
3. Drives the two decode paths at the flagship config (40k vocab, 512
   dims, 4 heads, 4 layers, bf16, the same seeded random weights): 8 x
   10 s synthetic tones -> log-mel + YIN pitch + frame-rate waveform ->
   AudioEncoder -> per-slot re-encode and cross K/V -> greedy buffer
   decode of 64 tokens with EOS suppressed.  The default path runs the
   mel, flash, fused_abby and fused_sheath_scan kernels; the fused path
   (ModelConfig fused_attention, fused_mlp, fused_router) also the
   whole-call attention, residual-MLP and router kernels.  Each path
   must launch exactly its kernels and run no plain version; each
   prints its RTFx (median of 2 timed runs), decode ms per step and the
   device kernels of one decode step at width 65 (torch.profiler), where
   the kernels of each wrapper in ``PROFILED`` the profiler sees must be
   the launches the wrapper counted.  Then the same weights as a
   streaming model (``ModelConfig(streaming=True)``) through the
   incremental decode ``greedy_decode_stream``: the stream path (the
   mel, flash, fused_abby and fused_sheath_scan kernels: the streaming
   MSheath scan is PyTorch ops, as the JAX package runs it in XLA) and
   stream+fused (adding the MLP and router kernels, no whole-call
   attention), the same counted run and checks (RTFx the median of 2
   runs, stream+fused one), one stream step at position 64 under
   torch.profiler, and the stream path's RTFx at B 64 (one run), a
   record.  (Device times are the mean of 6 calls behind a sleep,
   ``cuda_ms``.)
4. Serving (``Transcriber``, the same flagship weights): the kernels at
   the serving shapes no decode path runs (a 30 s long-form chunk: the
   mel on (1, 480000), flash over 3001 frames and against 3001 keys,
   ``fused_abby`` (3001, 512), the MSheath scan (1*3001, 512); beam 4's
   cross against 1001 keys), DIO's contour kernel ``dio_contour``
   against its plain version (exactly) at 8 x 1001 and 1 x 3001 frames
   and the card's DIO + StoneMask against the port's CPU route, then the
   serve path: ``transcribe_batch`` on the 8 x 10 s tones (DIO pitch on
   the card, 64 tokens, EOS not suppressed; RTFx the median of 2),
   ``__call__`` with beam 4, ``transcribe_long`` on 62 s (3 chunks, 32
   tokens each); it must launch exactly mel, flash, fused_abby,
   fused_sheath_scan and dio_contour and no plain version, and each
   transcript must be the tokenizer's decode of its ids.  Prints the
   frontend's ms split and launches, and the first step's logits on the
   serve features and at the chunk's shapes against the plain route.
   The streaming flagship's ``transcribe_batch`` must take
   ``greedy_decode_stream``.
5. Checks the output ids, the first decode step's logits on each path's
   kernel route against its plain route on the card (bf16 and f32, and
   bf16 at B 128; argmax identical in every row; the stream path's first
   step too), the fused path against the default path (f32), the stream
   decode's tokens against the buffer decode's on the streaming model
   (f32: equal, or a near tie at the first difference; bf16: the share
   printed), and small f32 models (both paths, and a streaming one
   through its stream steps) on the card against the same models' plain
   route on the CPU.
6. Training: ``flash_attention`` under autograd at (8, 4, 1001, 128),
   f32 and bf16, causal and not, with ``kv_valid`` (the kernel forward
   against the plain version, dq / dk / dv against the plain route's
   autograd, forward + backward timed beside the plain route and SDPA);
   the train step on the flagship (dropout and gumbel draws from a
   seeded generator) on the 8 x 10 s tones featurised by the training
   data pipeline (the mel kernel one utterance a call, the native host
   DIO) with 64-token labels from a seed, in f32 and in bf16 compute
   over f32 masters: step 0's loss and grad norm on the kernel route
   against the plain route (f32 1e-4, bf16 7e-2 relative; taken first in
   the call, bf16 then f32, while the process is fresh: PERF.md §6),
   then step ms (median of 2, step 0 the warm-up), utterances and audio
   seconds per wall second, peak memory, one step's launches and device
   ms (torch.profiler), and 3 steps on the batch (finite, the loss
   falling); then the training CLI (16 synthetic utterances, 4 steps of
   8, bf16, DIO on the host, eval, a checkpoint read back and a resumed
   run). The path must launch mel and flash (and the eval's kernels on
   the CLI) and no plain version. Then training on audio files:
   GrammarDataset sentences (``make_split(12, 4)``) written as FLAC
   (``tools/flac_encoder.py``) into a LibriSpeech-layout tree and as WAV
   with a ``metadata.csv``, the port's FLAC decode bit-exact against the
   PCM; the flagship step on the first 8 through ``LibriSpeechDataset``
   (mel kernel, host DIO), f32 and bf16, without remat and with remat
   "dots" and "full": step 0's loss and grad norm against the step
   without remat (1e-6 and 5e-4 relative), step ms (one timed step),
   peak memory, one step's launches and device ms; remat "full" at the
   10 s tones (f32, against the train step above: step 0, step ms, peak
   memory); one ``log_detail`` call (``make_grad_diagnostics``) at the
   flagship, every scalar finite; the CLI on the WAV files (``--metadata
   --data-dir --remat``, 4 steps of 8, eval through the native WER
   engine); the golden reference (tests/golden/reference_parity.npz)
   imported on the card, its logits against the golden's (2e-4), and the
   CLI with ``--import-reference`` at the golden's dims. The file batch
   must launch mel and flash and no plain version, the CLI the eval's
   kernels too.
7. The model variants (``variants_path``), at the flagship's width
   from seed 0: a chained model whose blocks' MLPs are 8 routed experts
   (top 2, capacity factor 1.25) with the encoder's norm and transformer
   layer (``CHAINED_MOE``) served through ``Transcriber`` (bf16, DIO,
   the 8 x 10 s tones, 64 tokens: exactly the serve path's kernels;
   RTFx of one timed run, decode ms a step, one step's launches and
   device ms), its first decode step against the plain route in f32
   (6e-5) and in bf16 (read and printed, every value finite:
   ``bf16_route_reading``'s note), once more with the fused fields on
   (no ``fused_mlp_residual`` launch: its gate refuses an MoE block),
   its train step 0 bf16 (loss) and f32 (loss and grad norm, with the
   witness) on the tones cut to 2.55 s, then one timed f32 step (step
   ms, peak memory, the MoE aux term of its forward), one profiled
   (launches, device ms) and 2 more (the loss falling); MSheath's
   mini-HC paths as a module (``minihc_module``: no ModelConfig field
   builds them, as in the JAX package): its eval forward in f32 and bf16
   and its train gradients in f32 on the card against the CPU's, with
   no ``fused_sheath_scan`` launch (the JAX gate excludes mini-HC).
8. Parallelism (``parallel_path``, f32): at one rank over NCCL (what a
   user of many cards runs on each) the DP x TP train step at data 1 x
   model 1 through the sharded code (step 0 against the one-device step
   0 of 6: loss within ``TRAIN_TOL``, grad norm within its witness
   limit), ``transcribe_long_sp`` on the 62 s tones at seq 1 with the
   fused fields (64 tokens; its ids equal to ``greedy_decode``'s on the
   same padded features; exactly the serve path's kernels and the MLP
   and router kernels: the SP context takes no whole-call attention
   kernel) and the pipeline at pipe 1 on the chained flagship (dropout
   0, noise-free, 4 of the 2.55 s tones): 1 microbatch against the
   one-device step (1e-4), then 2 microbatches; then two gloo ranks on the one card (gloo takes
   all_reduce on CUDA tensors, not send / recv, so the halo exchange
   and the pipeline's hops stay at one rank): TP 2 and DP 2 on the 8 x
   10 s batch against 6's step 0, EP 2 on the chained MoE against the
   variants' step 0 (the same gates).  Each run prints its ranks and
   backend, step ms (the DP x TP step's of a timed step; the pipeline's
   and the gloo ranks' of step 0) or RTFx, and its launches by kernel,
   and must
   launch flash (the SP run: the serve path's kernels, the MLP's and
   the router's) and no plain version.
9. Past the kernels' shared-memory plans ("limits", ``check_limits``):
   each route that keeps rows, heads or frames in device memory, at the
   smallest shape past its limit the JAX gate admits, weights and inputs
   made on the card from a seed: flash at head width 2048 (8, 1, 1001,
   2048) causal with a prefix mask; both whole attention calls at one
   head of 2048 and at D 59,520 (93 heads of 640: the norms past
   AbbyNormal's cluster plan; 6 D^2 bf16 weights, 42.5 GB); the
   residual MLP at 16 TGate types and at D 59,520 (10 D^2 bf16 weights,
   70.8 GB); AbbyNormal at (6, 59520); the MSheath scan at D 8,448 (2 x
   59 rows); the mel at n_fft 38,742.  Each is held against its plain
   version at its in-limit route's tolerance and timed (kernel, plain,
   library where one PyTorch call computes it), and must launch its
   route (``<wrapper>.routes``).
10. The latent modules (``latent_modules``): ``models/extras.py``,
   ``Gate``, ``OneShot``, ``taylor_softmax``, ``rbf_scores``,
   ``ChannelLayerNorm``, ``Identity`` and ``peak_normalize`` on CUDA
   tensors in f32 and bf16 against the same weights on the CPU, and
   ``extract_features`` with every flag (pitch tokens, WORLD harmonics
   and aperiodics, phase) on the 8 tones: finite, the JAX shapes, ms.
11. Prints the paths' JSON line, the ``kernels`` JSON line (launches by
   path; each route an entry ``<wrapper>/<route>``, with its launches in
   the limits phase), the card line, and as its last line ``{"ok":
   true, "device": {...}}``.

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
DEV = "cuda"
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
TF32_PEAK = 495e12        # H100 SXM dense TF32 tensor-core FLOP/s
F32_PEAK = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12         # H100 SXM device-memory bytes/s
SLEEP_HZ = 2.0e9          # torch.cuda._sleep cycles a second: at or above
                          # the H100's SM clock, so a sleep lasts at least
                          # the time asked

# the mel kernel against its plain version (torch.fft.rfft) at the tones:
# every bin within MEL_RTOL |plain| + MEL_ATOL, the log-mel within
# MEL_LOG_TOL
MEL_RTOL, MEL_ATOL, MEL_LOG_TOL = 4e-6, 2e-4, 1.2e-4
# flash bf16 against the f32 plain version: 5e-3 max|plain| per row
FLASH_TOL = 5e-3

FAILURES: list = []


def log(*a):
    print(*a, flush=True)


_T0 = [time.perf_counter(), time.perf_counter()]


def phase_done(name: str) -> None:
    """Print the wall seconds of the phase just ended and of the call so
    far (the script has 1200 s on the card, its build included)."""
    now = time.perf_counter()
    log(f"phase {name}: {now - _T0[1]:.1f} s (call so far "
        f"{now - _T0[0]:.1f} s)")
    _T0[1] = now


def check(ok: bool, what: str):
    log(("ok    " if ok else "FAIL  ") + what)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 6, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: the calls are enqueued while the
    device waits behind a sleep kernel long enough to cover their host
    time, so the events between them time the device work alone, not
    the host's launch rate (a call whose host time is longer than its
    kernels' would otherwise time the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(5e-3, 2.0 * host_s * iters) * SLEEP_HZ))
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


def rates(flops: float, ms: float, b_ms: float) -> dict:
    """Achieved TFLOP/s of the operations the function needs, and the
    share of the bound reached (bound ms / ms)."""
    return dict(tflops=flops / (ms * 1e-3) / 1e12, bound_share=b_ms / ms)


# the kernels that must run on the tensor cores: bf16 flash, the bf16
# AbbyNormal, the MSheath row kernel, the bf16 whole attention calls'
# (the rows launch serves both, then the full and the cached call's
# attention) and the bf16 residual MLP's (mangled-name patterns)
MMA_KERNELS = {
    "flash_tc_kernel": r"flash_tc_kernelILi(\d+)ELi(\d+)E",
    "abby_cluster_kernel<bf16>":
        r"abby_cluster_kernelI13__nv_bfloat16Lb([01])E",
    "sheath_rows": r"sheath_rowsI(\w+?)Li(\d+)E(\w+?)Lb([01])EEv",
    "xattn_full_rows": r"_Z15xattn_full_rowsILi(\d+)E",
    "xattn_full_attend": r"_Z17xattn_full_attendILi(\d+)E",
    "xattn_cached_attend": r"_Z19xattn_cached_attendILi(\d+)E",
    "mlp_norm<bf16>": r"mlp_normI13__nv_bfloat16Lb([01])E",
    "mlp_gates_tc": r"_Z12mlp_gates_tc",
    "mlp_linear_tc": r"mlp_linear_tcILi(\d+)E",
}


def sass_mma_counts(lib):
    """Tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in each
    kernel of ``MMA_KERNELS`` in the built library, from ``cuobjdump
    -sass``; None where the toolkit has no cuobjdump."""
    import re
    import shutil
    from asr_model_tpu_torch.ops.cuda.build import nvcc_path
    exe = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    if exe is None:
        return None
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = None
            for name, pat in MMA_KERNELS.items():
                m = re.search(pat, line)
                if m:
                    # template arguments: 13__nv_bfloat16 bf16, f f32,
                    # S0_ the first one again, Lb0/Lb1 false/true
                    args = [{"13__nv_bfloat16": "bf16", "f": "f32",
                             "0": "false", "1": "true"}.get(g, g)
                            for g in m.groups()]
                    args = [args[0] if g == "S0_" else g for g in args]
                    fn = f"{name}<{', '.join(args)}>" if args else name
                    counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for ins in ("HGMMA", "HMMA"):
                if re.search(rf"\b{ins}\.", line):
                    counts[fn][ins] += 1
    return counts


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


def compress(mel):
    """Whisper's log-mel compression per utterance of a (B, n_mels, T)
    power mel, as ``ops.mel.log_mel_spectrogram`` applies it."""
    import torch
    lm = torch.log10(torch.clamp(mel, min=1e-10))
    return (torch.maximum(lm, lm.amax(dim=(-2, -1), keepdim=True) - 8.0)
            + 4.0) / 4.0


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []

    # ---- mel: (8, 160000) f32 -> (8, 128, 1001)
    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(dev)
    got = mel.mel_spectrogram(audio)
    want = mel.mel_spectrogram_plain(audio)
    err = (got - want).abs()
    top = float(want.abs().max())
    small = want.abs() < 1e-3 * top      # the bins away from the tones
    big_rel = float((err / want.abs())[~small].max())
    small_abs = float(err[small].max())
    lo, hi = float(want[small].min()), float(want[small].max())
    ok = bool((err <= MEL_RTOL * want.abs() + MEL_ATOL).all())
    check(ok, f"mel_spectrogram (8, 160000): max abs err {float(err.max()):.3e}"
              f"; {big_rel:.2e} |plain| where |plain| >= 1e-3 max|plain| "
              f"(max|plain| {top:.4g}); {small_abs:.3e} on the "
              f"{int(small.sum())} bins under it (|plain| {lo:.3g} to "
              f"{hi:.3g}) (tolerance |err| <= {MEL_RTOL:g} |plain| + "
              f"{MEL_ATOL:g} on every bin: f32 FFTs in two orders, about "
              "twice these readings)")
    lg, lw = compress(got), compress(want)
    lerr = float((lg - lw).abs().max())
    check(lerr <= MEL_LOG_TOL, f"log-mel of the same (the model's input): "
          f"max abs err {lerr:.3e} (tolerance {MEL_LOG_TOL:g}, about twice "
          "the reading)")
    window = torch.hann_window(1024, device=dev)
    fb = torch.from_numpy(mel_filterbank(513, 50.0, 8000.0, 128)).to(dev)

    def lib_mel():
        s = torch.stft(audio, 1024, 160, window=window, center=True,
                       pad_mode="constant", return_complex=True)
        return torch.einsum("bft,fm->bmt", s.real ** 2 + s.imag ** 2, fb)

    # what the function needs: per frame a real FFT (~2.5 n log2 n), the
    # power and the filterbank's nonzero entries; the audio read once,
    # the mel written once
    T = got.shape[-1]
    nnz = int(np.count_nonzero(fb.cpu().numpy()))
    flops = BATCH * T * (2.5 * 1024 * 10 + 3 * 513 + 2.0 * nnz)
    b_ms, b_by = bound_ms(flops, nbytes(audio, got), F32_PEAK)
    ms = cuda_ms(lambda: mel.mel_spectrogram(audio))
    entries = [dict(shape="audio (8, 160000) f32", max_abs_err=float(
        err.max()), ms=ms,
        plain_ms=cuda_ms(lambda: mel.mel_spectrogram_plain(audio)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_mel),
        **rates(flops, ms, b_ms))]
    # other frontends: Whisper's n_fft 400 at 80 mels (Bluestein's
    # algorithm) and n_fft 1024 at 256 mels, held as the card tests hold
    # them (2e-3 |plain| + 2e-3 on every bin)
    for n_fft, n_mels in ((400, 80), (1024, 256)):
        kw = dict(n_fft=n_fft, hop_length=HOP, n_mels=n_mels)
        got = mel.mel_spectrogram(audio, **kw)
        want = mel.mel_spectrogram_plain(audio, **kw)
        err = (got - want).abs()
        check(bool((err <= 2e-3 * want.abs() + 2e-3).all()),
              f"mel_spectrogram (8, 160000) n_fft {n_fft}, {n_mels} mels: "
              f"max abs err {float(err.max()):.3e}, max rel "
              f"{float((err / want.abs().clamp(min=1e-3)).max()):.2e} "
              "(tolerance 2e-3 |plain| + 2e-3 on every bin, the card "
              "tests')")
        fbk = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, 50.0, 8000.0,
                                              n_mels)).to(dev)
        win_k = torch.hann_window(n_fft, device=dev)

        def lib_k():
            sp = torch.stft(audio, n_fft, HOP, window=win_k, center=True,
                            pad_mode="constant", return_complex=True)
            return torch.einsum("bft,fm->bmt", sp.real ** 2 + sp.imag ** 2,
                                fbk)

        nnz = int(np.count_nonzero(fbk.cpu().numpy()))
        flops = BATCH * T * (2.5 * n_fft * np.log2(n_fft)
                             + 3 * (n_fft // 2 + 1) + 2.0 * nnz)
        b_ms, b_by = bound_ms(flops, nbytes(audio, got), F32_PEAK)
        ms = cuda_ms(lambda: mel.mel_spectrogram(audio, **kw))
        entries.append(dict(
            shape=f"audio (8, 160000) f32, n_fft {n_fft}, {n_mels} mels",
            max_abs_err=float(err.max()), ms=ms,
            plain_ms=cuda_ms(lambda: mel.mel_spectrogram_plain(audio, **kw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_k),
            **rates(flops, ms, b_ms)))
    out.append(_entry("mel_spectrogram", "asr_model_tpu_torch/csrc/mel.cu",
                      "asr_model_tpu/ops/pallas/mel_kernel.py:119", entries))

    # ---- flash attention, bf16: encoder, decode self, cached cross at the
    # last bucket's width and at the first's (widths under 64: a query tile
    # mostly empty, key splits)
    shapes = [("encoder self (8,4,1001,128)", 1001, 1001, False, False, 4),
              ("decode self causal (8,4,65,128) + kv_valid", 65, 65, True,
               True, 4),
              ("decode cached cross (8,4,65,128)x(8,4,1001,128)", 65, 1001,
               False, False, 4),
              ("decode cached cross (8,4,9,128)x(8,4,1001,128)", 9, 1001,
               False, False, 4),
              # head width 256: 2 heads of a 512-wide model
              ("encoder self (8,2,1001,256)", 1001, 1001, False, False, 2),
              ("decode cached cross (8,2,65,256)x(8,2,1001,256)", 65, 1001,
               False, False, 2),
              # the stream decode's step: one query row against the
              # 65-position self/xa caches with the prefix mask (33 live),
              # and against the audio caches
              ("stream step (8,4,1,128)x(8,4,65,128) + prefix mask (33 "
               "live)", 1, 65, False, 33, 4),
              ("stream step (8,4,1,128)x(8,4,1001,128)", 1, 1001, False,
               False, 4)]
    entries = []
    for label, tq, tk, causal, masked, H in shapes:
        hd = 512 // H
        q = torch.randn(BATCH, H, tq, hd, device=dev, generator=g).bfloat16()
        k = torch.randn(BATCH, H, tk, hd, device=dev, generator=g).bfloat16()
        v = torch.randn(BATCH, H, tk, hd, device=dev, generator=g).bfloat16()
        valid = None
        if masked:              # ragged lengths, or a prefix of ``masked``
            lens = (torch.arange(BATCH, device=dev) * 3 + 40
                    if masked is True else
                    torch.full((BATCH,), masked, device=dev))
            valid = torch.arange(tk, device=dev)[None] < lens[:, None]
        got = attention.flash_attention(q, k, v, causal, valid)
        want = attention.attention_plain(q.float(), k.float(), v.float(),
                                         causal, valid)
        e, bad, rows = close_rows(got, want, 0.0, FLASH_TOL, hd)
        check(bad == 0, f"flash_attention {label}: max abs err {e:.3e} = "
              f"{e / float(want.abs().max()):.2e} max|plain|, {bad}/{rows} "
              f"rows out, {attention.splits(BATCH * H, tq, tk, sms, hd)} key "
              f"split(s) (tolerance {FLASH_TOL:g} max|plain|: the softmax "
              "weights and the output rounded to bf16; about twice the "
              "largest reading, 2.7e-3)")
        pairs = (tq * tk * BATCH if valid is None and not causal else
                 _pairs(tq, tk, causal, valid if valid is not None else
                        torch.ones(BATCH, tk, dtype=torch.bool, device=dev)))
        flops = 4.0 * H * pairs * hd
        b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got, valid), BF16_PEAK)
        mask = None
        if causal or masked:
            mask = torch.ones(BATCH, 1, tq, tk, dtype=torch.bool, device=dev)
            if causal:
                mask = mask & torch.ones(tq, tk, dtype=torch.bool,
                                         device=dev).tril(tk - tq)
            if masked:
                mask = mask & valid[:, None, None, :]
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, causal,
                                                       valid))
        entries.append(dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: attention.attention_plain(
                q, k, v, causal, valid)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)), **rates(flops, ms, b_ms)))
    out.append(dict(name="flash_attention", route="cuda",
                    source="asr_model_tpu_torch/csrc/flash_attention.cu",
                    replaces="asr_model_tpu/ops/pallas/attention_kernel.py:156",
                    **{k: entries[0][k] for k in entries[0] if k != "shape"},
                    shape=entries[0]["shape"], shapes=entries))

    # ---- fused_abby, bf16, with the flagship block's norm weights, at
    # the last and the first bucket's width, the head norms, the encoder
    blk = model.processor.block
    entries = []
    for label, n, norm in [("decode (8*65, 512)", BATCH * 65, blk.ln),
                           ("decode (8*9, 512)", BATCH * 9, blk.ln),
                           ("decode head norm (8*4*65, 128)",
                            BATCH * 4 * 65, blk.attn.head_norm),
                           ("encoder (8*1001, 512)", BATCH * 1001, blk.ln),
                           ("stream step (8, 512)", BATCH, blk.ln),
                           ("stream step head norm (8*4, 128)", BATCH * 4,
                            blk.attn.head_norm)]:
        d = norm.dims
        x = (2 * torch.randn(n, d, device=dev, generator=g)).bfloat16()
        w = (norm.router_in.weight, norm.router_in.bias,
             norm.router_out.weight, norm.router_out.bias)
        size = abby.window_size(d)
        got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
        want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
        e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
        plan = abby.launch_plan(n, d, x.dtype)
        check(bad <= rows // 1000, f"fused_abby {label}: max abs err {e:.3e}, "
              f"{bad}/{rows} rows out, {plan['tiles']} clusters of "
              f"{plan['cluster']} (tolerance 8e-3 |plain| + 1e-3 "
              "max|plain| per element, one bf16 rounding; at most 0.1% of "
              "rows may route differently on a near tie)")
        flops = _abby_ops(n, d, size)
        b_ms, b_by = bound_ms(flops, nbytes(x, got, *w), BF16_PEAK)
        ms = cuda_ms(lambda: abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75))
        entries.append(dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: abby.abby_plain(x, *w, size, 1e-4, 1.0,
                                                     0.75)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **rates(flops, ms, b_ms)))
    # a D 1280 block's norm (random weights): 7 CTAs a cluster, W1 through
    # the ring, a 65-tap window
    d, n = 1280, BATCH * 65
    x = (2 * torch.randn(n, d, device=dev, generator=g)).bfloat16()
    w = _norm_weights(g, d)
    size = abby.window_size(d)
    got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
    want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
    e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
    check(bad <= rows // 1000, f"fused_abby D 1280 (8*65, 1280): max abs "
          f"err {e:.3e}, {bad}/{rows} rows out (the tolerance above)")
    flops = _abby_ops(n, d, size)
    b_ms, b_by = bound_ms(flops, nbytes(x, got, *w), BF16_PEAK)
    ms = cuda_ms(lambda: abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75))
    entries.append(dict(
        shape="D 1280 block (8*65, 1280)", max_abs_err=e, ms=ms,
        plain_ms=cuda_ms(lambda: abby.abby_plain(x, *w, size, 1e-4, 1.0,
                                                 0.75)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))
    out.append(dict(name="fused_abby", route="cuda",
                    source="asr_model_tpu_torch/csrc/abby.cu",
                    replaces="asr_model_tpu/ops/pallas/abby_kernel.py:180",
                    **{k: entries[0][k] for k in entries[0] if k != "shape"},
                    shape=entries[0]["shape"], shapes=entries))

    # ---- fused_sheath_scan, bf16 x, the flagship block's MSheath, at
    # the last and the first bucket's width and at encoder length
    from asr_model_tpu_torch.models.sheath import masked_mean
    jump = blk.jump
    w = jump.scan_weights()
    sw = {kk: w[kk] for kk in sheath.WEIGHT_NAMES}
    # the products' weights exact in TF32 (the bf16 model's upcast ones):
    # two TF32 products give f32 accuracy, else three
    kw = sheath.kernel_weights(sw, jump.layer)
    n_prod = 3 if kw["split"] else 2
    wide = _wide_sheath(dev)          # a D 1280 block's MSheath, random
    lifted = _wide_sheath(dev, 2304, 18)   # past D 2048: rows from L2
    entries = []
    for label, bsz, ctx, lens, jm in [
            ("decode (8*65, 512) + valid", BATCH, 65, 40, jump),
            ("decode (8*9, 512)", BATCH, 9, None, jump),
            ("encoder (8*1001, 512)", BATCH, 1001, None, jump),
            # past one pass of the memory EMA (64 batch rows)
            ("decode B 128 (128*9, 512)", 128, 9, None, jump),
            ("D 1280 block (8*65, 1280) + valid", BATCH, 65, 40, wide),
            ("lifted (8*9, 2304) + valid", BATCH, 9, 5, lifted)]:
        d = jm.dims
        if jm is not jump:
            w = jm.scan_weights()
            sw = {kk: w[kk] for kk in sheath.WEIGHT_NAMES}
            kw = sheath.kernel_weights(sw, jm.layer)
            n_prod = 3 if kw["split"] else 2
        x = torch.randn(bsz, ctx, d, device=dev, generator=g).bfloat16()
        valid = None
        if lens is not None:
            valid = (torch.arange(ctx, device=dev)[None]
                     < (torch.arange(bsz, device=dev)[:, None] % 20 + lens))
        pooled = masked_mean(x, valid, dim=1)[:, 0]
        sampled = torch.argmax(jm.pnet(pooled).mean(0)).to(torch.int32)
        args = (x.reshape(-1, d), bsz, valid, w["mem0"], sampled,
                w["jump_s"], sw, jm.layer, jm.thresh)
        got, act_k, js_k = sheath.fused_sheath_scan(*args)
        want, act_p, js_p = sheath.sheath_scan_plain(*args)
        e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
        same = act_k.tolist() == act_p.tolist() \
            and js_k.tolist() == js_p.tolist()
        n, d2, m = bsz * ctx, d // 2, jm.mem
        plan = sheath.launch_plan(n, d, d2, m)
        if plan["passes"] == 1:
            plan = sheath.launch_plan(n, d, d2, m, sheath.max_clusters_on(
                dev, d, plan["cluster"]))
        check(bad <= rows // 1000 and same,
              f"fused_sheath_scan {label}: max abs err {e:.3e}, {bad}/{rows} "
              f"rows out, actions {act_k.tolist()} vs {act_p.tolist()}, "
              f"{plan['tiles']} clusters of {plan['cluster']} x "
              f"{plan['rows']} rows (tolerance 8e-3 |plain| + 1e-3 "
              "max|plain| per element, one bf16 rounding; at most 0.1% of "
              "rows may cross the ion threshold on a near tie; actions and "
              "jstat exact)")
        # executed slots, from this run's actions
        slots, i = [], 0
        for a in act_k.tolist():
            if i >= jm.layer:
                break
            slots.append(i)
            i = min(i + a + 1, jm.layer) if a > 0 else i + 1
        flops = sum(2.0 * n * d * (m + d2) + (2.0 * n * d * d if s % 2 == 0
                                             else 0) + 30.0 * n * d
                    for s in slots)
        b_ms, b_by = bound_ms(
            flops, nbytes(x, got, valid, w["mem0"], w["jump_s"])
            + _sheath_weight_bytes(sw, kw, slots),
            TF32_PEAK / n_prod)
        ms = cuda_ms(lambda: sheath.fused_sheath_scan(*args))
        entries.append(dict(
            shape=label, max_abs_err=e, slots=len(slots), ms=ms,
            plain_ms=cuda_ms(lambda: sheath.sheath_scan_plain(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            tf32_products=n_prod, **rates(flops, ms, b_ms)))
    out.append(dict(name="fused_sheath_scan", route="cuda",
                    source="asr_model_tpu_torch/csrc/sheath.cu",
                    replaces="asr_model_tpu/ops/pallas/sheath_kernel.py:180",
                    **{k: entries[0][k] for k in entries[0]
                       if k not in ("shape", "slots")},
                    shape=entries[0]["shape"], shapes=entries))
    return out


def _norm_weights(g, d: int):
    """Random AbbyNormal router weights for width d, bf16 on the card."""
    import torch
    r = lambda *sh, sc=1.0: (sc * torch.randn(*sh, device=DEV, generator=g)
                             ).bfloat16()
    return (r(d, d, sc=d ** -0.5), r(d, sc=0.1), r(3, d, sc=d ** -0.5),
            r(3, sc=0.1))


def _wide_sheath(dev, d: int = 1280, heads: int = 10):
    """A D-wide block's MSheath (4 slots) from a seed, bf16."""
    import torch
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    m = MSheath(d, heads, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(27))
    return m.to(torch.bfloat16)


def _sheath_weight_bytes(w: dict, kw: dict, slots: list) -> int:
    """The weight bytes the MSheath scan needs for the slots it ran: the
    product weights at the element size the kernel streams (bf16 when
    they are exact in bf16), each slot's [mkey^T | vmlp1_w] and, on even
    slots, adapt_w; the slots' f32 vectors; and the per-call ones."""
    prod = sum(w["mkey"][s].numel() + w["vmlp1_w"][s].numel()
               for s in slots) * kw["wsc"].element_size()
    prod += sum(w["adapt_w"][s // 2].numel() for s in slots
                if s % 2 == 0) * kw["wad"].element_size()
    per_slot = ("ln_scale", "ln_bias", "gate_w", "gate_b", "mval",
                "vmlp1_b", "vmlp2_w", "vmlp2_b", "vcat_w", "vcat_b")
    vec = sum(w[k][s].numel() for k in per_slot for s in slots)
    vec += sum(w["adapt_b"][s // 2].numel() for s in slots if s % 2 == 0)
    vec += w["memgate_w"].numel() + w["memgate_b"].numel()
    return prod + 4 * vec


def _pairs(tq: int, tk: int, causal: bool, valid) -> int:
    """Visible (query, key) pairs of the masked attention, summed over the
    batch rows of ``valid`` (B, tk); a fully masked row attends to every
    key (the mean of V)."""
    import torch
    vis = torch.ones(tq, tk, dtype=torch.bool, device=valid.device)
    if causal:
        vis = vis.tril(tk - tq)
    per_row = (vis[None] & valid[:, None, :]).sum(-1)
    return int(per_row.masked_fill(per_row == 0, tk).sum())


def _abby_ops(n: int, d: int, size: int) -> float:
    """The eval AbbyNormal: router product, logits, tail (as counted for
    fused_abby)."""
    return 2.0 * n * d * d + 2.0 * n * d * 3 + n * d * (2 * size + 12)


def _entry(name, source, replaces, entries):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                **{k: entries[0][k] for k in entries[0] if k != "shape"},
                shape=entries[0]["shape"], shapes=entries)


FUSED_TOL = ("tolerance 2e-2 |plain| + 5e-3 max|plain| per element: a bf16 "
             "rounding at each stage of the chain; at most 1% of rows out, "
             "where a near tie routes a norm the other way")


def _fused_close(label, got, want, row):
    import torch
    e, bad, rows = close_rows(got, want, 2e-2, 5e-3, row)
    check(bool(torch.isfinite(got.float()).all()) and bad <= rows // 100,
          f"{label}: max abs err {e:.3e}, {bad}/{rows} rows out ({FUSED_TOL})")
    return e


def check_fused_kernels(model, audio):
    """The fused path's kernels (and the abby tail entry) against their
    plain versions at the fused decode's shapes, with the flagship
    block's weights: width-65 buffers, the last bucket's prefix mask."""
    import torch

    from asr_model_tpu_torch.models.generate import prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops.cuda import abby, mlp, router, xattn
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(2)
    blk = model.processor.block
    at = blk.attn
    D, H, T = at.dims, at.head, 1 + NEW_TOKENS
    hd = D // H
    N = BATCH * T
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g).to(bf)
    valid = (torch.arange(T, device=dev) < T - 1)[None].expand(
        BATCH, T).contiguous()
    size_d, size_h = abby.window_size(D), abby.window_size(hd)
    out = []

    def wbytes(kw):
        return sum(nbytes(*v.values()) for k, v in kw.items()
                   if k in ("wq", "wkv", "wh", "wo"))

    def q_side_ops(n):
        return (_abby_ops(n, D, size_d) + 2.0 * n * D * D + 6.0 * n * D
                + _abby_ops(n * H, hd, size_h) + 2.0 * n * D * D)

    # ---- fused_attn_cached: the b/c/d calls against a slot's real cache
    # at the last and the first bucket's width, and a cache of 4096 keys
    # (the longest the gate admits at D 512)
    mel_, f0, wav = frontend(audio)
    kn, v = prepare_cross(model, modality_slots(f0, mel_, wav))["b"]
    fr = at.rot.freqs(False, torch.float32, dev)
    kw = at.fused_kw(bf, full=False)
    kn4, v4 = rnd(BATCH, H, 4096, hd), rnd(BATCH, H, 4096, hd)
    entries = []
    for label, w, kc, vc in [
            ("cached cross (8,65,512) x K/V (8,4,1001,128)", T, kn, v),
            ("cached cross (8,9,512) x K/V (8,4,1001,128)", 9, kn, v),
            ("cached cross (8,65,512) x K/V (8,4,4096,128)", T, kn4, v4)]:
        x = rnd(BATCH, w, D)
        args = (x, kc, vc, None, fr)
        got = xattn.fused_attn_cached(*args, **kw)
        want = xattn.attn_cached_plain(*args, **kw)
        tk = kc.shape[2]
        plan = xattn.launch_plan_cached(BATCH, w, tk, D, bf)
        e = _fused_close(f"fused_attn_cached {label}, {plan['launches']} "
                         f"launches ({plan['route']}: {plan['ns']} CTAs a "
                         f"cluster over the keys, {plan['qr']}-row query "
                         "tiles)", got, want, D)
        n = BATCH * w
        ops = q_side_ops(n) + BATCH * H * w * tk * (4.0 * hd + 5)
        b_ms, b_by = bound_ms(ops, nbytes(x, kc, vc, got) + wbytes(kw),
                              BF16_PEAK)
        ms = cuda_ms(lambda: xattn.fused_attn_cached(*args, **kw))
        entries.append(dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: xattn.attn_cached_plain(*args, **kw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **rates(ops, ms, b_ms)))
    out.append(_entry("fused_attn_cached", "asr_model_tpu_torch/csrc/xattn.cu",
                      "asr_model_tpu/ops/pallas/xattn_kernel.py:275",
                      entries))

    # ---- fused_attn_full: self causal (a), self (b/c/d/g), g cross, at
    # the last bucket's width and the first's (its prefix mask)
    entries = []
    for label, causal, cross, w in [
            ("self causal (8,65,512) + kv_valid", True, False, T),
            ("self (8,65,512) + kv_valid", False, False, T),
            ("g cross (8,65,512) x (8,65,512) + kv_valid", False, True, T),
            ("self causal (8,9,512) + kv_valid", True, False, 9),
            ("g cross (8,9,512) x (8,9,512) + kv_valid", False, True, 9),
            # the streaming model's g call: its cross causal too
            ("g cross causal (8,65,512) x (8,65,512) + kv_valid", True,
             True, T)]:
        x = rnd(BATCH, w, D)
        xa = rnd(BATCH, w, D) if cross else x
        vw = valid[:, :w] if w == T else (
            torch.arange(w, device=dev) < w - 1)[None].expand(
                BATCH, w).contiguous()
        fr = at.rot.freqs(causal, torch.float32, dev)
        kw = at.fused_kw(bf, full=True)
        args = (x, xa, vw, fr)
        got = xattn.fused_attn_full(*args, causal=causal, **kw)
        want = xattn.attn_full_plain(*args, causal=causal, **kw)
        plan = xattn.launch_plan_full(BATCH, w, w, D, bf)
        e = _fused_close(f"fused_attn_full {label}, {plan['launches']} "
                         f"launches ({plan['route']})", got, want, D)
        n = BATCH * w
        pairs = _pairs(w, w, causal, vw)
        ops = (q_side_ops(n) + _abby_ops(n, D, size_d) + 4.0 * n * D * D
               + 6.0 * n * D + _abby_ops(n * H, hd, size_h)
               + H * pairs * (4.0 * hd + 5))
        b_ms, b_by = bound_ms(ops, nbytes(x, None if xa is x else xa, vw,
                                          got) + wbytes(kw), BF16_PEAK)
        ms = cuda_ms(lambda: xattn.fused_attn_full(*args, causal=causal,
                                                   **kw))
        entries.append(dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: xattn.attn_full_plain(
                *args, causal=causal, **kw)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **rates(ops, ms, b_ms)))
    # a D 1280 block's self causal call (10 heads, random weights): a
    # launch-2 cluster of 8, two CTAs with two heads
    entries.append(_wide_attn_full(g, valid))
    out.append(_entry("fused_attn_full", "asr_model_tpu_torch/csrc/xattn.cu",
                      "asr_model_tpu/ops/pallas/xattn_kernel.py:333",
                      entries))

    # ---- fused_mlp_residual, the flagship block's MLP, at the last and
    # the first bucket's width
    entries = []
    for label, n in [("decode (8*65, 512)", N), ("decode (8*9, 512)",
                                                  BATCH * 9),
                     ("stream step (8, 512)", BATCH)]:
        args = blk.mlp_fused_args(rnd(n, D))
        got = mlp.fused_mlp_residual(*args)
        want = mlp.mlp_residual_plain(*args)
        nt, hid = len(args[4]), args[5].shape[0]
        plan = mlp.launch_plan(n, D, hid, bf)
        e = _fused_close(f"fused_mlp_residual {label}, {plan['launches']} "
                         f"launches ({'tensor' if plan['tc'] else 'CUDA'} "
                         "cores)", got, want, D)
        ops = _mlp_ops(n, D, nt, hid)
        wb = nbytes(*args[1], args[2], args[3], *[t for gw in args[4]
                                                  for t in gw], *args[5:9])
        b_ms, b_by = bound_ms(ops, nbytes(args[0], got) + wb, BF16_PEAK)
        ms = cuda_ms(lambda: mlp.fused_mlp_residual(*args))
        entries.append(dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: mlp.mlp_residual_plain(*args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **rates(ops, ms, b_ms)))
    entries.append(_wide_mlp(g))       # a D 1280 block's MLP
    out.append(_entry("fused_mlp_residual", "asr_model_tpu_torch/csrc/mlp.cu",
                      "asr_model_tpu/ops/pallas/mlp_kernel.py:125", entries))

    # ---- fused_router_same and the abby tail (no caller on a path) at
    # the last and the first bucket's width
    r_entries, t_entries = [], []
    for label, n in [("decode (8*65, 512)", N), ("decode (8*9, 512)",
                                                  BATCH * 9)]:
        args = blk.router.fused_args(rnd(n, D), blk.layer - 1)
        r_entries.append(_router_entry(
            f"{label}, 3 modalities, {args[1].shape[0]} types", args))
        x = (2 * torch.randn(n, D, device=dev, generator=g)).to(bf)
        lg = torch.randn(n, 3, device=dev, generator=g)
        t_entries.append(_tail_entry(f"{label} + f32 logits",
                                     (x, lg, size_d, 1e-4, 1.0, 0.75)))
    args = blk.router.fused_args(rnd(BATCH, D), blk.layer - 1)
    r_entries.append(_router_entry(
        f"stream step (8, 512), 3 modalities, {args[1].shape[0]} types",
        args))
    out.append(_entry(
        "fused_router_same", "asr_model_tpu_torch/csrc/router.cu",
        "asr_model_tpu/ops/pallas/router_kernel.py:97", r_entries))
    out.append(_entry(
        "fused_abby_tail", "asr_model_tpu_torch/csrc/abby.cu",
        "asr_model_tpu/ops/pallas/abby_kernel.py:142", t_entries))
    return out


def _router_entry(label, args) -> dict:
    """fused_router_same on ``args`` against its plain version, timed."""
    from asr_model_tpu_torch.ops.cuda import router
    got = router.fused_router_same(*args)
    want = router.router_same_plain(*args)
    x = args[0]
    n, d = x.shape
    e = _fused_close(f"fused_router_same {label}", got, want, d)
    nt, n_mod = args[1].shape[0], args[6]
    ops = 2.0 * 2 * nt * n_mod * d + 4.0 * n * d * nt + n * d + 30.0 * n * nt
    b_ms, b_by = bound_ms(ops, nbytes(x, got, *args[1:6]), F32_PEAK)
    return dict(shape=label, max_abs_err=e,
                ms=cuda_ms(lambda: router.fused_router_same(*args)),
                plain_ms=cuda_ms(lambda: router.router_same_plain(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _tail_entry(label, targs) -> dict:
    """fused_abby_tail on ``targs`` against its plain version, timed."""
    from asr_model_tpu_torch.ops.cuda import abby
    got = abby.fused_abby_tail(*targs)
    want = abby.abby_tail_plain(*targs)
    x, lg, size = targs[:3]
    n, d = x.shape
    e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
    check(bad == 0, f"fused_abby_tail {label}: max abs err {e:.3e}, "
          f"{bad}/{rows} rows out (tolerance 8e-3 |plain| + 1e-3 max|plain|:"
          " one bf16 rounding)")
    b_ms, b_by = bound_ms(n * d * (2.0 * size + 12), nbytes(x, lg, got),
                          F32_PEAK)
    return dict(shape=label, max_abs_err=e,
                ms=cuda_ms(lambda: abby.fused_abby_tail(*targs)),
                plain_ms=cuda_ms(lambda: abby.abby_tail_plain(*targs)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_lifted_shapes() -> dict:
    """One phase a lifted shape: the first card shape past each kernel's
    earlier limits (the MSheath scan's, (8*9, 2304), runs with the other
    MSheath shapes in ``check_kernels``), held against its plain version
    and timed.  Returns {kernel name:
    [entries]} for the ``kernels`` line."""
    import torch
    from asr_model_tpu_torch.models.rotary import compute_freqs
    from asr_model_tpu_torch.ops.cuda import (abby, attention, mel, mlp,
                                              router, xattn)
    from asr_model_tpu_torch.ops.mel import mel_filterbank
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(31)
    r = lambda *sh, sc=1.0: (sc * torch.randn(*sh, device=dev, generator=g)
                             ).bfloat16()
    out: dict = {}
    add = lambda name, entry: out.setdefault(name, []).append(entry)

    # fused_abby past D 2048: (8*9, 2304), the rows in device memory
    n, d = BATCH * 9, 2304
    x, w = r(n, d, sc=2.0), _norm_weights(g, d)
    size = abby.window_size(d)
    got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
    want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
    e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
    check(bad <= rows // 100, f"fused_abby (8*9, 2304): max abs err {e:.3e},"
          f" {bad}/{rows} rows out (tolerance 8e-3 |plain| + 1e-3 max|plain|"
          ", one bf16 rounding; at most 1% of rows may route differently "
          "on a near tie)")
    flops = _abby_ops(n, d, size)
    b_ms, b_by = bound_ms(flops, nbytes(x, got, *w), BF16_PEAK)
    ms = cuda_ms(lambda: abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75))
    add("fused_abby", dict(
        shape="lifted (8*9, 2304)", max_abs_err=e, ms=ms,
        plain_ms=cuda_ms(lambda: abby.abby_plain(x, *w, size, 1e-4, 1.0,
                                                 0.75)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))

    # flash at head width 384: (8,4,1001,384) causal with a prefix mask
    b_, h, t, hd = BATCH, 4, 1001, 384
    q, k, v = (r(b_, h, t, hd) for _ in range(3))
    lens = 1001 - 100 * torch.arange(b_, device=dev)
    valid = torch.arange(t, device=dev)[None] < lens[:, None]
    got = attention.flash_attention(q, k, v, True, valid)
    want = attention.attention_plain(q.float(), k.float(), v.float(), True,
                                     valid)
    e, bad, rows = close_rows(got, want, 0.0, FLASH_TOL, hd)
    check(bad == 0, f"flash_attention (8,4,1001,384) causal + kv_valid: max "
          f"abs err {e:.3e}, {bad}/{rows} rows out (tolerance {FLASH_TOL:g} "
          "max|plain|)")
    pairs = sum(min(t, i + 1) for i in range(t))
    flops = 4.0 * b_ * h * pairs * hd
    b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got, valid), BF16_PEAK)
    mask = (torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None, None]
            & valid[:, None, None, :])
    ms = cuda_ms(lambda: attention.flash_attention(q, k, v, True, valid))
    add("flash_attention", dict(
        shape="lifted (8,4,1001,384) causal + kv_valid", max_abs_err=e,
        ms=ms, plain_ms=cuda_ms(lambda: attention.attention_plain(
            q, k, v, True, valid)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask)),
        **rates(flops, ms, b_ms)))

    # the whole attention calls at 4 heads of 384 (D 1536), x (8, 9, 1536):
    # the cached call against 1001 keys, the full call self causal
    d, heads, t, tk = 1536, 4, 9, 1001
    hd = d // heads
    norm = lambda m: dict(zip(("n_w1", "n_b1", "n_w2", "n_b2"),
                              _norm_weights(g, m)))
    wq = norm(d) | {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    wkv = norm(d) | {"proj_w": r(2 * d, d, sc=d ** -0.5),
                     "proj_b": r(2 * d, sc=0.1)}
    wo = {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    kw = dict(head=heads, size_d=abby.window_size(d),
              size_h=abby.window_size(hd), alpha=1e-4, k=1.0, beta=0.75)
    x = r(BATCH, t, d, sc=0.5)
    wbytes = sum(nbytes(*m.values()) for m in (wq, norm(hd), wo))
    nq = BATCH * t
    q_side = (_abby_ops(nq, d, kw["size_d"]) + 2.0 * nq * d * d
              + _abby_ops(nq * heads, hd, kw["size_h"]))
    kn, vv = r(BATCH, heads, tk, hd), r(BATCH, heads, tk, hd)
    cvalid = torch.ones(BATCH, tk, dtype=torch.bool, device=dev)
    fr = torch.from_numpy(compute_freqs(d, heads, False)).to(dev)
    cargs = (x, kn, vv, cvalid, fr)
    ckw = dict(kw, wq=wq, wh=norm(hd), wo=wo)
    got = xattn.fused_attn_cached(*cargs, **ckw)
    want = xattn.attn_cached_plain(*cargs, **ckw)
    e = _fused_close("fused_attn_cached lifted (8,9,1536), 4 heads of 384, "
                     "1001 keys", got, want, d)
    flops = q_side + heads * BATCH * t * tk * 4.0 * hd + 2.0 * nq * d * d
    b_ms, b_by = bound_ms(flops, nbytes(x, kn, vv, got) + wbytes, BF16_PEAK)
    ms = cuda_ms(lambda: xattn.fused_attn_cached(*cargs, **ckw))
    add("fused_attn_cached", dict(
        shape="lifted x (8,9,1536), 4 heads of 384, K/V (8,4,1001,384)",
        max_abs_err=e, ms=ms,
        plain_ms=cuda_ms(lambda: xattn.attn_cached_plain(*cargs, **ckw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))
    fvalid = (torch.arange(t, device=dev) < t - 1)[None].expand(
        BATCH, t).contiguous()
    fr = torch.from_numpy(compute_freqs(d, heads, True)).to(dev)
    fargs = (x, x, fvalid, fr)
    fkw = dict(kw, wq=wq, wkv=wkv, wh=norm(hd), wo=wo)
    got = xattn.fused_attn_full(*fargs, causal=True, **fkw)
    want = xattn.attn_full_plain(*fargs, causal=True, **fkw)
    e = _fused_close("fused_attn_full lifted self causal (8,9,1536), 4 heads "
                     "of 384", got, want, d)
    flops = (2 * q_side + 2.0 * nq * d * d
             + heads * _pairs(t, t, True, fvalid) * (4.0 * hd + 5)
             + 2.0 * nq * d * d)
    b_ms, b_by = bound_ms(flops, nbytes(x, fvalid, got) + wbytes
                          + nbytes(*wkv.values()), BF16_PEAK)
    ms = cuda_ms(lambda: xattn.fused_attn_full(*fargs, causal=True, **fkw))
    add("fused_attn_full", dict(
        shape="lifted self causal (8,9,1536), 4 heads of 384 + kv_valid",
        max_abs_err=e, ms=ms,
        plain_ms=cuda_ms(lambda: xattn.attn_full_plain(*fargs, causal=True,
                                                       **fkw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))

    # the residual MLP past D 2048: (8*9, 2304), 3 gates, hidden 6912
    n, d, nt = BATCH * 9, 2304, 3
    hid = nt * d
    margs = (r(n, d), _norm_weights(g, d), r(nt, d, sc=d ** -0.5),
             r(nt, sc=0.1), [(r(d, d, sc=d ** -0.5), r(d, sc=0.1))
                             for _ in range(nt)],
             r(hid, d, sc=d ** -0.5), r(hid, sc=0.1),
             r(d, hid, sc=hid ** -0.5), r(d, sc=0.1), abby.window_size(d),
             1e-4, 1.0, 0.75)
    got = mlp.fused_mlp_residual(*margs)
    want = mlp.mlp_residual_plain(*margs)
    e = _fused_close("fused_mlp_residual lifted (8*9, 2304), hidden 6912",
                     got, want, d)
    flops = _mlp_ops(n, d, nt, hid)
    wb = nbytes(*margs[1], margs[2], margs[3],
                *[t_ for gw in margs[4] for t_ in gw], *margs[5:9])
    b_ms, b_by = bound_ms(flops, nbytes(margs[0], got) + wb, BF16_PEAK)
    ms = cuda_ms(lambda: mlp.fused_mlp_residual(*margs))
    add("fused_mlp_residual", dict(
        shape="lifted (8*9, 2304), 3 gates, hidden 6912", max_abs_err=e,
        ms=ms, plain_ms=cuda_ms(lambda: mlp.mlp_residual_plain(*margs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))

    # the mel below n_fft 64: n_fft 16, 8 mels (the direct DFT)
    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(dev)
    mkw = dict(n_fft=16, hop_length=HOP, n_mels=8)
    got = mel.mel_spectrogram(audio, **mkw)
    want = mel.mel_spectrogram_plain(audio, **mkw)
    err = (got - want).abs()
    check(bool((err <= 2e-3 * want.abs() + 2e-3).all()),
          f"mel_spectrogram lifted (8, 160000) n_fft 16, 8 mels: max abs err "
          f"{float(err.max()):.3e} (tolerance 2e-3 |plain| + 2e-3 on every "
          "bin, the card tests')")
    fb16 = torch.from_numpy(mel_filterbank(9, 50.0, 8000.0, 8)).to(dev)
    win16 = torch.hann_window(16, device=dev)
    nnz = int(np.count_nonzero(fb16.cpu().numpy()))
    frames = got.shape[-1]
    flops = BATCH * frames * (2.5 * 16 * 4 + 3 * 9 + 2.0 * nnz)
    b_ms, b_by = bound_ms(flops, nbytes(audio, got), F32_PEAK)

    def lib16():
        sp = torch.stft(audio, 16, HOP, window=win16, center=True,
                        pad_mode="constant", return_complex=True)
        return torch.einsum("bft,fm->bmt", sp.real ** 2 + sp.imag ** 2, fb16)
    ms = cuda_ms(lambda: mel.mel_spectrogram(audio, **mkw))
    add("mel_spectrogram", dict(
        shape="lifted audio (8, 160000) f32, n_fft 16, 8 mels",
        max_abs_err=float(err.max()), ms=ms,
        plain_ms=cuda_ms(lambda: mel.mel_spectrogram_plain(audio, **mkw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib16),
        **rates(flops, ms, b_ms)))

    # the router past 8 types and past 49,152 folded floats: 12 types at
    # (8*9, 512), 8 types at (8*9, 4096)
    for n, d, nt in ((BATCH * 9, 512, 12), (BATCH * 9, 4096, 8)):
        n_mod = 3
        rargs = (r(n, d), r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1),
                 r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1), r(1), n_mod)
        add("fused_router_same", _router_entry(
            f"lifted (8*9, {d}), {n_mod} modalities, {nt} types", rargs))

    # the tail past D 4096: (8*9, 4608)
    n, d = BATCH * 9, 4608
    x = r(n, d, sc=2.0)
    lg = torch.randn(n, 3, device=dev, generator=g)
    add("fused_abby_tail", _tail_entry(
        "lifted (8*9, 4608) + f32 logits",
        (x, lg, abby.window_size(d), 1e-4, 1.0, 0.75)))
    return out


# ------------------------------------------- past the shared-memory plans

LIMIT_SOURCES = {
    "mel_spectrogram/global": ("asr_model_tpu_torch/csrc/mel.cu",
                               "asr_model_tpu/ops/pallas/mel_kernel.py:119"),
    "flash_attention/global": ("asr_model_tpu_torch/csrc/global_attn.cuh",
                               "asr_model_tpu/ops/pallas/attention_kernel.py"
                               ":156"),
    "fused_abby/global": ("asr_model_tpu_torch/csrc/abby.cu",
                          "asr_model_tpu/ops/pallas/abby_kernel.py:180"),
    "fused_sheath_scan/global": ("asr_model_tpu_torch/csrc/sheath.cu",
                                 "asr_model_tpu/ops/pallas/sheath_kernel.py"
                                 ":180"),
    "fused_attn_cached/global": ("asr_model_tpu_torch/csrc/xattn_wide.cu",
                                 "asr_model_tpu/ops/pallas/xattn_kernel.py"
                                 ":275"),
    "fused_attn_full/global": ("asr_model_tpu_torch/csrc/xattn_wide.cu",
                               "asr_model_tpu/ops/pallas/xattn_kernel.py:333"),
    "fused_mlp_residual/types": ("asr_model_tpu_torch/csrc/mlp.cu",
                                 "asr_model_tpu/ops/pallas/mlp_kernel.py:125"),
    "fused_mlp_residual/global": ("asr_model_tpu_torch/csrc/mlp.cu",
                                  "asr_model_tpu/ops/pallas/mlp_kernel.py"
                                  ":125"),
}
ABBY_GLOBAL_D = 59520        # the first multiple of 128 past the bf16
                             # cluster plan (59,392)
ABBY_GLOBAL_D_F32 = 92288    # ... past the f32 one (92,160)
SHEATH_GLOBAL_D = 8448       # the first multiple of 128 past the row
                             # kernel's shared memory (8,320)
MEL_GLOBAL_FFT = 38742       # the first n_fft past one frame in shared
                             # memory (38,740)


def _uniform(g, *shape, sc: float = 1.0, dtype=None):
    """Weights U(-sc, sc), bf16 unless ``dtype`` says otherwise, made in
    place on the card (no f32 copy: the widest cases hold tens of GB)."""
    import torch
    return torch.empty(*shape, device=DEV,
                       dtype=dtype or torch.bfloat16).uniform_(
        -sc, sc, generator=g)


def _limit_entry(key: str, label: str, fn, plain_fn, judge, cost,
                 peak: float, lib_fn=None) -> dict:
    """One route at one shape: a counted call (the route's launches),
    the plain version, ``judge(got, want)`` (its checks; returns the max
    abs err), then kernel, plain and library device ms; ``cost()`` gives
    the function's (operations, bytes) for its bound, read after the
    judge (a count that depends on this run's data)."""
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    kernels.reset_counts()
    got = fn()
    torch.cuda.synchronize()
    launches = kernels.counts()[key]["launches"]
    want = plain_fn()
    e = judge(got, want)
    del got, want
    check(launches > 0, f"{key} {label}: {launches} launches of the route")
    ms = cuda_ms(fn, iters=3, warmup=1)
    plain_ms = cuda_ms(plain_fn, iters=3, warmup=1)
    flops, nb = cost()
    b_ms, b_by = bound_ms(flops, nb, peak)
    lib = cuda_ms(lib_fn, iters=3, warmup=1) if lib_fn else None
    log(f"limits {key} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
        f"{b_ms:.5f} by {b_by}{'' if lib is None else f', library {lib:.4f}'}"
        f"), {launches} launches")
    return dict(shape=label, max_abs_err=e, launches=launches, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, **rates(flops, ms, b_ms))


def check_limits() -> list:
    """The "limits" phase: each route past a kernel's shared-memory plan
    at the smallest shape past its limit that the JAX gate admits (flash
    and the MLP at the two limits a config can reach: head width 2048
    and 16 TGate types), weights and inputs made on the card from a
    seed, held against its plain version at its in-limit route's
    tolerance and timed.  Returns the ``kernels`` entries, one a route."""
    import torch
    from asr_model_tpu_torch.models.rotary import compute_freqs
    from asr_model_tpu_torch.models.sheath import masked_mean
    from asr_model_tpu_torch.ops.cuda import (abby, attention, mel, mlp,
                                              sheath, xattn)
    from asr_model_tpu_torch.ops.mel import mel_filterbank
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(41)
    out: dict = {}
    add = lambda key, entry: out.setdefault(key, []).append(entry)
    akw = dict(alpha=1e-4, k=1.0, beta=0.75)

    def fused_judge(label):
        return lambda got, want: _fused_close(label, got, want,
                                              got.shape[-1])

    # flash past head width 1024: a dims-2048 one-head encoder's self
    # attention (8, 1, 1001, 2048), causal, with a prefix mask
    b_, h, t, hd = BATCH, 1, 1001, 2048
    q, k, v = (torch.randn(b_, h, t, hd, device=dev, generator=g).bfloat16()
               for _ in range(3))
    lens = 1001 - 100 * torch.arange(b_, device=dev)
    valid = torch.arange(t, device=dev)[None] < lens[:, None]
    mask = (torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None, None]
            & valid[:, None, None, :])

    def flash_judge(got, want):
        e, bad, rows = close_rows(got, want, 0.0, FLASH_TOL, hd)
        check(bad == 0, f"flash_attention global (8,1,1001,2048) causal + "
              f"kv_valid: max abs err {e:.3e}, {bad}/{rows} rows out "
              f"(tolerance {FLASH_TOL:g} max|plain| per row)")
        return e
    add("flash_attention/global", _limit_entry(
        "flash_attention/global", "(8,1,1001,2048) causal + kv_valid",
        lambda: attention.flash_attention(q, k, v, True, valid),
        lambda: attention.attention_plain(q.float(), k.float(), v.float(),
                                          True, valid),
        flash_judge, lambda: (4.0 * h * _pairs(t, t, True, valid) * hd,
                              nbytes(q, k, v, q, valid)), BF16_PEAK,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)))
    del q, k, v, mask

    # the whole attention calls past head width 1024: D 2048, one head
    # of 2048 (the cached call against 1001 keys, the full call self
    # causal over 9 rows: the JAX gates' K/V bounds)
    d, heads, t, tk = 2048, 1, 9, 1001
    hd = d // heads
    r = lambda *sh, sc=1.0: _uniform(g, *sh, sc=sc)
    norm = lambda m: dict(zip(("n_w1", "n_b1", "n_w2", "n_b2"),
                              (r(m, m, sc=m ** -0.5), r(m, sc=0.1),
                               r(3, m, sc=m ** -0.5), r(3, sc=0.1))))
    proj = lambda o, i: {"proj_w": r(o, i, sc=i ** -0.5),
                         "proj_b": r(o, sc=0.1)}

    def attn_case(d, heads, t, tk, label, full_t=None):
        hd = d // heads
        wq, wh, wo = norm(d) | proj(d, d), norm(hd), proj(d, d)
        kw = dict(head=heads, size_d=abby.window_size(d),
                  size_h=abby.window_size(hd), **akw)
        x = torch.randn(1 if d > 4096 else BATCH, t, d, device=dev,
                        generator=g).bfloat16() * 0.5
        bsz, nq = x.shape[0], x.shape[0] * t
        wbytes = sum(nbytes(*m.values()) for m in (wq, wh, wo))
        q_side = (_abby_ops(nq, d, kw["size_d"]) + 2.0 * nq * d * d
                  + _abby_ops(nq * heads, hd, kw["size_h"]))
        kn = torch.randn(bsz, heads, tk, hd, device=dev,
                         generator=g).bfloat16()
        vv = torch.randn(bsz, heads, tk, hd, device=dev,
                         generator=g).bfloat16()
        cvalid = torch.ones(bsz, tk, dtype=torch.bool, device=dev)
        fr = torch.from_numpy(compute_freqs(d, heads, False)).to(dev)
        cargs = (x, kn, vv, cvalid, fr)
        ckw = dict(kw, wq=wq, wh=wh, wo=wo)
        lab = f"x ({bsz},{t},{d}), {heads} heads of {hd}, {tk} keys"
        add("fused_attn_cached/global", _limit_entry(
            "fused_attn_cached/global", lab,
            lambda: xattn.fused_attn_cached(*cargs, **ckw),
            lambda: xattn.attn_cached_plain(*cargs, **ckw),
            fused_judge(f"fused_attn_cached global {lab}"),
            lambda: (q_side + heads * nq * tk * 4.0 * hd + 2.0 * nq * d * d,
                     nbytes(x, kn, vv, x) + wbytes), BF16_PEAK))
        del kn, vv, cargs
        ft = full_t or t
        xf = x[:, :ft].contiguous()
        wkv = norm(d) | proj(2 * d, d)
        fvalid = (torch.arange(ft, device=dev) < max(ft - 1, 1))[None] \
            .expand(bsz, ft).contiguous()
        fr = torch.from_numpy(compute_freqs(d, heads, True)).to(dev)
        fargs = (xf, xf, fvalid, fr)
        fkw = dict(kw, wq=wq, wkv=wkv, wh=wh, wo=wo)
        nf = bsz * ft
        q_side = (_abby_ops(nf, d, kw["size_d"]) + 2.0 * nf * d * d
                  + _abby_ops(nf * heads, hd, kw["size_h"]))
        lab = (f"self causal ({bsz},{ft},{d}) + kv_valid, {heads} heads of "
               f"{hd}")
        add("fused_attn_full/global", _limit_entry(
            "fused_attn_full/global", lab,
            lambda: xattn.fused_attn_full(*fargs, causal=True, **fkw),
            lambda: xattn.attn_full_plain(*fargs, causal=True, **fkw),
            fused_judge(f"fused_attn_full global {lab}"),
            lambda: (2 * q_side + 2.0 * nf * d * d
                     + heads * _pairs(ft, ft, True, fvalid) * (4.0 * hd + 5)
                     + 2.0 * nf * d * d,
                     nbytes(xf, fvalid, xf) + wbytes
                     + nbytes(*wkv.values())), BF16_PEAK))
    attn_case(2048, 1, 9, 1001, "hd 2048")
    torch.cuda.empty_cache()
    # past AbbyNormal's cluster plan: D 59,520, 93 heads of 640 (the JAX
    # gates: x.size <= 400k, 35 cached keys and 2 kv rows a call at this
    # D); weights 6 D^2 bf16, 42.5 GB
    attn_case(ABBY_GLOBAL_D, 93, 6, 35, "D 59520", full_t=2)
    torch.cuda.empty_cache()

    # the residual MLP past 12 TGate types: (8*9, 512), 16 gates
    def mlp_args(n, d, nt):
        hid = nt * d
        x = torch.randn(n, d, device=dev, generator=g).bfloat16()
        return (x, (r(d, d, sc=d ** -0.5), r(d, sc=0.1), r(3, d, sc=d ** -0.5),
                    r(3, sc=0.1)),
                r(nt, d, sc=d ** -0.5), r(nt, sc=0.1),
                [(r(d, d, sc=d ** -0.5), r(d, sc=0.1)) for _ in range(nt)],
                r(hid, d, sc=d ** -0.5), r(hid, sc=0.1),
                r(d, hid, sc=hid ** -0.5), r(d, sc=0.1), abby.window_size(d),
                1e-4, 1.0, 0.75)

    for key, n, d, nt in (("fused_mlp_residual/types", BATCH * 9, 512, 16),
                          ("fused_mlp_residual/global", 6, ABBY_GLOBAL_D, 3)):
        margs = mlp_args(n, d, nt)
        hid = nt * d
        wb = nbytes(*margs[1], margs[2], margs[3],
                    *[t_ for gw in margs[4] for t_ in gw], *margs[5:9])
        lab = f"({n}, {d}), {nt} gates, hidden {hid}"
        add(key, _limit_entry(
            key, lab, lambda: mlp.fused_mlp_residual(*margs),
            lambda: mlp.mlp_residual_plain(*margs),
            fused_judge(f"fused_mlp_residual {key.split('/')[1]} {lab}"),
            lambda: (_mlp_ops(n, d, nt, hid),
                     nbytes(margs[0], margs[0]) + wb), BF16_PEAK))
        del margs
        torch.cuda.empty_cache()

    # AbbyNormal past its cluster plans: (6, 59520) bf16 and (6, 92288)
    # f32 (a 34.1 GB W1)
    for d, dt in ((ABBY_GLOBAL_D, torch.bfloat16),
                  (ABBY_GLOBAL_D_F32, torch.float32)):
        n = 6
        x = (torch.randn(n, d, device=dev, generator=g) * 2.0).to(dt)
        w = (_uniform(g, d, d, sc=d ** -0.5, dtype=dt),
             _uniform(g, d, sc=0.1, dtype=dt),
             _uniform(g, 3, d, sc=d ** -0.5, dtype=dt),
             _uniform(g, 3, sc=0.1, dtype=dt))
        size = abby.window_size(d)
        lab = f"({n}, {d}) {'bf16' if dt == torch.bfloat16 else 'f32'}"

        def abby_judge(got, want, lab=lab, d=d):
            e, bad, rows = close_rows(got, want, 8e-3, 1e-3, d)
            check(bad <= rows // 100, f"fused_abby global {lab}: max abs "
                  f"err {e:.3e}, {bad}/{rows} rows out (tolerance 8e-3 "
                  "|plain| + 1e-3 max|plain|, one bf16 rounding; at most 1% "
                  "of rows may route differently on a near tie)")
            return e
        add("fused_abby/global", _limit_entry(
            "fused_abby/global", lab,
            lambda: abby.fused_abby(x, *w, size, **akw),
            lambda: abby.abby_plain(x, *w, size, **akw), abby_judge,
            lambda: (_abby_ops(n, d, size), nbytes(x, x, *w)),
            BF16_PEAK if dt == torch.bfloat16 else F32_PEAK))
        del x, w
        torch.cuda.empty_cache()
    # named and left out: past the f32 plan the whole calls' and the
    # MLP's weights do not fit on the card
    dd = ABBY_GLOBAL_D_F32
    for what, count in (("fused_attn_cached/global f32", 3),
                        ("fused_attn_full/global f32", 6),
                        ("fused_mlp_residual/global f32", 10)):
        log(f"limits left out: {what} at D {dd} ({n} rows): {count} D^2 f32 "
            f"weights, {count * dd * dd * 4 / 1e9:.1f} GB, past the card's "
            "80 GB")

    # the MSheath scan past the row kernel's shared memory: D 8448, 2
    # batch rows of 59 (118 rows, the JAX gate's 1M elements)
    jm = _wide_sheath(dev, SHEATH_GLOBAL_D, SHEATH_GLOBAL_D // 128)
    d, bsz, ctx = SHEATH_GLOBAL_D, 2, 59
    w = jm.scan_weights()
    sw = {kk: w[kk] for kk in sheath.WEIGHT_NAMES}
    kw = sheath.kernel_weights(sw, jm.layer)
    n_prod = 3 if kw["split"] else 2
    x = torch.randn(bsz, ctx, d, device=dev, generator=g).bfloat16()
    valid = torch.arange(ctx, device=dev)[None] < torch.tensor(
        [[ctx], [ctx - 9]], device=dev)
    pooled = masked_mean(x, valid, dim=1)[:, 0]
    sampled = torch.argmax(jm.pnet(pooled).mean(0)).to(torch.int32)
    args = (x.reshape(-1, d), bsz, valid, w["mem0"], sampled, w["jump_s"],
            sw, jm.layer, jm.thresh)

    def sheath_judge(got, want):
        (gx, ga, gj), (px, pa, pj) = got, want
        e, bad, rows = close_rows(gx, px, 8e-3, 1e-3, d)
        same = ga.tolist() == pa.tolist() and gj.tolist() == pj.tolist()
        check(bad <= rows // 1000 and same,
              f"fused_sheath_scan global ({bsz}*{ctx}, {d}) + valid: max abs"
              f" err {e:.3e}, {bad}/{rows} rows out, actions {ga.tolist()} "
              f"vs {pa.tolist()} (tolerance 8e-3 |plain| + 1e-3 max|plain| "
              "per element; actions and jstat exact)")
        sheath_judge.actions = ga.tolist()
        return e
    nrows = bsz * ctx
    m, d2 = jm.mem, d // 2

    def sheath_cost():
        """The executed slots' operations and bytes, from this run's
        actions."""
        slots, i = [], 0
        for a in sheath_judge.actions:
            if i >= jm.layer:
                break
            slots.append(i)
            i = min(i + a + 1, jm.layer) if a > 0 else i + 1
        flops = sum(2.0 * nrows * d * (m + d2) + (2.0 * nrows * d * d
                                                  if s_ % 2 == 0 else 0)
                    + 30.0 * nrows * d for s_ in slots)
        return flops, (nbytes(x, x, valid, w["mem0"], w["jump_s"])
                       + _sheath_weight_bytes(sw, kw, slots))
    entry = _limit_entry(
        "fused_sheath_scan/global", f"({bsz}*{ctx}, {d}) + valid",
        lambda: sheath.fused_sheath_scan(*args),
        lambda: sheath.sheath_scan_plain(*args), sheath_judge, sheath_cost,
        TF32_PEAK / n_prod)
    entry["tf32_products"] = n_prod
    add("fused_sheath_scan/global", entry)
    del jm, w, sw, kw, x, args
    torch.cuda.empty_cache()

    # the mel past one frame in shared memory: n_fft 38,742, 128 mels, a
    # 3 s utterance (the JAX kernel takes one 1-D utterance a call)
    n_fft, n_mels = MEL_GLOBAL_FFT, 128
    audio = torch.from_numpy(tones(1, 3.0)).to(dev)
    mkw = dict(n_fft=n_fft, hop_length=HOP, n_mels=n_mels)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, 50.0, 8000.0,
                                         n_mels)).to(dev)
    win = torch.hann_window(n_fft, device=dev)

    def mel_judge(got, want):
        err = (got - want).abs()
        check(bool((err <= 2e-3 * want.abs() + 2e-3).all()),
              f"mel_spectrogram global (1, 48000) n_fft {n_fft}, {n_mels} "
              f"mels: max abs err {float(err.max()):.3e} (tolerance 2e-3 "
              "|plain| + 2e-3 on every bin, the direct DFT route's)")
        return float(err.max())

    def lib_mel():
        sp = torch.stft(audio, n_fft, HOP, window=win, center=True,
                        pad_mode="constant", return_complex=True)
        return torch.einsum("bft,fm->bmt", sp.real ** 2 + sp.imag ** 2, fb)
    frames = 1 + audio.shape[1] // HOP
    nnz = int(torch.count_nonzero(fb))
    add("mel_spectrogram/global", _limit_entry(
        "mel_spectrogram/global", f"audio (1, 48000) f32, n_fft {n_fft}, "
        f"{n_mels} mels",
        lambda: mel.mel_spectrogram(audio, **mkw),
        lambda: mel.mel_spectrogram_plain(audio, **mkw), mel_judge,
        lambda: (frames * (2.5 * n_fft * np.log2(n_fft)
                           + 3.0 * (n_fft // 2 + 1) + 2.0 * nnz),
                 nbytes(audio) + 4 * n_mels * frames), F32_PEAK, lib_mel))

    entries = []
    for key, shapes in out.items():
        src, rep = LIMIT_SOURCES[key]
        entries.append(dict(name=key, route="cuda", source=src, replaces=rep,
                            limits_launches=shapes[0]["launches"],
                            **{k: shapes[0][k] for k in shapes[0]
                               if k not in ("shape", "launches")},
                            shape=shapes[0]["shape"], shapes=shapes))
    return entries


# ---------------------------------------------------------- latent modules

LATENT_TOL = {"f32": 1e-4, "bf16": 5e-2}


def _latent_close(label, got, want, tol_name: str) -> float:
    """|got - want| against max|want|, on the tolerance of ``tol_name``;
    every value finite."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)
    check(bool(torch.isfinite(g).all()) and rel <= LATENT_TOL[tol_name],
          f"latent {label} {tol_name} on the card against the CPU: "
          f"{rel:.3e} of max|CPU| (tolerance {LATENT_TOL[tol_name]:g}: f32 "
          "sums in other orders; bf16 one rounding a stage against the "
          "CPU's f32)")
    return rel


def latent_modules() -> dict:
    """The "latent modules" phase: every module and function of
    ``models/extras.py``, ``Gate``, ``OneShot``, ``taylor_softmax``,
    ``rbf_scores``, ``ChannelLayerNorm``, ``Identity`` and
    ``peak_normalize`` on CUDA tensors, f32 and bf16, against the same
    weights on the CPU in f32 (``MyelinatedLayer`` in the noise-free
    limit and with one set of jump draws given to both devices; its
    bf16 run read, every value finite, not gated: its importance
    thresholds may round the other way); ``wideband_freqs`` and
    ``init_w`` on a card model against the CPU's; then
    ``extract_features`` with every flag on the 8 tones (the host
    features: finite, the JAX package's shapes, ms)."""
    import copy
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.data.features import extract_features
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    from asr_model_tpu_torch.models import attention as matt
    from asr_model_tpu_torch.models import extras, gates, norms, rotary
    from asr_model_tpu_torch.models import stochastic
    from asr_model_tpu_torch.models.model import Model, init_w
    from asr_model_tpu_torch.models.tlayers import reset_all
    from asr_model_tpu_torch.ops.audio import peak_normalize
    out: dict = {}
    gen = torch.Generator().manual_seed(51)
    cpu = lambda *sh: torch.randn(*sh, generator=gen)
    d, h, b, t = 512, 4, 4, 33
    x, xa = cpu(b, t, d), cpu(b, 48, d)
    mods = {"Curiosity": extras.Curiosity(d, h, device="cpu"),
            "AdaptiveSpan": extras.AdaptiveSpan(d, h, max_dist=24,
                                                device="cpu"),
            "MyelinatedLayer": extras.MyelinatedLayer(d, h, 4,
                                                      device="cpu"),
            "Gate": gates.Gate(d, 4, device="cpu"),
            "OneShot": gates.OneShot(d, h, device="cpu"),
            "ChannelLayerNorm": norms.ChannelLayerNorm(d, device="cpu"),
            "Identity": norms.Identity()}
    for m in mods.values():
        reset_all(m, gen)
    with torch.no_grad():
        mods["Curiosity"].g.copy_(torch.tensor([0.5, -1.0, 0.2, 1.5]))
        mods["AdaptiveSpan"].span_scale.fill_(0.7)
    mask = torch.ones(t, t, dtype=torch.bool).triu(1)[None, None]
    q, k, v = cpu(b, h, t, 64), cpu(b, h, 48, 64), cpu(b, h, 48, 64)
    draws = torch.rand(4, b, generator=gen)
    calls = {
        "create_attention_mask": lambda dev, dt, M: extras
        .create_attention_mask(b, t, True, (torch.arange(t, device=dev)
                                            < t - 5)[None].expand(b, t),
                               device=dev),
        "calculate_attention": lambda dev, dt, M: extras.calculate_attention(
            q.to(dev, dt), k.to(dev, dt), v.to(dev, dt), None, 0.7,
            True)[0],
        "Curiosity": lambda dev, dt, M: M["Curiosity"](
            x.to(dev, dt), xa.to(dev, dt), mask.to(dev)),
        "AdaptiveSpan": lambda dev, dt, M: M["AdaptiveSpan"](
            x.to(dev, dt))[0],
        "MyelinatedLayer": lambda dev, dt, M: M["MyelinatedLayer"](
            x.to(dev, dt)),
        "Gate": lambda dev, dt, M: M["Gate"](x.to(dev, dt)),
        "OneShot": lambda dev, dt, M: M["OneShot"](
            x.to(dev, dt), xa.to(dev, dt), torch.tensor(0.4, device=dev)),
        "ChannelLayerNorm": lambda dev, dt, M: M["ChannelLayerNorm"](
            x.to(dev, dt)),
        "Identity": lambda dev, dt, M: M["Identity"](x.to(dev, dt), 1),
        "taylor_softmax": lambda dev, dt, M: matt.taylor_softmax(
            q.to(dev, dt), 3),
        "rbf_scores": lambda dev, dt, M: matt.rbf_scores(
            q.to(dev, dt), k.to(dev, dt), 2.0, 0.4),
        "peak_normalize": lambda dev, dt, M: peak_normalize(
            x.to(dev, dt) * 0.3),
    }
    old_draws = extras.jump_draws
    try:
        with torch.no_grad():
            want = {name: fn("cpu", torch.float32, mods)
                    for name, fn in calls.items()}
            extras.jump_draws = lambda g, s, bb, device, dtype: draws.to(
                device, dtype)
            with stochastic.mode(gen=torch.Generator().manual_seed(0)):
                want["MyelinatedLayer jumps"] = mods["MyelinatedLayer"](x)
            for dt_name, dt in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                card = {n: copy.deepcopy(m).to(DEV, dt)
                        for n, m in mods.items()}
                for name, fn in calls.items():
                    got = fn(DEV, dt, card)
                    assert got.device.type == "cuda"
                    if name == "create_attention_mask":
                        check(torch.equal(got.cpu(), want[name]),
                              "latent create_attention_mask on the card: "
                              "equal to the CPU's")
                        continue
                    if dt_name == "bf16" and name == "MyelinatedLayer":
                        continue
                    out[f"{name} {dt_name}"] = _latent_close(
                        name, got, want[name], dt_name)
                gen_dev = torch.Generator(device=DEV).manual_seed(0)
                for name, ws in (("MyelinatedLayer", {}),
                                 ("MyelinatedLayer jumps", {"gen": gen_dev})):
                    with stochastic.mode(**ws):
                        got = card["MyelinatedLayer"](x.to(DEV, dt))
                    if dt_name == "f32":
                        out[f"{name} f32"] = _latent_close(
                            name, got, want[name], "f32")
                    else:
                        rel = float((got.float().cpu() - want[name]).abs()
                                    .max() / want[name].abs().max())
                        check(bool(torch.isfinite(got).all()),
                              f"latent {name} bf16 on the card: every value "
                              f"finite (read: {rel:.3e} of max|CPU f32|, "
                              "not gated)")
                        out[f"{name} bf16 (read)"] = rel
    finally:
        extras.jump_draws = old_draws
    small = Dimensions(tokens=256, mels=16, dims=64, head=2, layer=2)
    m_cpu = Model(small, ModelConfig(), device="cpu")
    m_dev = Model(small, ModelConfig(), device=DEV)
    check(init_w(m_cpu) == init_w(m_dev)
          and np.array_equal(rotary.wideband_freqs(512, 4),
                             rotary.wideband_freqs(512, 4)),
          "latent init_w on a card model equal to the CPU model's")
    del m_cpu, m_dev

    # the host features with every flag on the tones
    tok = setup_tokenizer(TOKENIZER)
    audio = tones(BATCH, UTT_SEC)
    flags = dict(spectrogram=True, pitch=True, waveform=True, harmonics=True,
                 aperiodics=True, phase=True, pitch_tokens=True)
    items = [{"audio": {"array": a, "sampling_rate": SR},
              "transcription": f"tone number {i}"}
             for i, a in enumerate(audio)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(BATCH) as pool:
        feats = list(pool.map(lambda it: extract_features(it, tok, **flags),
                              items))
    host_ms = (time.perf_counter() - t0) * 1e3
    frames = 1 + audio.shape[1] // HOP
    shapes = {"spectrogram": (128, frames), "pitch": (1, frames),
              "waveform": (1, int(UTT_SEC * (SR // HOP))),
              "harmonic": (128, frames), "aperiodic": (128, frames),
              "phase": (frames,)}
    ok = True
    for f in feats:
        ok &= all(f[k].shape == s_ and np.isfinite(f[k]).all()
                  for k, s_ in shapes.items())
        ok &= f["pitch_tokens"].shape == (len(f["labels"]) + 1,) \
            and np.isfinite(f["pitch_tokens"]).all()
    check(ok, f"extract_features with every flag on the {BATCH} tones: the "
          f"JAX shapes ({shapes}, pitch_tokens (labels + 1,)), finite, "
          f"{host_ms:.1f} ms for the {BATCH} utterances ({BATCH} threads)")
    out["extract_features_all_flags_ms"] = host_ms
    return out


def check_serve_shapes(model) -> dict:
    """The kernels at the serving path's shapes no decode path runs: a
    30 s long-form chunk (the mel on (1, 480000), flash over 3001 frames
    and the chunk decode's cross against 3001 keys, ``fused_abby`` on
    (3001, 512), the MSheath scan on (1*3001, 512)) and beam 4's cross
    (4 beams at width 65 against one utterance's 1001 keys), with the
    flagship block's weights, held as ``check_kernels`` holds them and
    timed.  Returns {kernel name: [entries]} for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F
    from asr_model_tpu_torch.models.sheath import masked_mean
    from asr_model_tpu_torch.ops.cuda import abby, attention, mel, sheath
    from asr_model_tpu_torch.ops.mel import mel_filterbank
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(41)
    out: dict = {}
    add = lambda name, entry: out.setdefault(name, []).append(entry)

    audio = torch.from_numpy(tones(1, LONG_SEC)[:, :CHUNK_SAMPLES]).to(dev)
    got, want = mel.mel_spectrogram(audio), mel.mel_spectrogram_plain(audio)
    err = (got - want).abs()
    check(bool((err <= MEL_RTOL * want.abs() + MEL_ATOL).all()),
          f"mel_spectrogram long-form chunk (1, 480000): max abs err "
          f"{float(err.max()):.3e} (tolerance {MEL_RTOL:g} |plain| + "
          f"{MEL_ATOL:g} on every bin, as at (8, 160000))")
    window = torch.hann_window(1024, device=dev)
    fb = torch.from_numpy(mel_filterbank(513, 50.0, 8000.0, 128)).to(dev)
    nnz = int(np.count_nonzero(fb.cpu().numpy()))
    flops = got.shape[-1] * (2.5 * 1024 * 10 + 3 * 513 + 2.0 * nnz)
    b_ms, b_by = bound_ms(flops, nbytes(audio, got), F32_PEAK)
    ms = cuda_ms(lambda: mel.mel_spectrogram(audio))

    def lib_mel():
        sp = torch.stft(audio, 1024, HOP, window=window, center=True,
                        pad_mode="constant", return_complex=True)
        return torch.einsum("bft,fm->bmt", sp.real ** 2 + sp.imag ** 2, fb)

    add("mel_spectrogram", dict(
        shape="serve: long-form chunk (1, 480000) f32",
        max_abs_err=float(err.max()), ms=ms,
        plain_ms=cuda_ms(lambda: mel.mel_spectrogram_plain(audio)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib_mel),
        **rates(flops, ms, b_ms)))

    for label, b, tq, tk in (
            ("serve: long-form encoder self (1,4,3001,128)", 1, 3001, 3001),
            ("serve: long-form cached cross (1,4,41,128)x(1,4,3001,128)", 1,
             41, 3001),
            ("serve: beam 4 cached cross (4,4,65,128)x(4,4,1001,128)", 4,
             65, 1001)):
        q, k, v = (torch.randn(b, 4, t_, 128, device=dev, generator=g)
                   .bfloat16() for t_ in (tq, tk, tk))
        got = attention.flash_attention(q, k, v, False, None)
        want = attention.attention_plain(q.float(), k.float(), v.float(),
                                         False, None)
        e, bad, rows = close_rows(got, want, 0.0, FLASH_TOL, 128)
        check(bad == 0, f"flash_attention {label}: max abs err {e:.3e}, "
              f"{bad}/{rows} rows out (tolerance {FLASH_TOL:g} max|plain|, "
              "as at the decode shapes)")
        flops = 4.0 * 4 * b * tq * tk * 128
        b_ms, b_by = bound_ms(flops, nbytes(q, k, v, got), BF16_PEAK)
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, False, None))
        add("flash_attention", dict(
            shape=label, max_abs_err=e, ms=ms,
            plain_ms=cuda_ms(lambda: attention.attention_plain(
                q, k, v, False, None)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v)), **rates(flops, ms, b_ms)))

    blk = model.processor.block
    norm = blk.ln
    x = (2 * torch.randn(3001, 512, device=dev, generator=g)).bfloat16()
    w = (norm.router_in.weight, norm.router_in.bias, norm.router_out.weight,
         norm.router_out.bias)
    size = abby.window_size(512)
    got = abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75)
    want = abby.abby_plain(x, *w, size, 1e-4, 1.0, 0.75)
    e, bad, rows = close_rows(got, want, 8e-3, 1e-3, 512)
    check(bad <= rows // 1000, f"fused_abby serve: long-form (3001, 512): "
          f"max abs err {e:.3e}, {bad}/{rows} rows out (the tolerance at "
          "the decode shapes)")
    flops = _abby_ops(3001, 512, size)
    b_ms, b_by = bound_ms(flops, nbytes(x, got, *w), BF16_PEAK)
    ms = cuda_ms(lambda: abby.fused_abby(x, *w, size, 1e-4, 1.0, 0.75))
    add("fused_abby", dict(
        shape="serve: long-form (3001, 512)", max_abs_err=e, ms=ms,
        plain_ms=cuda_ms(lambda: abby.abby_plain(x, *w, size, 1e-4, 1.0,
                                                 0.75)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **rates(flops, ms, b_ms)))

    jm = blk.jump
    wts = jm.scan_weights()
    sw = {kk: wts[kk] for kk in sheath.WEIGHT_NAMES}
    kw = sheath.kernel_weights(sw, jm.layer)
    n_prod = 3 if kw["split"] else 2
    x = torch.randn(1, 3001, 512, device=dev, generator=g).bfloat16()
    pooled = masked_mean(x, None, dim=1)[:, 0]
    sampled = torch.argmax(jm.pnet(pooled).mean(0)).to(torch.int32)
    args = (x.reshape(-1, 512), 1, None, wts["mem0"], sampled, wts["jump_s"],
            sw, jm.layer, jm.thresh)
    got, act_k, js_k = sheath.fused_sheath_scan(*args)
    want, act_p, js_p = sheath.sheath_scan_plain(*args)
    e, bad, rows = close_rows(got, want, 8e-3, 1e-3, 512)
    same = act_k.tolist() == act_p.tolist() and js_k.tolist() == js_p.tolist()
    check(bad <= rows // 1000 and same,
          f"fused_sheath_scan serve: long-form (1*3001, 512): max abs err "
          f"{e:.3e}, {bad}/{rows} rows out, actions {act_k.tolist()} vs "
          f"{act_p.tolist()} (the tolerance at the decode shapes; actions "
          "and jstat exact)")
    slots, i = [], 0
    for a in act_k.tolist():
        if i >= jm.layer:
            break
        slots.append(i)
        i = min(i + a + 1, jm.layer) if a > 0 else i + 1
    n, d2, m = 3001, 256, jm.mem
    flops = sum(2.0 * n * 512 * (m + d2) + (2.0 * n * 512 * 512
                                           if s_ % 2 == 0 else 0)
                + 30.0 * n * 512 for s_ in slots)
    b_ms, b_by = bound_ms(flops, nbytes(x, got, wts["mem0"], wts["jump_s"])
                          + _sheath_weight_bytes(sw, kw, slots),
                          TF32_PEAK / n_prod)
    ms = cuda_ms(lambda: sheath.fused_sheath_scan(*args))
    add("fused_sheath_scan", dict(
        shape="serve: long-form (1*3001, 512)", max_abs_err=e,
        slots=len(slots), ms=ms,
        plain_ms=cuda_ms(lambda: sheath.sheath_scan_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tf32_products=n_prod, **rates(flops, ms, b_ms)))
    return out


WIDE_D = 1280                # a block wider than any in the repo's configs


def _mlp_ops(n: int, d: int, nt: int, hid: int) -> float:
    """The residual MLP's operations (as counted for fused_mlp_residual)."""
    from asr_model_tpu_torch.ops.cuda.abby import window_size
    return (2 * _abby_ops(n, d, window_size(d)) + 2.0 * n * d * nt * (d + 1)
            + 4.0 * n * d * nt + 4.0 * n * d * hid + 10.0 * n * hid + n * d)


def _wide_mlp(g) -> dict:
    """fused_mlp_residual at (8*65, 1280), 3 gates, hidden 3840, random
    weights: its check and its timing entry."""
    import torch
    from asr_model_tpu_torch.ops.cuda import abby, mlp
    d, n, nt = WIDE_D, BATCH * 65, 3
    hid = nt * d
    r = lambda *sh, sc=1.0: (sc * torch.randn(*sh, device=DEV, generator=g)
                             ).bfloat16()
    args = (r(n, d), _norm_weights(g, d), r(nt, d, sc=d ** -0.5),
            r(nt, sc=0.1), [(r(d, d, sc=d ** -0.5), r(d, sc=0.1))
                            for _ in range(nt)],
            r(hid, d, sc=d ** -0.5), r(hid, sc=0.1),
            r(d, hid, sc=hid ** -0.5), r(d, sc=0.1), abby.window_size(d),
            1e-4, 1.0, 0.75)
    got = mlp.fused_mlp_residual(*args)
    want = mlp.mlp_residual_plain(*args)
    label = "D 1280 block (8*65, 1280), 3 gates, hidden 3840"
    e = _fused_close(f"fused_mlp_residual {label}", got, want, d)
    ops = _mlp_ops(n, d, nt, hid)
    wb = nbytes(*args[1], args[2], args[3], *[t for gw in args[4]
                                              for t in gw], *args[5:9])
    b_ms, b_by = bound_ms(ops, nbytes(args[0], got) + wb, BF16_PEAK)
    ms = cuda_ms(lambda: mlp.fused_mlp_residual(*args))
    return dict(shape=label, max_abs_err=e, ms=ms,
                plain_ms=cuda_ms(lambda: mlp.mlp_residual_plain(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **rates(ops, ms, b_ms))


def _wide_attn_full(g, valid) -> dict:
    """fused_attn_full self causal at (8, 65, 1280), 10 heads of 128,
    random weights, the decode's prefix mask: its check and its timing
    entry."""
    import torch
    from asr_model_tpu_torch.models.rotary import compute_freqs
    from asr_model_tpu_torch.ops.cuda import abby, xattn
    d, heads, t = WIDE_D, WIDE_D // 128, valid.shape[1]
    r = lambda *sh, sc=1.0: (sc * torch.randn(*sh, device=DEV, generator=g)
                             ).bfloat16()
    norm = lambda n: dict(zip(("n_w1", "n_b1", "n_w2", "n_b2"),
                              _norm_weights(g, n)))
    wq = norm(d) | {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    wkv = norm(d) | {"proj_w": r(2 * d, d, sc=d ** -0.5),
                     "proj_b": r(2 * d, sc=0.1)}
    wo = {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    kw = dict(wq=wq, wkv=wkv, wh=norm(128), wo=wo, head=heads,
              size_d=abby.window_size(d), size_h=abby.window_size(128),
              alpha=1e-4, k=1.0, beta=0.75)
    x = r(BATCH, t, d, sc=0.5)
    fr = torch.from_numpy(compute_freqs(d, heads, True)).to(DEV)
    args = (x, x, valid, fr)
    got = xattn.fused_attn_full(*args, causal=True, **kw)
    want = xattn.attn_full_plain(*args, causal=True, **kw)
    label = "D 1280 block self causal (8,65,1280) + kv_valid"
    e = _fused_close(f"fused_attn_full {label}", got, want, d)
    n, hd = BATCH * t, 128
    q_side = (_abby_ops(n, d, kw["size_d"]) + 2.0 * n * d * d + 6.0 * n * d
              + _abby_ops(n * heads, hd, kw["size_h"]) + 2.0 * n * d * d)
    ops = (q_side + _abby_ops(n, d, kw["size_d"]) + 4.0 * n * d * d
           + 6.0 * n * d + _abby_ops(n * heads, hd, kw["size_h"])
           + heads * _pairs(t, t, True, valid) * (4.0 * hd + 5))
    wb = sum(nbytes(*v.values()) for v in (wq, wkv, kw["wh"], wo))
    b_ms, b_by = bound_ms(ops, nbytes(x, valid, got) + wb, BF16_PEAK)
    ms = cuda_ms(lambda: xattn.fused_attn_full(*args, causal=True, **kw))
    return dict(shape=label, max_abs_err=e, ms=ms,
                plain_ms=cuda_ms(lambda: xattn.attn_full_plain(
                    *args, causal=True, **kw)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **rates(ops, ms, b_ms))


# --------------------------------------------------------------- the paths

FUSED_FIELDS = dict(fused_attention=True, fused_mlp=True, fused_router=True)


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


def transcribe(model, audio, stream: bool = False, dtype=None):
    """The ids of a decode of ``audio``: the buffer decode, or with
    ``stream`` the incremental decode of a streaming model."""
    from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                     greedy_decode_stream)
    mel, f0, wav = frontend(audio, dtype)
    decode = greedy_decode_stream if stream else greedy_decode
    return decode(model, spectrogram=mel, pitch=f0, waveform=wav,
                  max_new_tokens=NEW_TOKENS, suppress_eos=True)


def flagship(fused: bool, dtype=None, streaming: bool = False):
    """The flagship model from seed 0 (the same weights on every path:
    a streaming model has the same parameters), bf16 unless ``dtype``
    says otherwise."""
    import torch
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model, cast_variables
    cfg = ModelConfig(streaming=streaming, **(FUSED_FIELDS if fused else {}))
    m = Model(Dimensions(), cfg, device=DEV, seed=0)
    return m if dtype == torch.float32 else cast_variables(m)


def plain_route():
    """Point every kernel wrapper at its plain version (for comparing the
    two routes on the card); returns the undo."""
    from asr_model_tpu_torch.ops import cuda as kernels
    saved = []
    for wrapper, plain in kernels.WRAPPERS.values():
        mod = sys.modules[wrapper.__module__]
        saved.append((mod, wrapper.__name__, wrapper))
        setattr(mod, wrapper.__name__, plain)

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


def stream_state(model, audio, dtype=None, ids=None, upto: int = 0):
    """The stream decode's inputs for ``audio``: the cross K/V, the
    state after the steps at positions 0..upto-1 (tokens from ``ids``),
    and the sinusoid table."""
    from asr_model_tpu_torch.models.generate import prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops.audio import sinusoids
    mel, f0, wav = frontend(audio, dtype)
    xa_kv = prepare_cross(model, modality_slots(f0, mel, wav))
    proc, T = model.processor, 1 + NEW_TOKENS
    state = proc.init_stream_state(audio.shape[0], T, mel.dtype)
    pe = sinusoids(T, proc.dims, proc.theta, device=audio.device)
    for pos in range(upto):
        proc.decode_stream_step(ids[:, pos], pos, state, xa_kv, pe)
    return xa_kv, state, pe


def first_stream_logits(model, audio, dtype):
    """The logits of the stream decode's first step (BOS at position 0)."""
    import torch
    from asr_model_tpu_torch.config import BOS_ID
    xa_kv, state, pe = stream_state(model, audio, dtype)
    bos = torch.full((audio.shape[0],), BOS_ID, dtype=torch.long,
                     device=audio.device)
    return model.processor.decode_stream_step(bos, 0, state, xa_kv, pe)[0]


def compare_logits(lk, lp, tol: float, what: str) -> float:
    """Fails past ``tol`` of the largest reference logit or when any
    row's argmax differs."""
    import torch
    rel = float((lk - lp).abs().max()) / float(lp.abs().max())
    same = bool((lk.argmax(-1) == lp.argmax(-1)).all())
    check(bool(torch.isfinite(lk).all()) and rel < tol and same,
          f"{what}: max abs err / max|ref| = {rel:.3e} (tolerance {tol:g}); "
          f"argmax {'identical' if same else 'DIFFERS'} in the "
          f"{lk.shape[0]} rows")
    return rel


def route_check(model, audio, dtype, tol: float, why: str, label: str,
                logits=first_step_logits):
    """The first decode step's logits on the kernel route against the
    plain route on the card."""
    lk = logits(model, audio, dtype)
    undo = plain_route()
    try:
        lp = logits(model, audio, dtype)
    finally:
        undo()
    rel = compare_logits(lk, lp, tol, f"{label}: first decode step logits, "
                         f"kernel vs plain route ({str(dtype)[6:]}; {why})")
    return rel, lk


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# kernels the profiler names (demangled) for the wrappers whose launches
# one decode step checks against the wrappers' own count (on the paths
# that run them); the two whole attention calls share their rows kernel,
# so they are counted together
PROFILED = {("fused_abby",): ("abby_cluster_kernel",),
            ("fused_sheath_scan",): ("sheath_rows", "sheath_mem_ctl",
                                     "sheath_finish"),
            ("fused_attn_full", "fused_attn_cached"): (
                "xattn_full_rows", "xattn_full_attend",
                "xattn_cached_attend"),
            ("fused_mlp_residual",): ("mlp_norm", "mlp_gates_tc",
                                      "mlp_linear_tc")}


def _clone(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def step_profile(model, audio, ids, stream: bool = False, feats=None):
    """Every device kernel of one decode step, PyTorch's own included,
    under torch.profiler: the buffer decode's at the last bucket (width
    65, 64 live positions; on ``feats`` when given, else the YIN
    frontend's features of ``audio``), or the stream decode's at position
    64 (its caches full).  Returns (kernel launches, their device ms, copies and
    fills, top kernels, and for each wrapper of ``PROFILED`` its
    launches as (the profiler's count, the wrapper's count))."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile

    from asr_model_tpu_torch.models.generate import decode_step, prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops import cuda as kernels
    if stream:
        xa_kv, state, pe = stream_state(model, audio, ids=ids,
                                        upto=NEW_TOKENS)
        warm = _clone(state)

        def step(st):
            model.processor.decode_stream_step(ids[:, NEW_TOKENS],
                                               NEW_TOKENS, st, xa_kv, pe)
        step(warm)
        args = (state,)
    else:
        mel, f0, wav = frontend(audio) if feats is None else (
            feats["spectrogram"], feats["pitch"], feats["waveform"])
        xa_kv = prepare_cross(model, modality_slots(f0, mel, wav))
        buf = ids[:, :1 + NEW_TOKENS].contiguous()

        def step():
            decode_step(model, buf, xa_kv, NEW_TOKENS)
        step()
        args = ()
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    counted = kernels.counts()
    rows, copies = [], 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key.startswith(("Memcpy", "Memset")):
            copies += evt.count
        else:
            rows.append((evt.key, evt.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    seen = {ws: (sum(c for k, c, _ in rows
                     if any(re.search(rf"\b{n}\b", k) for n in names)),
                 sum(counted[w]["launches"] for w in ws))
            for ws, names in PROFILED.items()}
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), copies,
            [{"kernel": k[:60], "count": c, "ms": m} for k, c, m in rows[:8]],
            seen)


def drive_path(model, audio, label: str, expect, runs: int = 2,
               stream: bool = False, step_expect=None):
    """One decode path: a warm-up, the counted run (every kernel in
    ``expect`` launched, no other, no plain version), ``runs`` timed runs,
    the phase split and the launches of one decode step (where the
    wrappers of ``step_expect``, default ``expect``, must show in the
    profile).  ``stream``: the incremental decode of a streaming model."""
    import torch
    from asr_model_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
    from asr_model_tpu_torch.models.generate import prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops import cuda as kernels

    transcribe(model, audio, stream)         # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    ids = transcribe(model, audio, stream)
    torch.cuda.synchronize()
    counts = kernels.counts()
    log(f"{label} path kernels " + json.dumps(counts))
    for name, c in counts.items():
        if name in expect:
            check(c["launches"] > 0, f"{label} path launched {name} "
                  f"{c['launches']} times")
        else:
            check(c["launches"] == 0, f"{label} path did not launch {name} "
                  f"({c['launches']})")
        check(c["plain_calls"] == 0, f"{label} path made no plain {name} "
              f"call ({c['plain_calls']})")

    vocab = model.dims.tokens
    check(tuple(ids.shape) == (BATCH, 1 + NEW_TOKENS),
          f"{label} path output ids shape {tuple(ids.shape)}")
    check(bool((ids[:, 0] == BOS_ID).all()) and bool((ids >= 0).all())
          and bool((ids < vocab).all()), f"{label} path ids start with BOS, "
          "in vocab")
    check(not bool((ids[:, 1:-1] == EOS_ID).any())
          and not bool((ids[:, 1:] == PAD_ID).any()),
          f"{label} path: no EOS before the budget (suppressed), no PAD")

    times = []                      # seconds per batch, each synchronised
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transcribe(model, audio, stream)
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
    launches, dev_ms, copies, top, seen = step_profile(model, audio, ids,
                                                       stream)
    for ws, (prof_n, wrap_n) in seen.items():
        if not all(w in (step_expect or expect) for w in ws):
            continue
        # the profiler may drop an event (a run read 15 of 16), never add
        check(0 < prof_n <= wrap_n, f"{label} path, one decode step: the "
              f"profiler saw {prof_n} {' + '.join(ws)} kernel launches, the "
              f"wrapper{'s' if len(ws) > 1 else ''} counted {wrap_n}")
    log(f"{label} path: RTFx {rtfx:.3f} (median of {runs} runs of "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms per batch of {BATCH} x {UTT_SEC:.0f} s); frontend "
        f"{front_ms:.3f} ms, encode + re-encode + cross K/V {prep_ms:.3f} ms")
    where = "position 64" if stream else "width 65"
    log(f"{label} path: decode {step_ms:.3f} ms per step; one step at "
        f"{where}: {launches} kernel launches ({dev_ms:.3f} ms of device "
        f"time) and {copies} copies/fills under torch.profiler")
    return dict(rtfx=rtfx, ms_per_batch=total * 1e3,
                ms_per_batch_runs=[t * 1e3 for t in times],
                frontend_ms=front_ms, prepare_ms=prep_ms,
                decode_ms_per_step=step_ms, step_launches=launches,
                step_device_ms=dev_ms, step_copies=copies, step_top=top,
                counts=counts, ids=ids)


# ------------------------------------------------------------- serving

LONG_SEC, LONG_TOKENS, CHUNK_SAMPLES = 62.0, 32, 30 * SR
TOKENIZER = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                         "tokenizer.json")


def serve_logits(model, audio, dtype):
    """The first decode step's logits on the serving frontend's features
    (log-mel, DIO + StoneMask pitch, frame-rate waveform)."""
    import torch
    from asr_model_tpu_torch.config import BOS_ID
    from asr_model_tpu_torch.models.generate import decode_step, prepare_cross
    from asr_model_tpu_torch.models.longform import features
    from asr_model_tpu_torch.models.model import modality_slots
    mel, f0, wav = features(audio, SR, HOP, model.dims.mels, dtype, "dio")
    xa_kv = prepare_cross(model, modality_slots(f0, mel, wav))
    ids = torch.full((audio.shape[0], 9), 0, dtype=torch.long,
                     device=audio.device)
    ids[:, 0] = BOS_ID
    return decode_step(model, ids, xa_kv, 1)


def _check_counts(label, counts, expect):
    for name, c in counts.items():
        if name in expect:
            check(c["launches"] > 0, f"{label} launched {name} "
                  f"{c['launches']} times")
        else:
            check(c["launches"] == 0, f"{label} did not launch {name} "
                  f"({c['launches']})")
        check(c["plain_calls"] == 0, f"{label} made no plain {name} call "
              f"({c['plain_calls']})")


def host_ms(fn, runs: int = 3) -> float:
    """Median wall ms of ``fn`` from a synchronised start to a
    synchronised end."""
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_launches(fn):
    """(kernel launches, their device ms) of one call of ``fn`` under
    torch.profiler, PyTorch's own kernels and copies included."""
    n, ms, _ = profile_kernels(fn)
    return n, ms


def profile_kernels(fn):
    """``profile_launches``, and per kernel (device ms, launches, name),
    of one call of ``fn`` after one unprofiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms, per = 0, 0.0, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA \
                and not _annotation(evt):
            n += evt.count
            ms += us / 1e3
            per.append((us / 1e3, evt.count, evt.key))
    return n, ms, per


def _annotation(evt) -> bool:
    """A range the profiler records on the device timeline for an
    annotated region (``Optimizer.step#MaxFactor.step``), not a kernel:
    its device time spans the kernels it holds."""
    return bool(getattr(evt, "is_user_annotation", False)) or \
        evt.key.startswith("Optimizer.")


def check_dio(audio):
    """The contour kernel against its plain version (exactly) on DIO's
    own candidates of the tones (B 8 x 1001 frames) and of a 30 s
    long-form chunk (1 x 3001), timed; the card's whole DIO + StoneMask
    against the port's CPU route.  Returns the kernel's entry."""
    import torch
    from asr_model_tpu_torch.ops import dio
    from asr_model_tpu_torch.ops.cuda import dio as K
    vrm = dio.short_run(HOP / SR * 1000.0)
    chunk = torch.from_numpy(tones(1, LONG_SEC)[:, :CHUNK_SAMPLES]).to(DEV)
    # the tones with every other 0.25 s a stretch of noise: voiced runs
    # that end, start and jump, so the contour fix has frames to change
    gapped = audio.clone()
    g = torch.Generator(device=DEV).manual_seed(7)
    for i in range(0, gapped.shape[-1], SR // 2):
        gapped[:, i:i + SR // 4] = 0.5 * torch.randn(
            gapped.shape[0], min(SR // 4, gapped.shape[-1] - i), device=DEV,
            generator=g)
    entries = []
    for label, x in (("tones (8, 7, 1001)", audio),
                     ("long-form chunk (1, 7, 3001)", chunk),
                     ("tones with noise gaps (8, 7, 1001)", gapped)):
        cand, f0, _ = dio.contour_inputs(x, SR, HOP / SR * 1000.0)
        got = K.dio_contour(cand, f0, vrm, 0.1)
        want = K.dio_contour_plain(cand, f0, vrm, 0.1)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        changed = int((got != f0).sum())
        check(same, f"dio_contour {label}: {'equal to' if same else 'DIFFERS from'}"
              f" the plain version (max abs err {err:.3e}; the fix changed "
              f"{changed} of {f0.numel()} frames; tolerance: exact, the "
              "kernel only compares and selects)")
        # the bound: the candidates and f0 read once, the contour written
        # once; the scans' operations (a division, a compare and a select
        # per candidate and frame, both ways) at the f32 rate
        b, nb, nf = cand.shape
        flops = 2.0 * b * nf * nb * 6 + 10.0 * b * nf
        b_ms, b_by = bound_ms(flops, nbytes(cand, f0, got), F32_PEAK)
        ms = cuda_ms(lambda: K.dio_contour(cand, f0, vrm, 0.1))
        plain = cuda_ms(lambda: K.dio_contour_plain(cand, f0, vrm, 0.1),
                        iters=1, warmup=1)
        log(f"dio_contour {label}: {ms:.4f} ms, plain version {plain:.1f} ms, "
            f"bound {b_ms:.3g} ms ({b_by})")
        entries.append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    card, _ = dio.dio_pitch_track(audio)
    cpu, _ = dio.dio_pitch_track(audio.cpu())
    card, cpu = card.cpu().numpy(), cpu.numpy()
    vc, vp = card > 0, cpu > 0
    both = vc & vp
    d = np.abs(card[both] - cpu[both])
    share, med, mean = float((vc == vp).mean()), float(np.median(d)), \
        float(d.mean())
    check(share >= 0.99 and med < 0.01 and mean < 0.5,
          f"dio_pitch_track (8, 160000) on the card vs the CPU route: "
          f"voicing equal on {100 * share:.2f}% of frames; on the "
          f"{int(both.sum())} voiced in both median |df0| {med:.3e} Hz, "
          f"mean {mean:.3e}, max {float(d.max()):.3e} (tolerance >= 99%, "
          "median < 0.01 Hz, mean < 0.5 Hz: FFTs in other orders can move "
          "a zero crossing and so one frame's candidate)")
    return dict(name="dio_contour", route="cuda",
                source="asr_model_tpu_torch/csrc/dio.cu",
                replaces="asr_model_tpu/ops/dio.py:181 (_fix_contour, "
                         "an XLA lax.scan: no Pallas kernel)",
                **{k: entries[0][k] for k in entries[0] if k != "shape"},
                shape=entries[0]["shape"], shapes=entries,
                dio_vs_cpu=dict(voicing_share=share, median_hz=med,
                                mean_hz=mean))


def serve_path(model, audio):
    """``Transcriber`` on the flagship weights (bf16, DIO pitch on the
    card, the port's tokenizer): ``transcribe_batch`` on the 8 x 10 s
    tones (64 new tokens, EOS not suppressed), ``__call__`` with beam 4
    on one of them, ``transcribe_long`` on 62 s (3 chunks of 30 s, 32
    tokens a chunk).  The counted run covers all three and must launch
    exactly ``SERVE_PATH``; each transcript must equal the tokenizer's
    decode of its ids."""
    import torch
    from asr_model_tpu_torch.config import EOS_ID, PAD_ID
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    from asr_model_tpu_torch.models.beam import beam_search
    from asr_model_tpu_torch.models.generate import greedy_decode
    from asr_model_tpu_torch.models.longform import chunk_audio
    from asr_model_tpu_torch.models.longform import transcribe_long
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.ops.audio import frame_rate_waveform
    from asr_model_tpu_torch.ops.dio import dio_pitch_track
    from asr_model_tpu_torch.ops.mel import log_mel_spectrogram
    from asr_model_tpu_torch.transcribe import Transcriber
    tok = setup_tokenizer(TOKENIZER)
    t = Transcriber(model, tok, bf16=True, max_new_tokens=NEW_TOKENS,
                    device=DEV)
    wavs = list(audio.cpu().numpy())
    long_wav = tones(1, LONG_SEC)[0]
    long_kw = dict(max_new_tokens_per_chunk=LONG_TOKENS)
    t.transcribe_batch(wavs)                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    texts = t.transcribe_batch(wavs)
    beam_text = t(wavs[0], beam_size=4)
    long_text = t.transcribe_long(long_wav, **long_kw)
    torch.cuda.synchronize()
    counts = kernels.counts()
    log("serve path kernels " + json.dumps(counts))
    _check_counts("serve path", counts, kernels.SERVE_PATH)

    feats = t.features(audio)
    ids = t._decode(feats, NEW_TOKENS)
    gen = ids[:, 1:]
    tokens = int((gen > EOS_ID).sum())
    check(texts == tok.batch_decode(ids.tolist()) and len(texts) == BATCH,
          f"serve transcribe_batch: {BATCH} transcripts, each the "
          f"tokenizer's decode of its ids ({tokens} text tokens of "
          f"{BATCH * NEW_TOKENS} decoded, {int((gen == EOS_ID).sum())} EOS, "
          f"{int((gen == PAD_ID).sum())} PAD, {int((gen == 1).sum())} BOS; "
          f"the weights are random); first: {texts[0][:60]!r}")
    sample = "the quick brown fox, 1234 don't"
    check(tok.decode(tok.encode(sample)) == " " + sample,
          f"the port's tokenizer (no regex package): encode + decode of "
          f"{sample!r} gives it back (with the ByteLevel prefix space)")
    b_ids, b_score = beam_search(model, **t.features(audio[:1]), beam_size=4,
                                 max_new_tokens=NEW_TOKENS)
    check(beam_text == tok.decode(b_ids[0].tolist())
          and bool(torch.isfinite(b_score).all()),
          f"serve beam 4: the transcript is the decode of the best beam "
          f"(score {float(b_score[0]):.4f}): {beam_text[:60]!r}")
    l_ids, l_text = transcribe_long(model, long_wav, tokenizer=tok,
                                    **long_kw)
    n_chunks = len(chunk_audio(long_wav, SR))
    check(n_chunks == 3 and l_text == long_text
          and l_text == tok.decode(l_ids),
          f"serve transcribe_long {LONG_SEC:.0f} s: {n_chunks} chunks, "
          f"{len(l_ids)} tokens, the transcript the decode of its ids")

    batch_ms = [host_ms(lambda: t.transcribe_batch(wavs), runs=1)
                for _ in range(2)]
    rtfx = BATCH * UTT_SEC / (float(np.median(batch_ms)) / 1e3)
    beam_ms = host_ms(lambda: t(wavs[0], beam_size=4), runs=1)
    long_ms = host_ms(lambda: t.transcribe_long(long_wav, **long_kw),
                      runs=1)
    front = dict(
        mel=host_ms(lambda: log_mel_spectrogram(audio, SR, 1024, HOP, 128)),
        dio=host_ms(lambda: dio_pitch_track(audio, SR, HOP / SR * 1000.0)),
        waveform=host_ms(lambda: frame_rate_waveform(audio, SR, HOP)),
        whole=host_ms(lambda: t.features(audio)))
    dio_n, dio_dev = profile_launches(
        lambda: dio_pitch_track(audio, SR, HOP / SR * 1000.0))
    front_n, front_dev = profile_launches(lambda: t.features(audio))
    s_launches, s_dev, s_copies, s_top, _ = step_profile(model, audio, ids,
                                                         feats=feats)
    # the decode alone on the serve features (DIO) and on the default
    # path's (YIN), both without EOS suppression, in turns A B
    yin = dict(zip(("spectrogram", "pitch", "waveform"), frontend(audio)))
    dec = {"dio": [], "yin": []}
    for name in ("dio", "yin"):
        f = feats if name == "dio" else yin
        dec[name].append(host_ms(lambda: greedy_decode(
            model, **f, max_new_tokens=NEW_TOKENS), runs=1))
    log(f"serve path: RTFx {rtfx:.3f} (median of {len(batch_ms)} "
        "transcribe_batch runs of " + ", ".join(f"{m:.1f}" for m in batch_ms) + f" ms, {BATCH} x "
        f"{UTT_SEC:.0f} s, {NEW_TOKENS} new tokens); beam 4 on one "
        f"utterance {beam_ms:.1f} ms; transcribe_long {LONG_SEC:.0f} s "
        f"{long_ms:.1f} ms (RTFx {LONG_SEC / long_ms * 1e3:.3f})")
    log(f"serve frontend ({BATCH} x {UTT_SEC:.0f} s): {front['whole']:.3f} ms in all, "
        f"{front_n} kernel launches, {front_dev:.3f} ms of device time; "
        f"mel {front['mel']:.3f} ms, DIO + StoneMask {front['dio']:.3f} ms "
        f"({dio_n} launches, {dio_dev:.3f} ms of device time), waveform "
        f"{front['waveform']:.3f} ms")
    log("serve path: the decode alone (ms, turns A B): on the DIO "
        f"features {dec['dio']}, on the YIN features {dec['yin']}")
    log(f"serve path: one decode step at width 65 on the serve features: "
        f"{s_launches} kernel launches ({s_dev:.3f} ms of device time) and "
        f"{s_copies} copies/fills under torch.profiler; top: "
        + json.dumps(s_top[:4]))
    return dict(rtfx=rtfx, decode_ms_dio=dec["dio"], decode_ms_yin=dec["yin"],
                step_launches=s_launches, step_device_ms=s_dev,
                step_top=s_top, ms_per_batch_runs=batch_ms, beam4_ms=beam_ms,
                long_ms=long_ms, long_rtfx=LONG_SEC / long_ms * 1e3,
                tokens_decoded=tokens, frontend_ms=front,
                frontend_launches=front_n, frontend_device_ms=front_dev,
                dio_launches=dio_n, dio_device_ms=dio_dev, counts=counts)


def serve_stream(model, audio):
    """``transcribe_batch`` on the streaming flagship: it must take
    ``greedy_decode_stream`` (once) and give that decode's ids."""
    import torch
    import asr_model_tpu_torch.transcribe as T
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    from asr_model_tpu_torch.ops import cuda as kernels
    t = T.Transcriber(model, setup_tokenizer(TOKENIZER), bf16=True,
                      max_new_tokens=NEW_TOKENS, device=DEV)
    wavs = list(audio.cpu().numpy())
    calls = []
    orig = T.greedy_decode_stream

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    T.greedy_decode_stream = spy
    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        texts = t.transcribe_batch(wavs)
        torch.cuda.synchronize()
    finally:
        T.greedy_decode_stream = orig
    counts = kernels.counts()
    _check_counts("serve stream path", counts, kernels.SERVE_PATH)
    ids = orig(model, **t.features(audio), max_new_tokens=NEW_TOKENS)
    check(len(calls) == 1 and texts == t.tokenizer.batch_decode(ids.tolist()),
          f"serve on the streaming flagship: transcribe_batch took "
          f"greedy_decode_stream {len(calls)} time(s) and gave its ids' "
          "transcripts")
    return dict(counts=counts)


def small_reference(fused: bool, streaming: bool = False):
    """A small f32 model (head width 128, so the fused gate admits it):
    kernel route on the card against the plain route on the CPU (the
    route the CPU tests hold against the JAX package); a streaming one
    also through its stream decode's steps."""
    import torch
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    dims = Dimensions(tokens=512, mels=16, dims=128, head=1, layer=4)
    cfg = ModelConfig(streaming=streaming,
                      **(FUSED_FIELDS if fused else {}))
    rng = np.random.RandomState(0)
    feats = dict(spectrogram=rng.randn(2, 16, 48).astype(np.float32),
                 pitch=rng.rand(2, 1, 48).astype(np.float32),
                 waveform=rng.randn(2, 1, 48).astype(np.float32))
    ids = torch.from_numpy(rng.randint(3, 512, size=(2, 6)))
    cpu = Model(dims, cfg, device="cpu", seed=1)
    gpu = Model(dims, cfg, device=DEV, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    want = cpu(ids, **{k: torch.from_numpy(v) for k, v in feats.items()})
    kernels.reset_counts()
    got = gpu(ids.to(DEV), **{k: torch.from_numpy(v).to(DEV)
                              for k, v in feats.items()})
    c = kernels.counts()
    names = (kernels.FUSED_ONLY if fused else
             ("flash_attention", "fused_abby", "fused_sheath_scan"))
    rel = float((got["logits"].cpu() - want["logits"]).abs().max()) \
        / float(want["logits"].abs().max())
    what = "streaming " if streaming else ""
    what += "f32 model" + (" (fused path)" if fused else "")
    check(rel < 1e-3 and all(c[n]["launches"] > 0 for n in names),
          f"small {what}, card kernels vs CPU plain: max abs err / max|ref| "
          f"= {rel:.3e} (tolerance 1e-3: f32 sums in other orders through "
          "the stack); launched "
          + ", ".join(f"{n} {c[n]['launches']}" for n in names))
    if streaming:
        steps = [_small_stream_logits(m, ids, feats) for m in (cpu, gpu)]
        srel = float((steps[1].cpu() - steps[0]).abs().max()) \
            / float(steps[0].abs().max())
        check(srel < 1e-3, f"small {what}, the stream decode's logits at "
              f"positions 0..{ids.shape[1] - 1} (tokens teacher-forced), "
              f"card kernels vs CPU plain: max abs err / max|ref| = "
              f"{srel:.3e} (tolerance 1e-3)")
        rel = max(rel, srel)
    return rel


def _small_stream_logits(model, ids, feats):
    """(T, B, vocab) logits of the stream decode's steps over ``ids``."""
    import torch
    from asr_model_tpu_torch.models.generate import prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops.audio import sinusoids
    dev = model.device
    f = {k: torch.from_numpy(v).to(dev) for k, v in feats.items()}
    xa_kv = prepare_cross(model, modality_slots(f["pitch"], f["spectrogram"],
                                                f["waveform"]))
    proc, (b, t) = model.processor, ids.shape
    state = proc.init_stream_state(b, t, torch.float32)
    pe = sinusoids(t, proc.dims, proc.theta, device=dev)
    ids = ids.to(dev)
    return torch.stack([proc.decode_stream_step(ids[:, p], p, state, xa_kv,
                                                pe)[0] for p in range(t)])


def stream_vs_buffer(model, audio, dtype, tol: float):
    """The stream decode's tokens against the buffer decode's on the same
    streaming model.  In f32 (``tol`` given) they must be equal, unless
    at the first step where they differ the buffer's two largest logits
    of each differing row lie within ``tol`` max|logits| (a near tie that
    sums in other orders may break the other way); in bf16 the share of
    identical tokens is a record.  Returns that share."""
    import torch
    from asr_model_tpu_torch.config import EOS_ID
    from asr_model_tpu_torch.models.generate import decode_step, prepare_cross
    from asr_model_tpu_torch.models.model import modality_slots
    ids_s = transcribe(model, audio, True, dtype)
    ids_b = transcribe(model, audio, False, dtype)
    share = float((ids_s == ids_b).float().mean())
    if tol is None:
        log(f"stream vs buffer decode of the streaming model "
            f"({str(dtype)[6:]}): {100 * share:.1f}% of the tokens identical")
        return share
    if share == 1.0:
        check(True, f"stream vs buffer decode of the streaming model "
              f"({str(dtype)[6:]}): tokens identical")
        return share
    col = int((ids_s != ids_b).any(dim=0).nonzero()[0])
    rows = (ids_s[:, col] != ids_b[:, col]).nonzero()[:, 0]
    mel, f0, wav = frontend(audio, dtype)
    xa_kv = prepare_cross(model, modality_slots(f0, mel, wav))
    lg = decode_step(model, ids_b, xa_kv, col)
    if col < ids_b.shape[1] - 1:
        lg[:, EOS_ID] = float("-inf")
    top2 = lg[rows].topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).max()) / float(
        lg[torch.isfinite(lg)].abs().max())
    check(margin <= tol, f"stream vs buffer decode of the streaming model "
          f"({str(dtype)[6:]}): {100 * share:.1f}% identical; first "
          f"difference at step {col} in rows {rows.tolist()}, the buffer's "
          f"top-two margin there {margin:.3e} max|logits| (a near tie "
          f"passes within {tol:g}, the route tolerance)")
    return share


def stream_rtfx_at(model, batch: int, runs: int = 1) -> float:
    """RTFx of the stream decode at ``batch`` utterances (median of
    ``runs`` after a warm-up)."""
    import torch
    audio = torch.from_numpy(tones(batch, UTT_SEC)).to(DEV)
    transcribe(model, audio, True)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transcribe(model, audio, True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rtfx = batch * UTT_SEC / float(np.median(times))
    log(f"stream path at B {batch}: RTFx {rtfx:.3f} (median of {runs} runs "
        "of " + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms per batch "
        f"of {batch} x {UTT_SEC:.0f} s)")
    return rtfx


# ------------------------------------------------------------ training

TRAIN_TOKENS, TRAIN_MELS = 64, 128
# step 0 on the kernel route against the plain route: the loss's
# relative tolerance (f32 sums in other orders; bf16 rounds at other
# places).  The grad norm's limit is measured in the run (``train_path``):
# at the flagship's random init the norm is ~1e6 and a one-ulp change
# of every attention output moves it 0.26% (f32) and 50% (bf16) (this
# script on an H100 80GB HBM3, 700.00 W), so the limit is the geometric
# middle of two readings of the plain route: the witness, the larger of
# the route against itself run again and with every attention output
# moved WITNESS_ULPS ulp in a seeded random direction; and a planted fault,
# every output moved FAULT_REL of its magnitude (ten times the kernel's
# own forward tolerance, 1e-4 f32 and FLASH_TOL bf16).  The fault must
# read at least SEPARATION times the witness, so the limit lies at least
# sqrt(SEPARATION) from each.  That gate holds in f32 only.  In bf16 at
# this init rounding decides the gradient: one ulp of the attention
# outputs moves 134 of the 140 parameters' gradients by more than half
# their norm (99.9% of the squared grad norm; the last block's q
# projection's reads 87x its f32 value), the grad norm 0.5x-27x in five
# seeded directions against the planted fault's 0.7x-4x (on the FLAC
# batch 0.01x-1.1x against 0.09x-12x), and the loss 8e-5-4.4e-3 against
# the fault's 7e-4-5.6e-3 (tools/train_step0_witness.py --by-param,
# --batch files, on an H100 80GB HBM3, 700.00 W).  No reading of a bf16
# step there tells a fault from rounding, so the bf16 step is held to
# the plain route on its loss (TRAIN_TOL) with every value finite, and
# the flash kernel it runs is held against its plain version, forward
# and backward, at the train shapes in bf16 (``check_flash_autograd``);
# its witness is still read and printed.  Over ``train_path``'s 10
# steps the bf16 loss reaches a plateau (from step 8 it wanders +-15%
# over 20 steps), so it is held to lie below step 0's at the end (4,538 ->
# ~2,200), f32 also below the first of them
TRAIN_TOL = {"f32": 1e-4, "bf16": 7e-2}
WITNESS_ULPS, SEPARATION = 1, 4.0
FAULT_REL = {"f32": 1e-3, "bf16": 5e-2}
GRAD_GATED = ("f32",)
# flash under autograd: the kernel's forward against the plain route's
# (f32 1e-4 of max|plain|; bf16 FLASH_TOL against the f32 plain version,
# as the forward check above), and dq / dk / dv, which both routes take
# from the same plain backward on the same inputs and cotangent
FLASH_GRAD_TOL = {"f32": 1e-6, "bf16": 1e-3}


def check_flash_autograd():
    """``flash_attention`` where autograd needs its gradient (the train
    step's encoder-length calls): the kernel forward inside
    ``FlashTrain`` (one launch a call), the plain masked softmax's
    backward.  At (8, 4, 1001, 128) with ragged ``kv_valid``, causal and
    not, f32 and bf16: the forward against the plain route, dq / dk / dv
    against the plain route's autograd, and the times of forward +
    backward on each route and of SDPA (with a boolean mask) beside
    them."""
    import torch
    import torch.nn.functional as F
    from asr_model_tpu_torch.ops.cuda import attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    b, h, t, hd = BATCH, 4, 1001, 128
    lens = torch.tensor([1001, 990, 950, 900, 800, 700, 600, 1],
                        device=dev)
    valid = torch.arange(t, device=dev)[None] < lens[:, None]
    entries = []
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (False, True):
            q, k, v = (torch.randn(b, h, t, hd, device=dev, generator=g)
                       .to(dt) for _ in range(3))
            w = torch.randn(b, h, t, hd, device=dev, generator=g)

            def route(fn):
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = fn(*leaves, causal=causal, kv_valid=valid)
                (out.float() * w).sum().backward()
                return out.detach(), [x.grad for x in leaves]

            attention.flash_attention.launches = 0
            attention.attention_plain.calls = 0
            got, g_k = route(attention.flash_attention)
            torch.cuda.synchronize()
            launched = attention.flash_attention.launches
            plain_calls = attention.attention_plain.calls
            want, g_p = route(attention.attention_plain)
            want32 = attention.attention_plain(
                q.float(), k.float(), v.float(), causal, valid)
            label = (f"(8,4,1001,128) {dt_name}"
                     f"{' causal' if causal else ''} + kv_valid")
            if dt == torch.float32:
                e = float((got - want32).abs().max())
                ok = e <= 1e-4 * float(want32.abs().max())
                tol = "1e-4 max|plain|"
            else:
                e, bad, _rows = close_rows(got, want32, 0.0, FLASH_TOL, hd)
                ok = bad == 0
                tol = f"{FLASH_TOL:g} max|plain| a row, the bf16 check's"
            check(ok and launched == 1 and plain_calls == 0,
                  f"flash_attention under autograd {label}: forward max "
                  f"abs err {e:.3e} against the f32 plain version "
                  f"(tolerance {tol}), {launched} launch(es) counted, "
                  f"{plain_calls} plain call(s)")
            for name, a, bb in zip("qkv", g_k, g_p):
                ge = float((a.float() - bb.float()).abs().max())
                gs = float(bb.float().abs().max())
                check(ge <= FLASH_GRAD_TOL[dt_name] * gs,
                      f"flash_attention under autograd {label}: d{name} "
                      f"max abs err {ge:.3e} = {ge / gs:.2e} max|plain "
                      f"d{name}| against the plain route's autograd "
                      f"(tolerance {FLASH_GRAD_TOL[dt_name]:g}: the same "
                      "plain backward on the same inputs)")
            mask = valid[:, None, None, :]
            if causal:
                mask = mask & torch.ones(t, t, dtype=torch.bool,
                                         device=dev).tril()[None, None]

            def sdpa_route(q_, k_, v_, causal, kv_valid):
                return F.scaled_dot_product_attention(q_, k_, v_,
                                                      attn_mask=mask)

            pairs = _pairs(t, t, causal, valid)
            # forward 4 h pairs hd, backward 8 h pairs hd (dV, dP, dQ,
            # dK products); q, k, v, the cotangent read, out and the
            # three gradients written
            flops = 12.0 * h * pairs * hd
            peak = F32_PEAK if dt == torch.float32 else BF16_PEAK
            b_ms, b_by = bound_ms(flops, 8 * nbytes(q), peak)
            ms = cuda_ms(lambda: route(attention.flash_attention), iters=5)
            entries.append(dict(
                shape=f"train forward + backward {label}",
                max_abs_err=e, ms=ms,
                plain_ms=cuda_ms(lambda: route(attention.attention_plain),
                                 iters=5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=cuda_ms(lambda: route(sdpa_route), iters=5),
                **rates(flops, ms, b_ms)))
    return entries


class SeededLabels:
    """A tokenizer stand-in for the train batch: ``TRAIN_TOKENS - 1``
    label ids an utterance from a seed (the collator adds BOS / EOS)."""

    def __init__(self, seed: int = 0):
        self.rs = np.random.RandomState(seed)

    def encode(self, text):
        return self.rs.randint(3, 40000, TRAIN_TOKENS - 1).tolist()


def train_batch(audio):
    """The 8 x 10 s tones through the training data pipeline on the card
    (``data/features.py``: the mel kernel one utterance a call, the
    native host DIO, the frame-rate waveform), collated."""
    from asr_model_tpu_torch.data.collator import collate
    from asr_model_tpu_torch.data.features import extract_features
    labels = SeededLabels()
    feats = [extract_features(
        {"audio": {"array": a, "sampling_rate": SR}, "transcription": ""},
        tokenizer=labels, spectrogram=True, pitch=True, waveform=True,
        mels=TRAIN_MELS, hop_length=HOP, sample_rate=SR,
        pitch_estimator="dio", device=DEV)
        for a in audio.cpu().numpy()]
    return collate(feats)


def perturb_attention(rel: float, seed: int = 7):
    """Move every output of ``ops/cuda/attention.flash_attention`` (as it
    stands: under ``plain_route``, the plain version) by ``rel`` of its
    magnitude, up or down by a draw from ``seed``; returns the undo."""
    import torch
    from asr_model_tpu_torch.ops.cuda import attention
    inner = attention.flash_attention
    g = torch.Generator(device=DEV).manual_seed(seed)

    def moved(q, k, v, causal=False, kv_valid=None, scale=None):
        out = inner(q, k, v, causal=causal, kv_valid=kv_valid, scale=scale)
        r = torch.randint(0, 2, out.shape, generator=g, device=out.device)
        return out * (1 + rel * (2 * r - 1)).to(out.dtype)

    attention.flash_attention = moved
    return lambda: setattr(attention, "flash_attention", inner)


def _train_fresh(dt_name: str, extra=None):
    """(model, step) of the flagship from seed 0 with its optimizer
    (``extra``: the ModelConfig fields of a variant)."""
    import torch
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.train.loop import make_optimizer, make_train_step
    m = Model(Dimensions(), ModelConfig(**(extra or {})), device=DEV, seed=0)
    opt, _ = make_optimizer(Config(), m)
    return m, make_train_step(m, opt, 0.0,
                              torch.bfloat16 if dt_name == "bf16" else None)


def train_step0(batch_np, dt_name: str, label: str, extra=None,
                witness: bool = True) -> dict:
    """Step 0 of the train step on the flagship (dropout and gumbel draws
    from a seeded generator): its loss and grad norm on the kernel route
    against the plain route from the same weights and generator seed
    (the grad norm's limit from the witness of ``TRAIN_TOL``'s note; in
    bf16, where rounding decides the gradient at this init, the loss and
    finite values only).  ``main`` runs it first, in the fresh process."""
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.train.loop import device_batch
    compute = torch.bfloat16 if dt_name == "bf16" else None
    batch = device_batch(batch_np, DEV)

    def gen():
        return torch.Generator(device=DEV).manual_seed(0)

    def plain_step(rel=0.0):
        """Step 0 on the plain route, every attention output moved by
        ``rel`` of its magnitude in a seeded random direction."""
        undo = plain_route()
        restore = perturb_attention(rel) if rel else (lambda: None)
        try:
            _m, st = _train_fresh(dt_name, extra)
            loss, gn, js = st(batch, gen())
            torch.cuda.synchronize()
            return float(loss), float(gn), js.tolist()
        finally:
            restore()
            undo()

    model, step = _train_fresh(dt_name, extra)
    lk, gk, jk = step(batch, gen())
    torch.cuda.synchronize()
    counts = kernels.counts()
    del model, step
    lp, gp, jp = plain_step()
    ulp = WITNESS_ULPS * float(torch.finfo(compute or torch.float32).eps)
    gated = dt_name in GRAD_GATED
    rel_l = abs(float(lk) - lp) / abs(lp)
    rel_g = abs(float(gk) - gp) / abs(gp)
    tol = TRAIN_TOL[dt_name]
    why = ("f32 sums in other orders" if dt_name == "f32" else
           "bf16 rounds at other places on the two routes")
    rel_g_of, limit = None, None
    if witness or gated:
        reads = {"plain_again": plain_step(), "plain_1ulp": plain_step(ulp),
                 "planted_fault": plain_step(FAULT_REL[dt_name])}
        rel_g_of = {k: abs(r[1] - gp) / abs(gp) for k, r in reads.items()}
        wit = max(rel_g_of["plain_again"], rel_g_of["plain_1ulp"])
        limit = float(np.sqrt(wit * rel_g_of["planted_fault"]))
        log(f"{label} step 0 grad norm witness (relative to the plain "
            f"route's {gp:.4f}): plain route again "
            f"{rel_g_of['plain_again']:.2e}, attention outputs moved "
            f"{WITNESS_ULPS} ulp {rel_g_of['plain_1ulp']:.2e}, planted "
            f"fault ({FAULT_REL[dt_name]:g} of each output) "
            f"{rel_g_of['planted_fault']:.2e}; limit {limit:.2e}")
    else:
        log(f"{label} step 0 grad norm witness: not read (the grad norm "
            "is not gated in this dtype)")
    if gated:
        check(rel_g_of["planted_fault"] >= SEPARATION * wit,
              f"{label} step 0: the planted fault reads "
              f"{rel_g_of['planted_fault']:.2e}, at least {SEPARATION:g} x "
              f"the witness {wit:.2e}, so the grad norm's limit "
              f"{limit:.2e} (their geometric middle) separates them")
    finite = bool(np.isfinite([float(lk), float(gk), lp, gp]).all())
    check(finite and rel_l <= tol and (not gated or rel_g <= limit),
          f"{label} step 0, kernel route against plain route: loss "
          f"{float(lk):.6f} / {lp:.6f} (rel {rel_l:.2e}, tolerance "
          f"{tol:g}: {why}), grad norm {float(gk):.4f} / {gp:.4f} (rel "
          f"{rel_g:.2e}, " + (f"limit {limit:.2e} from the witness" if gated
                              else "not gated: rounding decides it, "
                              "TRAIN_TOL's note") +
          f"), jstat {jk.tolist()} / {jp}")
    torch.cuda.empty_cache()
    return dict(counts=counts, loss0=float(lk), loss0_plain=lp,
                gnorm0=float(gk), gnorm0_plain=gp, rel_loss0=rel_l,
                rel_gnorm0=rel_g, gnorm0_witness=rel_g_of,
                gnorm0_limit=limit)


def train_path(batch_np, dt_name: str, label: str, step0: dict,
               extra=None, steps: int = 3, timed: int = 2,
               profiler=None):
    """The train step on the flagship (dropout and gumbel draws from a
    seeded generator) after ``train_step0``'s gate (``step0``): step 0,
    then ``timed`` timed steps (median ms, utterances and audio seconds
    per wall second, peak memory), one step under ``profiler`` (default
    ``profile_launches``; launches, device ms, and the hand kernels'
    counts), and ``steps`` more steps on the same
    batch (every loss and grad norm finite, the last loss below step 0's
    and, in f32, below the first of them: ``TRAIN_TOL``'s note).  An MoE
    variant's line adds its load-balance term (``moe_aux_weight`` times
    the summed aux of the last timed step's forward)."""
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.train.loop import device_batch
    profiler = profiler or profile_launches
    batch = device_batch(batch_np, DEV)
    model, step = _train_fresh(dt_name, extra)
    g = torch.Generator(device=DEV).manual_seed(0)
    loss_step0 = float(step(batch, g)[0])           # and the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, seen = [], []
    if model.cfg.moe_experts:
        # an MoE variant's aux, read from the timed steps' own forwards
        forward = model.forward
        model.forward = lambda *a, **k: seen.append(forward(*a, **k)) \
            or seen[-1]
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _gn, _js = step(batch, g)
        float(loss)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    aux = None
    if seen:
        del model.forward
        aux = float(model.cfg.moe_aux_weight * seen[-1]["moe_aux"])
        seen.clear()
    kernels.reset_counts()
    launches, dev_ms = profiler(lambda: step(batch, g))
    calls = 2 if profiler is profile_launches else 1   # see each
    per_step = {n: c["launches"] // calls for n, c in
                kernels.counts().items() if c["launches"]}
    losses, gnorms = [], []
    for _ in range(steps):
        loss, gn, _js = step(batch, g)
        losses.append(float(loss))
        gnorms.append(float(gn))
    falls = losses[-1] < loss_step0 and (dt_name not in GRAD_GATED
                                         or losses[-1] < losses[0])
    check(all(np.isfinite(losses + gnorms)) and falls,
          f"{label}: {steps} steps on one batch, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (" + ", ".join(f"{v:.2f}" for v in losses)
          + f"), below step 0's {loss_step0:.4f}"
          + ("" if dt_name in GRAD_GATED else " (held to step 0's alone: "
             "TRAIN_TOL's note)") + ", every loss and grad norm finite")
    ms = float(np.median(times))
    b = batch_np["text_ids"].shape[0]
    secs = b * batch_np["waveform"].shape[-1] * HOP / SR
    log(f"{label}: step {ms:.2f} ms (median of {timed}; {times}), "
        f"{1e3 * b / ms:.2f} utterances/s, {1e3 * secs / ms:.2f} audio s "
        f"per wall s; one step {launches} launches, {dev_ms:.2f} ms of "
        f"device time ({100 * dev_ms / ms:.1f}% of the step); peak "
        f"memory {peak / 2**30:.2f} GiB; hand kernels a step {per_step}"
        + ("" if aux is None else f"; MoE aux term in the loss {aux:.6f}"))
    del model, step
    torch.cuda.empty_cache()
    return dict(step0, step_ms=ms, step_ms_runs=times, moe_aux_term=aux,
                utt_per_s=1e3 * b / ms, audio_s_per_s=1e3 * secs / ms,
                launches_per_step=launches, device_ms_per_step=dev_ms,
                peak_gib=peak / 2**30, kernel_launches_per_step=per_step,
                loss_step0=loss_step0, loss_first=losses[0],
                loss_last=losses[-1])


def cli_path():
    """``python -m asr_model_tpu_torch.cli`` (in this process, so its
    kernel counts are read): 16 synthetic utterances, 4 steps of 8 at
    the flagship defaults, bf16 compute, DIO pitch on the host, eval and
    a checkpoint at the end; the mel kernel must have run once an
    utterance featurised; the checkpoint must read back into a model
    equal to the trained one, and a resumed run continue at its step."""
    import tempfile
    import torch
    from asr_model_tpu_torch import cli
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.data.features import extract_features
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.train import checkpoint as ckpt
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--synthetic", "16", "--max-steps", "4", "--batch-size", "8",
                "--eval-interval", "4", "--save-interval", "4",
                "--train-dtype", "bfloat16", "--pitch-estimator", "dio",
                "--log-dir", tmp]
        torch.cuda.synchronize()
        kernels.reset_counts()
        extract_features.calls = 0
        t0 = time.perf_counter()
        out = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.counts()
        featurised = extract_features.calls
        mel_n = counts["mel_spectrogram"]["launches"]
        check(mel_n == featurised > 0,
              f"training CLI: {mel_n} mel launches for {featurised} "
              "utterances featurised (one a call)")
        check("eval_wer" in out and np.isfinite(out["loss"]),
              f"training CLI: 4 steps in {wall:.1f} s, last loss "
              f"{out['loss']:.4f}, eval WER {out.get('eval_wer', 'none')}")
        final = os.path.join(tmp, "final_model.msgpack")
        back = Model(Dimensions(), ModelConfig(), device=DEV, seed=1)
        _state, step = ckpt.restore_model(back, final)
        same = all(torch.equal(a, b_) for a, b_ in zip(
            out["model"].state_dict().values(), back.state_dict().values()))
        check(step == 4 and same, f"training CLI checkpoint: step {step}, "
              "read back by the port's restore equal to the trained model")
        del out, back
        res = cli.main(args[:3] + ["6"] + args[4:] + ["--resume", final])
        check(res["start_step"] == 4 and res["step"] == 6,
              f"training CLI resumed from {os.path.basename(final)}: steps "
              f"{res['start_step']}..{res['step'] - 1}")
        del res
    torch.cuda.empty_cache()
    return dict(counts=counts, wall_s=wall, featurised=featurised)


# training on audio files: GrammarDataset sentences rendered to 16-bit
# PCM, written as FLAC (tools/flac_encoder.py) into a LibriSpeech-layout
# tree and as WAV with a metadata.csv
FILES_TRAIN, FILES_EVAL = 12, 4
# remat against the step without it, step 0 from the same weights and
# generator seed (tests/test_train.py's bounds; remat changes no
# arithmetic, so anything above a rounding of the reduction order is a
# fault)
REMAT_LOSS_TOL, REMAT_GNORM_TOL = 1e-6, 5e-4
REMAT_VARIANTS = (("off", False, "dots"), ("dots", True, "dots"),
                  ("full", True, "full"))
GOLDEN = os.path.join(ROOT, "tests", "golden", "reference_parity.npz")


def letters_tokenizer(path: str) -> str:
    """A byte-level BPE ``tokenizer.json`` of 30 ids (PAD, BOS, EOS, the
    prefix space, a-z): the grammar's sentences fit the golden's 256
    tokens."""
    vocab = {"<PAD>": 0, "<BOS>": 1, "<EOS>": 2}
    for c in "Ġabcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"added_tokens": [{"content": k, "id": v}
                                    for k, v in list(vocab.items())[:3]],
                   "normalizer": {"type": "NFKC"},
                   "pre_tokenizer": {"add_prefix_space": True},
                   "model": {"vocab": vocab, "merges": []}}, f)
    return path


def write_file_fixtures(tmp: str) -> dict:
    """GrammarDataset.make_split(12, 4) rendered and rounded to int16:
    FLAC under ``LibriSpeech/dev-clean/19/198`` (train) and ``19/227``
    (eval) with their ``.trans.txt``, and WAV under ``wav/`` with a
    ``metadata.csv``; then every FLAC decoded by the port's native
    decoder, bit-exact against its PCM."""
    import importlib.util
    import wave
    from asr_model_tpu_torch.data.dataset import GrammarDataset
    from asr_model_tpu_torch.native import read_flac
    spec = importlib.util.spec_from_file_location(
        "flac_encoder", os.path.join(ROOT, "tools", "flac_encoder.py"))
    enc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(enc)
    train, evals = GrammarDataset.make_split(FILES_TRAIN, FILES_EVAL)
    grammar = GrammarDataset([])
    split = os.path.join(tmp, "LibriSpeech", "dev-clean")
    wav_dir = os.path.join(tmp, "wav")
    os.makedirs(wav_dir)
    rows, flacs, seconds = ["audio,sentence"], [], 0.0
    t0 = time.perf_counter()
    for chap, texts, first in ((198, train, 0), (227, evals, len(train))):
        d = os.path.join(split, "19", str(chap))
        os.makedirs(d)
        lines = []
        for k, text in enumerate(texts):
            i = first + k
            pcm = np.round(grammar.render(text, seed=i) * 32767).astype(
                np.int16)
            seconds += len(pcm) / SR
            uid = f"19-{chap}-{k:04d}"
            enc.write_flac(os.path.join(d, uid + ".flac"), pcm, SR)
            flacs.append((os.path.join(d, uid + ".flac"), pcm))
            lines.append(f"{uid} {text}")
            with wave.open(os.path.join(wav_dir, f"u{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes(pcm.astype("<i2").tobytes())
            rows.append(f"u{i}.wav,{text}")
        with open(os.path.join(d, f"19-{chap}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    meta = os.path.join(tmp, "metadata.csv")
    with open(meta, "w") as f:
        f.write("\n".join(rows) + "\n")
    made = time.perf_counter() - t0
    bad = 0
    for path, pcm in flacs:
        data, sr = read_flac(path)
        bad += int(sr != SR or not np.array_equal(
            np.round(data * 32768).astype(np.int64), pcm.astype(np.int64)))
    check(bad == 0, f"FLAC decode (native/flac.cpp, built here by g++): "
          f"{len(flacs)} files, {seconds:.2f} s of audio, bit-exact "
          f"against their PCM ({bad} differ); fixtures written in "
          f"{made:.1f} s")
    return dict(split=split, meta=meta, wav_dir=wav_dir, seconds=seconds,
                train=train, evals=evals)


def file_batch(fx):
    """The first 8 training utterances of the tree through
    ``LibriSpeechDataset`` (FLAC, the flagship's features on the card:
    the mel kernel one utterance a call, the native host DIO), collated
    as the CLI pads them."""
    from asr_model_tpu_torch.data.dataset import data_loader
    from asr_model_tpu_torch.data.librispeech import LibriSpeechDataset
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    ds = LibriSpeechDataset(fx["split"], tokenizer=setup_tokenizer(TOKENIZER),
                            extract_args=dict(
                                spectrogram=True, pitch=True, waveform=True,
                                mels=TRAIN_MELS, hop_length=HOP,
                                sample_rate=SR, pitch_estimator="dio"),
                            limit=BATCH, device=DEV)
    return next(iter(data_loader(ds, batch_size=BATCH, pad_to_multiple=128,
                                 text_pad_to_multiple=16)))


def remat_variants(batch_np, dt_name: str, label: str, runs: int = 1,
                   base=None, profile: bool = True,
                   names=("dots", "full")):
    """The flagship train step without remat and with each remat policy
    on one batch, each from the same weights and generator seed: step
    0's loss and grad norm against the step without remat
    (``REMAT_*_TOL``; ``base``, a ``train_path`` result on this batch,
    stands in for the step without remat, which is then not run
    again), the hand kernels a step, then ``runs`` timed steps (median
    ms) with the peak memory over them and above their start, and (with
    ``profile``) one step under the profiler (launches, device ms;
    ``profile_device``); ``names`` are the policies run."""
    import torch
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                                make_train_step)
    compute = torch.bfloat16 if dt_name == "bf16" else None
    batch = device_batch(batch_np, DEV)
    out = {}
    if base is not None:
        out["off"] = dict(loss0=base["loss0"], gnorm0=base["gnorm0"],
                          step_ms=base["step_ms"], peak_gib=base["peak_gib"],
                          from_train_path=True)
    for name, remat, policy in REMAT_VARIANTS:
        if name in out or (remat and name not in names):
            continue
        t_variant = time.perf_counter()
        model = Model(Dimensions(), ModelConfig(), device=DEV, seed=0)
        opt, _ = make_optimizer(Config(), model)
        step = make_train_step(model, opt, 0.0, compute, remat=remat,
                               remat_policy=policy)
        g = torch.Generator(device=DEV).manual_seed(0)
        torch.cuda.synchronize()
        kernels.reset_counts()
        loss, gn, _js = step(batch, g)
        loss0, gn0 = float(loss), float(gn)
        c = kernels.counts()
        per_step = {n: v["launches"] for n, v in c.items() if v["launches"]}
        plain = sum(v["plain_calls"] for v in c.values())
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _gn, _js = step(batch, g)
            float(loss)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        launches, dev_ms = (profile_device(lambda: step(batch, g))
                            if profile else (None, None))
        r = dict(counts=c, loss0=loss0, gnorm0=gn0,
                 step_ms=float(np.median(times)),
                 step_ms_runs=times, peak_gib=peak / 2**30,
                 above_start_gib=(peak - start) / 2**30,
                 launches_per_step=launches, device_ms_per_step=dev_ms,
                 kernel_launches_per_step=per_step, plain_calls=plain)
        out[name] = r
        check(plain == 0 and per_step.get("flash_attention", 0) > 0
              and np.isfinite(loss0) and np.isfinite(gn0)
              and (not profile or launches > 0),
              f"{label} remat {name}: step 0 finite, flash launched "
              f"{per_step.get('flash_attention', 0)} times, {plain} plain "
              f"calls; {launches} launches profiled")
        if remat:
            base = out["off"]
            rl = abs(loss0 - base["loss0"]) / abs(base["loss0"])
            rg = abs(gn0 - base["gnorm0"]) / abs(base["gnorm0"])
            r.update(rel_loss0=rl, rel_gnorm0=rg)
            check(rl <= REMAT_LOSS_TOL and rg <= REMAT_GNORM_TOL,
                  f"{label} remat {name} step 0 against no remat: loss "
                  f"{loss0:.6f} / {base['loss0']:.6f} (rel {rl:.2e}, "
                  f"tolerance {REMAT_LOSS_TOL:g}), grad norm {gn0:.4f} / "
                  f"{base['gnorm0']:.4f} (rel {rg:.2e}, tolerance "
                  f"{REMAT_GNORM_TOL:g}): remat changes no arithmetic")
        prof = (f"; one step {launches} launches, {dev_ms:.2f} ms of "
                "device time" if profile else "")
        log(f"{label} remat {name}: step {r['step_ms']:.2f} ms (median of "
            f"{runs}; {[round(t, 2) for t in times]}), peak memory "
            f"{r['peak_gib']:.3f} GiB ({r['above_start_gib']:.3f} GiB above "
            f"the step's start){prof}; hand kernels a step {per_step}")
        del model, opt, step
        torch.cuda.empty_cache()
        r["wall_s"] = time.perf_counter() - t_variant
    lower = {k: out[k]["peak_gib"] < out["off"]["peak_gib"]
             for k in names}
    log(f"{label}: remat lowers the peak: {json.dumps(lower)} "
        f"({ {k: round(v['peak_gib'], 3) for k, v in out.items()} } GiB; "
        f"card {card_line()})")
    return out


def profile_device(fn):
    """(kernel launches, their device ms) of one call of ``fn`` under
    torch.profiler with the CUDA activity alone (``profile_launches``
    without the host-side trace, which costs seconds at 60,000 launches
    a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms = 0, 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and not _annotation(evt):
            n += evt.count
            ms += us / 1e3
    return n, ms


class Recorder:
    """A TensorBoard writer stand-in that keeps the last value of each
    scalar."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, name, value, step):
        self.scalars[name] = float(value)

    def close(self):
        pass


def grad_detail(batch_np) -> int:
    """One ``log_detail`` call at the flagship on the file batch: the
    eval loss's gradients through the differentiable routes
    (``make_grad_diagnostics``; no eval-only kernel), every scalar
    finite."""
    import torch
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.train.loop import (device_batch,
                                                log_grad_detail,
                                                make_grad_diagnostics)
    model = Model(Dimensions(), ModelConfig(), device=DEV, seed=0)
    rec = Recorder()
    log_grad_detail(rec, make_grad_diagnostics(model)(
        device_batch(batch_np, DEV)), 0)
    n_params = sum(1 for _ in model.parameters())
    norms = [k for k in rec.scalars if k.startswith("train/per_layer_norms_")]
    ent = [k for k in rec.scalars if k.startswith("Entropy/")]
    check(len(norms) == n_params and ent
          and all(np.isfinite(v) for v in rec.scalars.values()),
          f"grad diagnostics (log_detail) at the flagship: {len(norms)} "
          f"grad norms for {n_params} parameters, {len(ent)} spectral "
          "entropies, every scalar finite")
    del model
    torch.cuda.empty_cache()
    return len(rec.scalars)


def files_cli(fx, tmp: str) -> dict:
    """The training CLI on the WAV files (``--metadata/--data-dir``): 4
    steps of 8 at the flagship with ``--remat``, eval through the native
    WER engine; then ``--import-reference`` of a ``.pt`` written from
    the golden reference (tests/golden/reference_parity.npz) at its
    dims, the imported model's logits against the golden's first."""
    import torch
    from asr_model_tpu_torch import cli, native
    from asr_model_tpu_torch.compat import import_reference_checkpoint
    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.data.features import extract_features
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    wer_calls = []
    wer = native.wer_levenshtein
    native.wer_levenshtein = lambda r, h: wer_calls.append(1) or wer(r, h)
    try:
        args = ["--metadata", fx["meta"], "--data-dir", fx["wav_dir"],
                "--max-steps", "4", "--batch-size", "8", "--eval-interval",
                "4", "--remat", "--pitch-estimator", "dio",
                "--log-dir", os.path.join(tmp, "cli")]
        torch.cuda.synchronize()
        kernels.reset_counts()
        extract_features.calls = 0
        t0 = time.perf_counter()
        out = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.counts()
        mel_n = counts["mel_spectrogram"]["launches"]
        check(mel_n == extract_features.calls == FILES_TRAIN + FILES_EVAL,
              f"training CLI on files: {mel_n} mel launches for "
              f"{extract_features.calls} utterances featurised (the "
              "metadata's 16, cached)")
        check(np.isfinite(out["loss"]) and "eval_wer" in out
              and len(wer_calls) > 0,
              f"training CLI on files with --remat: 4 steps in {wall:.1f} s, "
              f"last loss {out['loss']:.4f}, eval WER {out.get('eval_wer')} "
              f"through the native engine ({len(wer_calls)} calls)")
        del out
        torch.cuda.empty_cache()

        z = np.load(GOLDEN)
        pt = os.path.join(tmp, "reference.pt")
        torch.save({k[3:]: torch.tensor(z[k]) for k in z.files
                    if k.startswith("sd:")}, pt)
        dims = Dimensions(tokens=int(z["cfg_tokens"]), mels=int(z["cfg_mels"]),
                          dims=int(z["cfg_dims"]), head=int(z["cfg_head"]),
                          layer=int(z["cfg_layer"]))
        m = Model(dims, device=DEV, seed=1)
        import_reference_checkpoint(pt, m)
        t = lambda k: torch.from_numpy(z[k]).to(DEV)
        logits = m(t("in_text_ids").long(), spectrogram=t("in_spectrogram"),
                   pitch=t("in_pitch"), waveform=t("in_waveform"))["logits"]
        ref = z["out_logits"]
        rel = float(np.abs(logits.cpu().numpy() - ref).max()) / max(
            1.0, float(np.abs(ref).max()))
        check(rel < 2e-4, f"reference import on the card: logits "
              f"{rel:.2e} of max|golden| from the golden's (tolerance 2e-4, "
              "tests/test_reference_parity.py's; f32 kernels)")
        del m
        res = cli.main(["--metadata", fx["meta"], "--data-dir", fx["wav_dir"],
                        "--import-reference", pt, "--tokenizer",
                        letters_tokenizer(os.path.join(tmp, "tok.json")),
                        "--tokens", str(dims.tokens), "--mels",
                        str(dims.mels), "--dims", str(dims.dims), "--head",
                        str(dims.head), "--layer", str(dims.layer),
                        "--max-steps", "2", "--batch-size", "8",
                        "--log-dir", os.path.join(tmp, "cli_ref")])
        check(res["step"] == 2 and np.isfinite(res["loss"]),
              f"training CLI --import-reference at the golden's dims: 2 "
              f"steps, last loss {res['loss']:.4f}, eval WER "
              f"{res.get('eval_wer')}")
        del res
    finally:
        native.wer_levenshtein = wer
    torch.cuda.empty_cache()
    return dict(counts=counts, wall_s=wall, wer_calls=len(wer_calls),
                golden_rel=rel)


def files_path(tones_batch, tones_f32):
    """Training on audio files: the fixtures, the flagship train step on
    a FLAC-backed batch (f32 and bf16, remat off / "dots" / "full"),
    remat at the 10 s tones (f32, against ``tones_f32``, the f32
    ``train_path`` on them), the gradient diagnostics and the CLI on
    files and with an imported reference."""
    import tempfile
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    with tempfile.TemporaryDirectory() as tmp:
        fx = write_file_fixtures(tmp)
        torch.cuda.synchronize()
        kernels.reset_counts()
        batch_np = file_batch(fx)
        counts = kernels.counts()
        frames = int(batch_np["spectrogram"].shape[-1])
        log(f"file batch: {BATCH} FLAC utterances of the LibriSpeech tree, "
            f"padded to {frames} frames, {int(batch_np['labels'].shape[1])} "
            "label positions")
        t0 = time.perf_counter()
        out = dict(counts=counts, frames=frames,
                   audio_s=fx["seconds"],
                   remat={"f32": remat_variants(batch_np, "f32",
                                                "file batch f32"),
                          "bf16": remat_variants(batch_np, "bf16",
                                                 "file batch bf16",
                                                 profile=False)})
        log(f"training on files: remat at the file batch "
            f"{time.perf_counter() - t0:.1f} s")
        # the path's counts: the batch's features and step 0 without
        # remat (f32); the kernel launches of one remat step ("dots",
        # f32) for the kernels line; the others only in the remat lines
        for name, c in out["remat"]["f32"]["off"]["counts"].items():
            counts[name]["launches"] += c["launches"]
            counts[name]["plain_calls"] += c["plain_calls"]
        out["remat_step_counts"] = out["remat"]["f32"]["dots"]["counts"]
        for by_dt in out["remat"].values():
            for r in by_dt.values():
                r.pop("counts", None)
        t0 = time.perf_counter()
        out["remat"]["tones_f32"] = remat_variants(
            tones_batch, "f32", "10 s tones f32", runs=1, base=tones_f32,
            profile=False, names=("full",))
        for r in out["remat"]["tones_f32"].values():
            r.pop("counts", None)
        t1 = time.perf_counter()
        out["diag_scalars"] = grad_detail(batch_np)
        t2 = time.perf_counter()
        out["cli"] = files_cli(fx, tmp)
        log(f"training on files: remat at the tones {t1 - t0:.1f} s, grad "
            f"diagnostics {t2 - t1:.1f} s, the CLI runs "
            f"{time.perf_counter() - t2:.1f} s")
    return out


# ------------------------------------------------------ the model variants

# the ModelConfig variant the port serves and trains at the flagship's
# width: a chained model whose blocks' MLPs are 8 routed experts (top 2,
# capacity factor 1.25), with the encoder's norm and transformer layer
CHAINED_MOE = dict(chained_blocks=True, moe_experts=8, moe_top_k=2,
                   moe_capacity_factor=1.25, encoder_norm=True,
                   encoder_transformer=True)
# its train batch: the tones cut to 2.55 s (256 frames, the file
# batch's shape; four chained blocks at the 10 s tones would hold about
# four times the one block's 18 GiB of f32 activations), the timed
# steps and the f32 steps after them
VARIANT_SEC, VARIANT_TIMED, VARIANT_STEPS = 2.55, 1, 2
# the fused kernels the fused variant launches; the MoE MLP never takes
# the fused MLP (the JAX gate refuses an MoE block)
CHAINED_MOE_FUSED = ("fused_attn_cached", "fused_attn_full",
                     "fused_router_same")


def variant(extra, dtype=None, fused: bool = False):
    """The flagship with the ModelConfig fields ``extra`` from seed 0,
    bf16 unless ``dtype`` says otherwise."""
    import torch
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model, cast_variables
    cfg = ModelConfig(**extra, **(FUSED_FIELDS if fused else {}))
    m = Model(Dimensions(), cfg, device=DEV, seed=0)
    return m if dtype == torch.float32 else cast_variables(m)


def variant_serve(model, audio, label: str, expect) -> dict:
    """``Transcriber`` on a variant (bf16, DIO pitch on the card, 64 new
    tokens): the counted ``transcribe_batch`` must launch exactly
    ``expect`` and no plain version, its transcripts be the decode of
    its ids; RTFx (one timed run), decode ms a step (the 64-step decode
    with EOS suppressed less its prepare, over 64) and one step's
    launches and device ms at width 65."""
    import torch
    from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
    from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                     prepare_cross)
    from asr_model_tpu_torch.models.model import modality_slots
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.transcribe import Transcriber
    tok = setup_tokenizer(TOKENIZER)
    t = Transcriber(model, tok, bf16=True, max_new_tokens=NEW_TOKENS,
                    device=DEV)
    wavs = list(audio.cpu().numpy())
    decoded = []
    decode = t._decode
    t._decode = lambda *a, **k: decoded.append(decode(*a, **k)) or \
        decoded[-1]
    torch.cuda.synchronize()
    kernels.reset_counts()
    try:
        texts = t.transcribe_batch(wavs)
        torch.cuda.synchronize()
    finally:
        t._decode = decode
    counts = kernels.counts()
    log(f"{label} serve kernels " + json.dumps(counts))
    _check_counts(f"{label} serve", counts, expect)
    feats = t.features(audio)
    ids = decoded[0]
    check(tuple(ids.shape) == (BATCH, 1 + NEW_TOKENS)
          and texts == tok.batch_decode(ids.tolist()),
          f"{label} serve: {BATCH} transcripts, each the tokenizer's "
          f"decode of its ids; first: {texts[0][:60]!r}")
    batch_ms = [host_ms(lambda: t.transcribe_batch(wavs), runs=1)]
    rtfx = BATCH * UTT_SEC / (float(np.median(batch_ms)) / 1e3)
    slots = modality_slots(feats["pitch"], feats["spectrogram"],
                           feats["waveform"])
    prep = host_ms(lambda: prepare_cross(model, slots), runs=1)
    dec = host_ms(lambda: greedy_decode(model, **feats, suppress_eos=True,
                                        max_new_tokens=NEW_TOKENS), runs=1)
    step_ms = (dec - prep) / NEW_TOKENS
    n, dev_ms, copies, top, _ = step_profile(model, audio, ids, feats=feats)
    log(f"{label} serve: RTFx {rtfx:.3f} (one timed transcribe_batch "
        "run of " + ", ".join(f"{m:.1f}" for m in batch_ms) + f" ms); "
        f"encode + re-encode + cross K/V {prep:.3f} ms; decode "
        f"{step_ms:.3f} ms per step; one step at width 65: {n} kernel "
        f"launches ({dev_ms:.3f} ms of device time), {copies} copies/"
        "fills; top: " + json.dumps(top[:4]))
    return dict(rtfx=rtfx, ms_per_batch_runs=batch_ms, prepare_ms=prep,
                decode_ms_per_step=step_ms, step_launches=n,
                step_device_ms=dev_ms, step_top=top, counts=counts)


# the chained MoE model's bf16 first-step logits are read, not gated:
# each block's output feeds the next and the MoE picks each token's
# experts by a top-2 of bf16 router logits, so bf16 rounding alone moves
# its logits about as far as a fault would (its kernel and plain bf16
# routes read 1.43e-1 of the largest logit apart, 7e-2 from each other
# with the fused fields, its f32 routes 2.1e-6; one bf16 ulp on every
# attention output of the plain route moved them 1.9e-1, as far as a 5%
# fault, on an H100 80GB HBM3 at 700 W).  Its hold in bf16 is every
# value finite, the f32 route check (6e-5) on the same model and each
# kernel's own bf16 check against its plain version at the flagship's
# shapes (``check_kernels``, ``check_serve_shapes``).


def bf16_route_reading(m16, lp32, audio, label: str) -> dict:
    """``m16``'s first-step logits on its kernel route and its plain route
    (bf16) against ``lp32``, the same weights' plain route in f32:
    printed, and gated on finite values only (the note above)."""
    import torch
    lk = first_step_logits(m16, audio, torch.bfloat16)
    undo = plain_route()
    try:
        lp = first_step_logits(m16, audio, torch.bfloat16)
    finally:
        undo()
    scale = float(lp32.abs().max())
    out = {"kernel_vs_f32": float((lk - lp32).abs().max()) / scale,
           "plain_bf16_vs_f32": float((lp - lp32).abs().max()) / scale,
           "kernel_vs_plain_bf16": float((lk - lp).abs().max())
           / float(lp.abs().max())}
    agree = {k: float((v.argmax(-1) == lp32.argmax(-1)).float().mean())
             for k, v in (("kernel", lk), ("plain bf16", lp))}
    check(bool(torch.isfinite(lk).all()),
          f"{label}: first decode step logits (bfloat16) finite; read, not "
          "gated (bf16 rounding decides them: the note above): kernel "
          f"route {out['kernel_vs_f32']:.3e} of the largest logit from the "
          f"plain route in f32, the plain bf16 route "
          f"{out['plain_bf16_vs_f32']:.3e}, the two bf16 routes "
          f"{out['kernel_vs_plain_bf16']:.3e} apart; argmax agreement "
          f"with f32 {json.dumps(agree)}")
    return out


def variant_routes(audio, extra, label: str, fused: bool = False) -> dict:
    """The first decode step's logits of a variant on the kernel route
    against the plain route, f32 (6e-5) and bf16 (read:
    ``bf16_route_reading``); with ``fused`` once more with the fused
    fields on, whose counted kernel route must launch no
    ``fused_mlp_residual`` (the JAX gate refuses an MoE block) and each
    of ``CHAINED_MOE_FUSED``."""
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    rel = {}
    for f in ((False, True) if fused else (False,)):
        name = label + (" fused" if f else "")
        m32 = variant(extra, torch.float32, fused=f)
        undo = plain_route()
        try:
            lp32 = first_step_logits(m32, audio, torch.float32)
        finally:
            undo()
        for dt in (torch.float32, torch.bfloat16):
            m = m32 if dt == torch.float32 else variant(extra, dt, fused=f)
            torch.cuda.synchronize()
            kernels.reset_counts()
            if dt == torch.float32:
                rel[f"{name} float32"] = route_check(
                    m, audio, dt, 6e-5, "f32 sums in other orders",
                    name)[0]
            else:
                rel[f"{name} bfloat16 (read)"] = bf16_route_reading(
                    m, lp32, audio, name)
            c = kernels.counts()
            if f:
                check(c["fused_mlp_residual"]["launches"] == 0
                      and all(c[k]["launches"] > 0
                              for k in CHAINED_MOE_FUSED),
                      f"{name} ({str(dt)[6:]}): the kernel route launched "
                      + ", ".join(f"{k} {c[k]['launches']}" for k in
                                  CHAINED_MOE_FUSED + ("fused_mlp_residual",))
                      + " (the MLP kernel never: its gate refuses an MoE "
                      "block)")
            del m
        del m32
    torch.cuda.empty_cache()
    return rel


# MSheath's mini-HC (r_node) paths, as a module: no ModelConfig field
# builds them (``msheath_mini_hc`` is inert in the JAX package, whose
# Residual builds MSheath without them, and so in the port).  Its inputs:
# the decode's audio slot at the flagship's width (8 x 1000 x 512)
MINI_HC_SHAPE = (BATCH, int(UTT_SEC * SR / HOP), 512)
# f32 on the card against f32 on the CPU (the same PyTorch ops; sums in
# other orders), bf16 on the card against f32 on the CPU, gradients
# against the CPU's (of the largest gradient)
MINI_HC_TOL = {"f32": 1e-4, "bf16": 7e-2, "grad": 1e-4}


def minihc_module() -> dict:
    """``MSheath(mini_hc=True)`` of the flagship's block (512 wide, 4
    heads, 4 slots, seed 0, the v_gate biased as below) on the card: its eval forward in f32 and
    bf16, which launches no ``fused_sheath_scan`` and calls no plain
    version of it (the JAX gate keeps mini-HC off the scan kernel), and
    its noise-free train forward's gradients in f32, each against the
    same module on the CPU in f32 (``MINI_HC_TOL``), the jump actions
    equal."""
    import torch
    from asr_model_tpu_torch.models import stochastic
    from asr_model_tpu_torch.models.sheath import MSheath
    from asr_model_tpu_torch.models.tlayers import reset_all
    from asr_model_tpu_torch.ops import cuda as kernels
    g = torch.Generator().manual_seed(0)
    cpu = MSheath(512, 4, 4, mini_hc=True, device="cpu")
    reset_all(cpu, g)
    with torch.no_grad():
        # the v_gate's mask off on slot 0 (a forced skip) and on on slots
        # 2 and 3, so that a jump and the r_node paths both run
        cpu.vcat_b.add_(torch.tensor([[-3.0], [0.0], [3.0], [3.0]]))
    x = torch.randn(MINI_HC_SHAPE, generator=g)
    w = torch.randn(MINI_HC_SHAPE, generator=g)

    def run(m, x, w=None):
        if w is None:
            with torch.no_grad():
                y, aux = m(x)
            return y.float().cpu(), aux["actions"].cpu(), None
        m.requires_grad_(True)
        with stochastic.mode(train=True):
            y, aux = m(x)
            grads = torch.autograd.grad((y.float() * w).sum(),
                                        list(m.parameters()),
                                        allow_unused=True)
        m.requires_grad_(False)
        return y.float().cpu(), aux["actions"].cpu(), [
            None if gr is None else gr.float().cpu() for gr in grads]

    y_ref, act_ref, _ = run(cpu, x)
    _, act_tref, g_ref = run(cpu, x, w)
    out = {}
    kernels.reset_counts()
    for dt in ("f32", "bf16"):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        m = MSheath(512, 4, 4, mini_hc=True, device=DEV, dtype=dtype)
        m.load_state_dict(cpu.state_dict())
        y, act, _ = run(m, x.to(DEV, dtype))
        rel = float((y - y_ref).abs().max() / y_ref.abs().max())
        same = bool(torch.equal(act, act_ref))
        check(bool(torch.isfinite(y).all()) and rel <= MINI_HC_TOL[dt]
              and (same or dt == "bf16"),
              f"mini-HC MSheath eval ({dt}, {MINI_HC_SHAPE}) on the card "
              f"against the CPU's f32: {rel:.3e} of the largest value "
              f"(tolerance {MINI_HC_TOL[dt]:g}); jump actions "
              f"{act.tolist()} / {act_ref.tolist()}"
              + ("" if dt == "f32" else " (printed in bf16)"))
        out[f"eval_{dt}"] = dict(rel=rel, actions_equal=same)
        if dt == "f32":
            _, act, grads = run(m, x.to(DEV), w.to(DEV))
            top = max(float(gr.abs().max()) for gr in g_ref
                      if gr is not None)
            worst = max(float((a - b).abs().max()) / top for a, b in
                        zip(grads, g_ref) if b is not None)
            names = [n for n, _ in cpu.named_parameters()]
            rnode = all(float(grads[names.index(n)].abs().max()) > 0
                        for n in ("par_w", "par_b", "rnet_w", "rnet_b"))
            check(worst <= MINI_HC_TOL["grad"] and rnode
                  and torch.equal(act, act_tref),
                  f"mini-HC MSheath train (f32) on the card against the "
                  f"CPU's: gradients {worst:.3e} of the largest (tolerance "
                  f"{MINI_HC_TOL['grad']:g}), the r_node parameters' "
                  f"nonzero, jump actions equal")
            out["grad_rel"] = worst
        del m
    counts = kernels.counts()
    c = counts["fused_sheath_scan"]
    check(c["launches"] == 0 and c["plain_calls"] == 0,
          f"mini-HC MSheath: fused_sheath_scan launched {c['launches']} "
          f"times, its plain version called {c['plain_calls']} times (the "
          "JAX gate keeps mini-HC off the scan kernel)")
    torch.cuda.empty_cache()
    return dict(out, counts=counts)


def variants_path(paths: dict, rel: dict) -> None:
    """The model variants: ``CHAINED_MOE`` served, route-checked and
    trained, and MSheath's mini-HC paths as a module
    (``minihc_module``); each path's counts go into ``paths``, the route
    checks' readings into ``rel``."""
    import torch
    from asr_model_tpu_torch.ops import cuda as kernels
    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(DEV)
    model = variant(CHAINED_MOE)
    paths["chained_moe_serve"] = variant_serve(model, audio, "chained-moe",
                                               kernels.SERVE_PATH)
    del model
    rel.update(variant_routes(audio, CHAINED_MOE, "chained-moe", True))
    kernels.reset_counts()
    short = train_batch(torch.from_numpy(tones(BATCH, VARIANT_SEC)).to(DEV))
    step0 = {}
    for dt in ("bf16", "f32"):
        kernels.reset_counts()
        step0[dt] = train_step0(short, dt, f"chained-moe train step {dt}",
                                CHAINED_MOE, witness=False)
        _check_counts(f"chained-moe train step {dt} (step 0)",
                      step0[dt]["counts"], ("flash_attention",))
    paths["chained_moe_train"] = train_path(
        short, "f32", "chained-moe train f32", step0["f32"],
        extra=CHAINED_MOE, steps=VARIANT_STEPS, timed=VARIANT_TIMED,
        profiler=profile_device)
    paths["chained_moe_train"]["loss0_bf16"] = step0["bf16"]["loss0"]
    paths["mini_hc_module"] = minihc_module()


# ---------------------------------------------------------------------------
# parallelism (parallel/): one rank over NCCL, and two gloo ranks on the
# one card

PAR_TOKENS = 64              # the SP long-form decode's budget
PP_ROWS = 4                  # the pipeline runs' batch
PAR_RANKS = 2                # gloo ranks sharing the card


def _par_step(step, batch, gen, timed: int = 1):
    """(loss, gnorm, jstat, step ms) of a train step's first call and the
    median ms of ``timed`` more (with none, the first call's)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, gn, js = step(batch, gen)
    out = (float(loss), float(gn), js.tolist())
    times = [] if timed else [(time.perf_counter() - t0) * 1e3]
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch, gen)[0])
        times.append((time.perf_counter() - t0) * 1e3)
    return out + (float(np.median(times)),)


def _par_case(extra, mesh_kw, batch_np, dev, timed: int = 1):
    """One sharded f32 train step case on the flagship (or a variant)
    from seed 0, the step's generator from seed 0: step 0's loss, grad
    norm and jump counter, ``timed`` timed steps (none: step 0's ms),
    the kernel counts of them all."""
    import torch
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.parallel.mesh import make_mesh
    from asr_model_tpu_torch.parallel.sharding import (
        make_sharded_train_step, shard_params)
    from asr_model_tpu_torch.train.loop import device_batch, make_optimizer
    kernels.reset_counts()
    m = Model(Dimensions(), ModelConfig(**extra), device=dev, seed=0)
    mesh = make_mesh(**mesh_kw)
    shard_params(m, mesh)
    step = make_sharded_train_step(m, make_optimizer(Config(), m)[0], mesh)
    g = torch.Generator(device=dev).manual_seed(0)
    loss, gn, js, ms = _par_step(step, device_batch(batch_np, dev), g,
                                 timed)
    out = dict(loss0=loss, gnorm0=gn, jstat0=js, step_ms=ms,
               counts=kernels.counts(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del m, step
    torch.cuda.empty_cache()
    return out


def _par_rank(rank, store, cases, out_path):
    """A gloo rank on the card (``parallel_path``): each case in turn,
    rank 0's readings written to ``out_path``."""
    sys.path.insert(0, ROOT)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import pickle

    import torch
    import torch.distributed as dist
    from asr_model_tpu_torch.ops.cuda import build
    from asr_model_tpu_torch.parallel.mesh import initialize_distributed
    build.library()
    # as ``main`` sets it: no TF32 in the f32 products and convolutions
    # (cuDNN's default takes TF32, and its choice moves with the batch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = initialize_distributed(rank=rank, world_size=PAR_RANKS,
                                 init_method=f"file://{store}/gloo",
                                 device="cuda:0", backend="gloo")
    got = {}
    for name, extra, mesh_kw, batch_np in cases:
        t0 = time.perf_counter()
        # step 0's ms: through gloo on one card the time is the host's
        got[name] = _par_case(extra, mesh_kw, batch_np, dev, timed=0)
        got[name]["wall_s"] = time.perf_counter() - t0
        got[name]["backend"] = dist.get_backend()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(got, f)
    dist.barrier()
    dist.destroy_process_group()


def _par_gate(label, got, ref, rel_limit=None):
    """Step 0's loss (``TRAIN_TOL``) and grad norm (``rel_limit``, the
    reference's witness limit) against the one-device step's."""
    tol = TRAIN_TOL["f32"]
    rl = abs(got["loss0"] - ref["loss0"]) / abs(ref["loss0"])
    rg = abs(got["gnorm0"] - ref["gnorm0"]) / abs(ref["gnorm0"])
    limit = ref.get("gnorm0_limit") if rel_limit is None else rel_limit
    check(bool(np.isfinite([got["loss0"], got["gnorm0"]]).all())
          and rl <= tol and rg <= limit,
          f"{label} step 0 against the one-device step: loss "
          f"{got['loss0']:.6f} / {ref['loss0']:.6f} (rel {rl:.2e}, "
          f"tolerance {tol:g}), grad norm {got['gnorm0']:.4f} / "
          f"{ref['gnorm0']:.4f} (rel {rg:.2e}, limit {limit:.2e}), jstat "
          f"{got.get('jstat0')}")
    return dict(rel_loss0=rl, rel_gnorm0=rg)


def parallel_path(paths: dict, rel: dict, batch_np, step0: dict) -> None:
    """The ``parallel`` phase (module doc, 8): one rank over NCCL (the
    DP x TP step at data 1 x model 1, ``transcribe_long_sp`` at seq 1,
    the pipeline at pipe 1 with 2 microbatches), then ``PAR_RANKS``
    gloo ranks on the card (TP 2, DP 2, EP 2 on ``CHAINED_MOE``); each
    run's counts go into ``paths``."""
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.generate import greedy_decode
    from asr_model_tpu_torch.models.longform import (features,
                                                     transcribe_long_sp)
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops import cuda as kernels
    from asr_model_tpu_torch.parallel.mesh import (initialize_distributed,
                                                   make_mesh, make_pipe_mesh)
    from asr_model_tpu_torch.parallel.pipeline import (make_pp_train_step,
                                                       stage_params)
    from asr_model_tpu_torch.parallel.seq import encoder_halo
    from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                                make_train_step)
    store = tempfile.mkdtemp(prefix="chip_smoke_par_")
    initialize_distributed(rank=0, world_size=1, device=DEV,
                           init_method=f"file://{store}/nccl")
    log(f"parallel: 1 rank, backend {dist.get_backend()}")
    # the DP x TP step at data 1 x model 1 (the sharded code, one rank)
    got = _par_case({}, {}, batch_np, DEV)
    rel["parallel_dp_tp_1"] = _par_gate("DP x TP step (data 1 x model 1, "
                                        "NCCL)", got, step0["f32"])
    _check_counts("DP x TP step (data 1 x model 1)", got["counts"],
                  ("flash_attention",))
    log(f"DP x TP step (1 rank, nccl): step {got['step_ms']:.1f} ms, "
        f"peak {got['peak_gib']:.2f} GiB, hand kernels "
        f"{_launches(got['counts'])}")
    paths["parallel_dp_tp_1"] = got
    # sequence-parallel long-form at seq 1, f32, with the fused fields
    # (the decode's MLPs and routers through their kernels; the SP
    # context takes neither whole-call attention kernel, as in JAX); the
    # ids held exactly to greedy_decode's on the same padded features
    model = flagship(True, torch.float32)
    mesh = make_mesh(seq=1)
    wav = tones(1, LONG_SEC)[0]
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _ = transcribe_long_sp(model, wav, mesh, max_new_tokens=PAR_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    mel, pitch, wave = features(torch.from_numpy(wav)[None].to(DEV), SR,
                                HOP, model.dims.mels, torch.float32, "dio")
    T = mel.shape[-1]
    t_pad = max(T, encoder_halo(model.dims.layer))
    pad = lambda x: torch.nn.functional.pad(x, (0, t_pad - x.shape[-1]))
    want = greedy_decode(model, spectrogram=pad(mel), pitch=pad(pitch),
                         waveform=pad(wave), max_new_tokens=PAR_TOKENS)
    want = [t for t in want[0, 1:].tolist() if t not in (0, 2)]
    check(ids == want, f"transcribe_long_sp (seq 1, f32, {LONG_SEC:g} s, "
          f"{PAR_TOKENS} tokens): {len(ids)} ids equal to greedy_decode's "
          "on the same padded features")
    _check_counts("transcribe_long_sp (seq 1)", counts, kernels.SERVE_PATH
                  + ("fused_mlp_residual", "fused_router_same"))
    paths["parallel_sp_1"] = dict(counts=counts, wall_s=wall,
                                  rtfx=LONG_SEC / wall, ids_n=len(ids))
    log(f"transcribe_long_sp (1 rank, nccl): {wall * 1e3:.1f} ms for "
        f"{LONG_SEC:g} s, RTFx {LONG_SEC / wall:.2f}, hand kernels "
        f"{_launches(counts)}")
    del model
    torch.cuda.empty_cache()
    # the pipeline at pipe 1: 1 microbatch held to the one-device step
    # (noise-free, dropout 0: the same function), 2 microbatches timed
    short = train_batch(torch.from_numpy(tones(BATCH, VARIANT_SEC)).to(DEV))
    # the pipeline's runs on 4 of them (2 microbatches of 2 rows)
    batch = device_batch({k: v[:PP_ROWS] for k, v in short.items()}, DEV)
    chained = dict(chained_blocks=True, dropout=0.0)
    reads = {}
    for label, micro in (("one-device", 0), ("pp_m1", 1), ("pp_m2", 2)):
        m = Model(Dimensions(), ModelConfig(**chained), device=DEV, seed=0)
        if micro:
            pmesh = make_pipe_mesh(pipe=1)
            step = make_pp_train_step(m, make_optimizer(
                Config(), m, named=stage_params(m, pmesh))[0], pmesh, micro)
        else:
            step = make_train_step(m, make_optimizer(Config(), m)[0])
        kernels.reset_counts()
        loss, gn, js, ms = _par_step(step, batch, None, timed=0)
        reads[label] = dict(loss0=loss, gnorm0=gn, jstat0=js, step_ms=ms,
                            counts=kernels.counts())
        del m, step
        torch.cuda.empty_cache()
    rel["parallel_pp_m1"] = _par_gate(
        "pipeline (pipe 1, 1 microbatch, noise-free)", reads["pp_m1"],
        reads["one-device"], rel_limit=1e-4)
    for label in ("pp_m1", "pp_m2"):
        _check_counts(f"pipeline {label}", reads[label]["counts"],
                      ("flash_attention",))
    check(bool(np.isfinite([reads["pp_m2"]["loss0"],
                            reads["pp_m2"]["gnorm0"]]).all()),
          f"pipeline (pipe 1, 2 microbatches) loss "
          f"{reads['pp_m2']['loss0']:.4f}, grad norm "
          f"{reads['pp_m2']['gnorm0']:.4f} finite")
    log(f"pipeline (1 rank, nccl; chained flagship, {PP_ROWS} x "
        f"{VARIANT_SEC:g} s): 2 microbatches, step 0 "
        f"{reads['pp_m2']['step_ms']:.1f} ms (the first call, "
        f"allocations included); hand kernels "
        f"{_launches(reads['pp_m2']['counts'])}")
    paths["parallel_pp_1"] = reads["pp_m2"]
    dist.destroy_process_group()
    # PAR_RANKS gloo ranks on the one card (NCCL takes one rank a card;
    # gloo takes all_reduce on CUDA tensors, not send / recv: the halo
    # exchange and the pipeline's hops run at one rank above)
    torch.cuda.empty_cache()
    cases = [("tp2", {}, dict(model=2), batch_np),
             ("dp2", {}, dict(data=2), batch_np),
             ("ep2", CHAINED_MOE, dict(expert=2), short)]
    out_path = os.path.join(store, "ranks.pkl")
    t0 = time.perf_counter()
    mp.spawn(_par_rank, args=(store, cases, out_path), nprocs=PAR_RANKS,
             join=True)
    with open(out_path, "rb") as f:
        ranks = pickle.load(f)
    log(f"parallel: {PAR_RANKS} ranks on one card, backend "
        f"{ranks['tp2']['backend']}, {time.perf_counter() - t0:.1f} s")
    refs = {"tp2": step0["f32"], "dp2": step0["f32"],
            "ep2": paths["chained_moe_train"]}
    what = {"tp2": "TP 2 (model 2)", "dp2": "DP 2 (data 2)",
            "ep2": "EP 2 (expert 2, chained MoE, 8 x 2.55 s)"}
    for name, got in ranks.items():
        rel[f"parallel_{name}"] = _par_gate(
            f"{what[name]} step ({PAR_RANKS} gloo ranks)", got, refs[name])
        _check_counts(f"{what[name]} step", got["counts"],
                      ("flash_attention",))
        log(f"{what[name]} ({PAR_RANKS} ranks, gloo, one card): step 0 "
            f"{got['step_ms']:.1f} ms, rank 0 peak {got['peak_gib']:.2f} "
            f"GiB, hand kernels {_launches(got['counts'])}")
        paths[f"parallel_{name}"] = got


def _launches(counts) -> dict:
    return {n: c["launches"] for n, c in counts.items() if c["launches"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from asr_model_tpu_torch.ops import cuda as kernels
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
    phase_done("build")
    mma = sass_mma_counts(lib)
    log("tensor-core instructions (cuobjdump -sass): "
        f"{json.dumps(mma) if mma is not None else 'no cuobjdump'}")
    if mma is not None:
        for name in MMA_KERNELS:
            found = {k: c for k, c in mma.items() if k.startswith(name)}
            check(len(found) > 0 and all(c["HGMMA"] + c["HMMA"] > 0
                                         for c in found.values()),
                  f"{name} runs on the tensor cores ({len(found)} "
                  "instantiation(s))")

    audio = torch.from_numpy(tones(BATCH, UTT_SEC)).to(DEV)
    # the train steps' step-0 gates first, in the fresh process, bf16
    # before f32 (``train_step0``); the training phases below use their
    # readings
    kernels.reset_counts()
    batch_np = train_batch(audio)
    features = kernels.counts()
    kernels.reset_counts()
    step0 = {"bf16": train_step0(batch_np, "bf16", "train step bf16",
                                 witness=False)}
    kernels.reset_counts()
    step0["f32"] = train_step0(batch_np, "f32", "train step f32")
    for name, c in features.items():
        step0["f32"]["counts"][name]["launches"] += c["launches"]
        step0["f32"]["counts"][name]["plain_calls"] += c["plain_calls"]
    phase_done("train step-0 gates")
    model, fused = flagship(False), flagship(True)
    fused.load_state_dict(model.state_dict())
    kern = check_kernels(model) + check_fused_kernels(fused, audio)
    lifted = check_lifted_shapes()
    for k in kern:
        k["shapes"] += lifted.get(k["name"], [])

    phase_done("kernel checks")
    paths = {"default": drive_path(model, audio, "default",
                                   kernels.DEFAULT_PATH),
             "fused": drive_path(fused, audio, "fused",
                                 kernels.DEFAULT_PATH + kernels.FUSED_ONLY)}
    same = float((paths["fused"]["ids"] == paths["default"]["ids"])
                 .float().mean())
    log(f"bf16 tokens identical on the two paths: {100 * same:.1f}%")
    rel = {"default_bf16": route_check(
        model, audio, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "default path")[0],
        "fused_bf16": route_check(
        fused, audio, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "fused path")[0]}
    # B = 128: the MSheath scans (encoder and decode) past one pass of the
    # kernel's memory EMA; the fused gates' size bound sends every call
    # of this batch to the default route's kernels
    audio128 = torch.from_numpy(tones(128, UTT_SEC)).to(DEV)
    rel["default_bf16_b128"] = route_check(
        model, audio128, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "B 128")[0]
    del fused, audio128

    phase_done("default and fused paths")
    # serving: the kernels at the long-form and beam shapes, DIO's
    # contour kernel and the card's DIO, then Transcriber end to end
    served = check_serve_shapes(model)
    for k in kern:
        k["shapes"] += served.get(k["name"], [])
    kern.append(check_dio(audio))
    paths["serve"] = serve_path(model, audio)
    log(f"serve path RTFx {paths['serve']['rtfx']:.3f} against the default "
        f"path's {paths['default']['rtfx']:.3f} in this call (the serve "
        "path: DIO pitch, EOS not suppressed)")
    rel["serve_bf16"] = route_check(
        model, audio, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "serve path "
        "(DIO features)", serve_logits)[0]
    chunk = torch.from_numpy(tones(1, LONG_SEC)[:, :CHUNK_SAMPLES]).to(DEV)
    rel["serve_long_chunk_bf16"] = route_check(
        model, chunk, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "serve long-form "
        "chunk (1, 480000)", serve_logits)[0]
    del model, chunk

    phase_done("serving")
    # the streaming variant (same weights): the incremental decode, then
    # the same with the fused fields (the stream step's MLPs and routers
    # through their kernels; its attention is flash against the caches)
    stream, stream_fused = (flagship(False, streaming=True),
                            flagship(True, streaming=True))
    stream_only = ("flash_attention", "fused_abby")
    mlp_router = ("fused_mlp_residual", "fused_router_same")
    paths["stream"] = drive_path(stream, audio, "stream",
                                 kernels.DEFAULT_PATH, runs=1, stream=True,
                                 step_expect=stream_only)
    paths["stream_fused"] = drive_path(
        stream_fused, audio, "stream+fused", kernels.DEFAULT_PATH
        + mlp_router, runs=1, stream=True,
        step_expect=stream_only + mlp_router)
    same = float((paths["stream_fused"]["ids"] == paths["stream"]["ids"])
                 .float().mean())
    log(f"bf16 tokens identical on the stream and stream+fused paths: "
        f"{100 * same:.1f}%")
    stream_vs_buffer(stream, audio, torch.bfloat16, None)
    rel["stream_bf16"] = route_check(
        stream, audio, torch.bfloat16, 7e-2,
        "bf16 rounds at other places on the two routes", "stream path",
        first_stream_logits)[0]
    paths["stream"]["rtfx_b64"] = stream_rtfx_at(stream, 64)
    paths["serve_stream"] = serve_stream(stream, audio)
    del stream, stream_fused
    phase_done("stream paths")
    m32, fus32 = flagship(False, torch.float32), flagship(True, torch.float32)
    rel["default_f32"], l_def = route_check(
        m32, audio, torch.float32, 6e-5, "f32 sums in other orders",
        "default path")
    rel["fused_f32"], l_fus = route_check(
        fus32, audio, torch.float32, 6e-5, "f32 sums in other orders",
        "fused path")
    rel["fused_vs_default_f32"] = compare_logits(
        l_fus, l_def, 2e-5, "first decode step logits, fused path vs default "
        "path, both on their kernels (f32; the fused kernels sum and round "
        "in other places)")
    del m32, fus32
    s32 = flagship(False, torch.float32, streaming=True)
    stream_vs_buffer(s32, audio, torch.float32, 6e-5)
    rel["stream_f32"] = route_check(
        s32, audio, torch.float32, 6e-5, "f32 sums in other orders",
        "stream path", first_stream_logits)[0]
    del s32
    rel["small_default"] = small_reference(False)
    rel["small_fused"] = small_reference(True)
    rel["small_stream"] = small_reference(False, streaming=True)

    # training: flash under autograd, the train step on the data
    # pipeline's features (f32, then bf16 compute over f32 masters), and
    # the training CLI
    phase_done("f32 route checks and small models")
    flash_train = check_flash_autograd()
    for k in kern:
        if k["name"] == "flash_attention":
            k["shapes"] += flash_train
    paths["train"] = train_path(batch_np, "f32", "train step f32",
                                step0["f32"])
    _check_counts("train path (the batch's features and one step)",
                  paths["train"]["counts"], kernels.TRAIN_PATH)
    paths["train_bf16"] = train_path(batch_np, "bf16", "train step bf16",
                                     step0["bf16"])
    _check_counts("train path bf16 (one step)",
                  paths["train_bf16"]["counts"], ("flash_attention",))
    paths["train_cli"] = cli_path()
    _check_counts("training CLI (features, steps, eval)",
                  paths["train_cli"]["counts"], kernels.DEFAULT_PATH)

    # training on audio files: FLAC and WAV fixtures, remat, the
    # gradient diagnostics, the CLI on files and the reference import
    phase_done("training")
    files = files_path(batch_np, paths["train"])
    _check_counts("train path on files (the FLAC batch's features and one "
                  "step)", files["counts"], kernels.TRAIN_PATH)
    _check_counts("training CLI on files (features, steps with remat, "
                  "eval)", files["cli"]["counts"], kernels.DEFAULT_PATH)
    paths["train_files_remat"] = {"counts": files.pop("remat_step_counts")}
    _check_counts("remat step (f32, dots; the loss's recompute launches "
                  "flash again)", paths["train_files_remat"]["counts"],
                  ("flash_attention",))
    paths["train_files"] = files
    paths["train_files_cli"] = files.pop("cli")
    phase_done("training on files")

    # the model variants: a chained MoE model with the encoder's options,
    # served, route-checked and trained; MSheath's mini-HC paths as a
    # module
    variants_path(paths, rel)
    phase_done("model variants")

    # parallelism: one rank over NCCL, then two gloo ranks on the card
    parallel_path(paths, rel, batch_np, step0)
    phase_done("parallel")

    # past the kernels' shared-memory plans (the routes), then the latent
    # modules and the host features
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    kern += check_limits()
    torch.cuda.empty_cache()
    phase_done("limits")
    rel["latent_modules"] = latent_modules()
    phase_done("latent modules")

    # (a route's launches on every path: 0, no path's shapes reach one)
    for k in kern:
        by_path = {p: r["counts"][k["name"]]["launches"]
                   for p, r in paths.items()}
        # the serving frontend's kernel counts on the serve path, the
        # others on the fused path
        k["launches"] = by_path["serve" if k["name"] == "dio_contour"
                                else "fused"]
        k["launches_by_path"] = by_path

    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed")
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", *FAILURES,
              sep="\n  ", file=sys.stderr)
        return 1
    log(json.dumps({"paths": {p: {k: v for k, v in r.items()
                                  if k not in ("counts", "ids")}
                              for p, r in paths.items()},
                    "route_checks": rel, "card": card}))
    log(json.dumps({"kernels": kern}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
