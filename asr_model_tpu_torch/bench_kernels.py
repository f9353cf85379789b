#!/usr/bin/env python3
"""Device time of the port's decode-path kernels at every prefix-bucket
width, on one GPU, for one checkout of the package.

    python3 asr_model_tpu_torch/bench_kernels.py [--root DIR] [--repeats 5]
        [--only flash,abby,sheath,attn_full,attn_cached,mlp,router,tail,
        dio,floor] [--profile]

At every decode width w (9, 17, ..., 65; 8 utterances, the flagship's 512
channels, 4 heads of 128) and at encoder length (1001 frames), each
held against its plain version:
- flash: bf16 ``flash_attention`` against the cached cross K/V of a
  1001-frame encoding, and the self causal call at width 65 with a
  kv_valid mask, beside ``F.scaled_dot_product_attention``; and the
  streaming decode's step: one query row (8, 4, 1, 128) against a
  65-position self cache with a prefix mask (33 live) and against the
  1001-frame audio cache;
- abby: bf16 ``fused_abby`` at (8 w, 512), the per-head norms at
  (8 * 4 * w, 128), the encoder's (8 * 1001, 512), and the streaming
  step's (8, 512) and (8 * 4, 128);
- sheath: ``fused_sheath_scan`` of a seeded bf16 flagship MSheath (D
  512, M 64, 4 slots) over bf16 x at (8 w, 512) with a kv-style valid
  mask, and at (8 * 1001, 512) without one;
- attn_full: bf16 ``fused_attn_full`` of the flagship's shapes (512
  channels, 4 heads) with random weights: the self causal call with
  the prefix mask at (8, w, 512), and at widths 9 and 65 the non-causal
  self call and the g block's cross call;
- attn_cached: bf16 ``fused_attn_cached`` of (8, w, 512) against a
  (8, 4, 1001, 128) K/V cache;
- mlp: bf16 ``fused_mlp_residual`` at (8 w, 512), 3 gates, hidden 1536;
- router: bf16 ``fused_router_same`` at (8 w, 512), 3 types, 3
  modalities (the fused decode's routers);
- tail: bf16 ``fused_abby_tail`` at (8 w, 512) on f32 logits;
- dio: ``dio_contour`` on DIO's own candidates of bench.py's tones, at
  the serve batch (8, 7, 1001), a 30 s long-form chunk (1, 7, 3001) and
  the tones with noise gaps every 0.25 s (8, 7, 1001); and the wall
  time of the whole ``dio_pitch_track`` on the serve batch (host clock
  around a synchronised call, median of 20 x ``--repeats``);
- floor: one PyTorch kernel on a one-element tensor (``add_``), the
  device time this harness reads for a launch that does no work.
Times are device time (chip_smoke.py's ``cuda_ms``), the median of
``--repeats`` readings of 20 calls; with ``--profile``, the whole-call
kernels' rows also hold each device kernel's time per call (torch.profiler
over 20 calls).  ``--root`` names the checkout whose
package is timed (default: this one), so that two versions of a kernel
can be compared in one call on one card: run A, B, B, A.  Prints one
line per shape and, last, one JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = list(range(9, 66, 8))


def _median_ms(fn, repeats):
    import numpy as np
    from chip_smoke import cuda_ms
    runs = [cuda_ms(fn, iters=20) for _ in range(repeats)]
    return float(np.median(runs)), runs


def bench_flash(dev, repeats, rows):
    import torch
    import torch.nn.functional as F
    from asr_model_tpu_torch.ops.cuda import attention
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, hd, tk_enc = 8, 4, 128, 1001
    rnd = lambda t: torch.randn(b, h, t, hd, device=dev,
                                generator=g).bfloat16()
    k_enc, v_enc = rnd(tk_enc), rnd(tk_enc)
    # (label, query rows, keys (None: the encoding's), causal, live keys
    # of a prefix mask (None: no mask))
    shapes = [(f"cached cross ({b},{h},{w},{hd})x({b},{h},{tk_enc},{hd})",
               w, None, False, None) for w in WIDTHS]
    shapes += [
        (f"self causal ({b},{h},65,{hd}) + kv_valid", 65, 65, True, None),
        (f"stream step ({b},{h},1,{hd})x({b},{h},65,{hd}) + prefix mask "
         "(33 live)", 1, 65, False, 33),
        (f"stream step ({b},{h},1,{hd})x({b},{h},{tk_enc},{hd})", 1, None,
         False, None)]
    for label, tq, tk, causal, live in shapes:
        q = rnd(tq)
        k, v = (k_enc, v_enc) if tk is None else (rnd(tk), rnd(tk))
        tk = k.shape[2]
        valid, mask = None, None
        if causal:
            lens = torch.arange(b, device=dev) * 3 + 40
            valid = torch.arange(tk, device=dev)[None] < lens[:, None]
            mask = (torch.ones(tq, tk, dtype=torch.bool, device=dev)
                    .tril(tk - tq)[None, None] & valid[:, None, None, :])
        elif live is not None:
            valid = (torch.arange(tk, device=dev) < live)[None].expand(
                b, tk).contiguous()
            mask = valid[:, None, None, :]
        got = attention.flash_attention(q, k, v, causal, valid)
        want = attention.attention_plain(q.float(), k.float(), v.float(),
                                         causal, valid)
        err = float((got.float() - want).abs().max() / want.abs().max())
        ms, runs = _median_ms(lambda: attention.flash_attention(
            q, k, v, causal, valid), repeats)
        sdpa, sdpa_runs = _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), repeats)
        rows.append(dict(kernel="flash_attention", shape=label,
                         splits=attention.splits(b * h, tq, tk, sms),
                         err_over_max=err, ms=ms, ms_runs=runs,
                         sdpa_ms=sdpa, sdpa_runs=sdpa_runs))
        print(f"flash {label}: {ms:.4f} ms ({rows[-1]['splits']} split(s)), "
              f"SDPA {sdpa:.4f} ms, max err {err:.2e} max|plain|",
              flush=True)


def bench_abby(dev, repeats, rows):
    import torch
    from asr_model_tpu_torch.ops.cuda import abby
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = [(8 * w, 512) for w in WIDTHS] + \
        [(8 * 4 * w, 128) for w in WIDTHS] + [(8 * 1001, 512)] + \
        [(8, 512), (8 * 4, 128)]
    for n, d in shapes:
        r = lambda *s, sc=1.0: (sc * torch.randn(*s, device=dev, generator=g)
                                ).bfloat16()
        args = (r(n, d, sc=2.0), r(d, d, sc=d ** -0.5), r(d, sc=0.1),
                r(3, d, sc=d ** -0.5), r(3, sc=0.1), abby.window_size(d),
                1e-4, 1.0, 0.75)
        got, want = abby.fused_abby(*args), abby.abby_plain(*args)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        ms, runs = _median_ms(lambda: abby.fused_abby(*args), repeats)
        rows.append(dict(kernel="fused_abby", shape=f"({n}, {d}) bf16",
                         err_over_max=err, ms=ms, ms_runs=runs))
        print(f"abby ({n}, {d}) bf16: {ms:.4f} ms, max err {err:.2e} "
              "max|plain|", flush=True)


def bench_sheath(dev, repeats, rows):
    import torch
    from asr_model_tpu_torch.models.sheath import MSheath, masked_mean
    from asr_model_tpu_torch.models.tlayers import reset_all
    from asr_model_tpu_torch.ops.cuda import sheath
    m = MSheath(512, 4, 4, device=dev)
    reset_all(m, torch.Generator(device=dev).manual_seed(2))
    m = m.to(torch.bfloat16)
    w = m.scan_weights()
    sw = {k: w[k] for k in sheath.WEIGHT_NAMES}
    g = torch.Generator(device=dev).manual_seed(3)
    for ctx in WIDTHS + [1001]:
        x = torch.randn(8, ctx, 512, device=dev, generator=g).bfloat16()
        valid = None
        if ctx < 1001:
            valid = (torch.arange(ctx, device=dev)[None]
                     < torch.arange(8, device=dev)[:, None] + ctx - 8)
        pooled = masked_mean(x, valid, dim=1)[:, 0]
        sampled = torch.argmax(m.pnet(pooled).mean(0)).to(torch.int32)
        args = (x.reshape(-1, 512), 8, valid, w["mem0"], sampled,
                w["jump_s"], sw, 4, m.thresh)
        got, act, _ = sheath.fused_sheath_scan(*args)
        want, act_p, _ = sheath.sheath_scan_plain(*args)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        ms, runs = _median_ms(lambda: sheath.fused_sheath_scan(*args),
                              repeats)
        label = f"(8*{ctx}, 512) bf16" + (" + valid" if valid is not None
                                          else "")
        rows.append(dict(kernel="fused_sheath_scan", shape=label,
                         actions=act.tolist(),
                         actions_match=act.tolist() == act_p.tolist(),
                         err_over_max=err, ms=ms, ms_runs=runs))
        print(f"sheath {label}: {ms:.4f} ms, actions {act.tolist()} "
              f"(plain {act_p.tolist()}), max err {err:.2e} max|plain|",
              flush=True)


def _weights(r, d, heads):
    """Random whole-call attention weights (torch (out, in) layouts)."""
    def norm(n):
        return {"n_w1": r(n, n, sc=n ** -0.5), "n_b1": r(n, sc=0.1),
                "n_w2": r(3, n, sc=n ** -0.5), "n_b2": r(3, sc=0.1)}
    wq = norm(d) | {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    wkv = norm(d) | {"proj_w": r(2 * d, d, sc=d ** -0.5),
                     "proj_b": r(2 * d, sc=0.1)}
    wo = {"proj_w": r(d, d, sc=d ** -0.5), "proj_b": r(d, sc=0.1)}
    return wq, wkv, norm(d // heads), wo


def _rand(dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *s, sc=1.0: (sc * torch.randn(*s, device=dev, generator=g)
                               ).bfloat16()


def _attn_kw(d, heads):
    from asr_model_tpu_torch.ops.cuda import abby
    return dict(head=heads, size_d=abby.window_size(d),
                size_h=abby.window_size(d // heads), alpha=1e-4, k=1.0,
                beta=0.75)


PROFILE = False


def _kernel_us(fn, calls: int = 20) -> dict:
    """Device us per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or \
            getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key.split("(")[0][:48]] = us / calls
    return out


def _row(rows, kernel, label, got, want, fn, repeats):
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    ms, runs = _median_ms(fn, repeats)
    rows.append(dict(kernel=kernel, shape=label, err_over_max=err, ms=ms,
                     ms_runs=runs))
    parts = ""
    if PROFILE:
        rows[-1]["kernel_us"] = _kernel_us(fn)
        parts = "; " + ", ".join(f"{k} {v:.2f} us"
                                 for k, v in rows[-1]["kernel_us"].items())
    print(f"{kernel} {label}: {ms:.4f} ms, max err {err:.2e} max|plain|"
          + parts, flush=True)


def bench_attn_full(dev, repeats, rows):
    import torch
    from asr_model_tpu_torch.models.rotary import compute_freqs
    from asr_model_tpu_torch.ops.cuda import xattn
    b, d, heads = 8, 512, 4
    r = _rand(dev, 4)
    wq, wkv, wh, wo = _weights(r, d, heads)
    kw = _attn_kw(d, heads)
    shapes = [(w, True, False) for w in WIDTHS] + [
        (w, causal, cross) for w in (9, 65)
        for causal, cross in ((False, False), (False, True))]
    for w, causal, cross in shapes:
        x = r(b, w, d, sc=0.5)
        xa = r(b, w, d, sc=0.5) if cross else x
        valid = (torch.arange(w, device=dev) < w - 1)[None].expand(
            b, w).contiguous()
        fr = torch.from_numpy(compute_freqs(d, heads, causal)).to(dev)
        args = (x, xa, valid, fr, wq, wkv, wh, wo)
        label = (f"{'g cross' if cross else 'self'}"
                 f"{' causal' if causal else ''} ({b},{w},{d}) + kv_valid")
        _row(rows, "fused_attn_full", label,
             xattn.fused_attn_full(*args, causal=causal, **kw),
             xattn.attn_full_plain(*args, causal=causal, **kw),
             lambda: xattn.fused_attn_full(*args, causal=causal, **kw),
             repeats)


def bench_attn_cached(dev, repeats, rows):
    import torch
    from asr_model_tpu_torch.models.rotary import compute_freqs
    from asr_model_tpu_torch.ops.cuda import xattn
    b, d, heads, tk = 8, 512, 4, 1001
    r = _rand(dev, 5)
    wq, _, wh, wo = _weights(r, d, heads)
    kw = _attn_kw(d, heads)
    kn, v = r(b, heads, tk, 128), r(b, heads, tk, 128)
    fr = torch.from_numpy(compute_freqs(d, heads, False)).to(dev)
    for w in WIDTHS:
        args = (r(b, w, d, sc=0.5), kn, v, None, fr, wq, wh, wo)
        _row(rows, "fused_attn_cached",
             f"({b},{w},{d}) x K/V ({b},{heads},{tk},128)",
             xattn.fused_attn_cached(*args, **kw),
             xattn.attn_cached_plain(*args, **kw),
             lambda: xattn.fused_attn_cached(*args, **kw), repeats)


def bench_mlp(dev, repeats, rows):
    from asr_model_tpu_torch.ops.cuda import abby, mlp
    d, hid = 512, 1536
    r = _rand(dev, 6)
    ln = (r(d, d, sc=d ** -0.5), r(d, sc=0.1), r(3, d, sc=d ** -0.5),
          r(3, sc=0.1))
    gates = [(r(d, d, sc=d ** -0.5), r(d, sc=0.1)) for _ in range(3)]
    for w in WIDTHS:
        n = 8 * w
        args = (r(n, d), ln, r(3, d, sc=d ** -0.5), r(3, sc=0.1), gates,
                r(hid, d, sc=d ** -0.5), r(hid, sc=0.1),
                r(d, hid, sc=hid ** -0.5), r(d, sc=0.1), abby.window_size(d),
                1e-4, 1.0, 0.75)
        _row(rows, "fused_mlp_residual", f"(8*{w}, {d}), 3 gates, hidden "
             f"{hid}", mlp.fused_mlp_residual(*args),
             mlp.mlp_residual_plain(*args),
             lambda: mlp.fused_mlp_residual(*args), repeats)


def bench_router(dev, repeats, rows):
    from asr_model_tpu_torch.ops.cuda import router
    d, nt, n_mod = 512, 3, 3
    r = _rand(dev, 7)
    w = (r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1),
         r(nt, n_mod * d, sc=d ** -0.5), r(nt, sc=0.1), r(1))
    for wd in WIDTHS:
        args = (r(8 * wd, d), *w, n_mod)
        _row(rows, "fused_router_same", f"(8*{wd}, {d}), {nt} types, "
             f"{n_mod} modalities", router.fused_router_same(*args),
             router.router_same_plain(*args),
             lambda: router.fused_router_same(*args), repeats)


def bench_tail(dev, repeats, rows):
    from asr_model_tpu_torch.ops.cuda import abby
    d = 512
    r = _rand(dev, 8)
    for wd in WIDTHS:
        n = 8 * wd
        args = (r(n, d, sc=2.0), r(n, 3).float(), abby.window_size(d), 1e-4,
                1.0, 0.75)
        _row(rows, "fused_abby_tail", f"(8*{wd}, {d}) + f32 logits",
             abby.fused_abby_tail(*args), abby.abby_tail_plain(*args),
             lambda: abby.fused_abby_tail(*args), repeats)


def bench_dio(dev, repeats, rows):
    import time

    import numpy as np
    import torch
    from chip_smoke import HOP, SR, tones
    from asr_model_tpu_torch.ops import dio
    from asr_model_tpu_torch.ops.cuda import dio as K
    period = HOP / SR * 1000.0
    vrm = dio.short_run(period)
    batch = torch.from_numpy(tones(8, 10.0)).to(dev)
    gapped = batch.clone()
    g = torch.Generator(device=dev).manual_seed(7)
    for i in range(0, gapped.shape[-1], SR // 2):
        gapped[:, i:i + SR // 4] = 0.5 * torch.randn(
            8, min(SR // 4, gapped.shape[-1] - i), device=dev, generator=g)
    chunk = torch.from_numpy(tones(1, 30.0)).to(dev)
    for label, x in (("tones (8, 7, 1001)", batch),
                     ("30 s chunk (1, 7, 3001)", chunk),
                     ("tones with noise gaps (8, 7, 1001)", gapped)):
        cand, f0, _ = dio.contour_inputs(x, SR, period)
        got = K.dio_contour(cand, f0, vrm, 0.1)
        want = K.dio_contour_plain(cand, f0, vrm, 0.1)
        if not torch.equal(got, want):
            raise AssertionError(f"dio_contour {label} differs from plain")
        _row(rows, "dio_contour", label, got, want,
             lambda: K.dio_contour(cand, f0, vrm, 0.1), repeats)
    # the whole of DIO + StoneMask on the serve batch, host clock around
    # a synchronised call: what the serve frontend waits for
    walls = []
    for i in range(3 + 20 * repeats):
        t0 = time.perf_counter()
        dio.dio_pitch_track(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    walls = walls[3:]
    ms = float(np.median(walls))
    rows.append(dict(kernel="dio_pitch_track", shape="(8, 160000) wall",
                     ms=ms, ms_min=min(walls), ms_max=max(walls)))
    print(f"dio_pitch_track (8, 160000): {ms:.3f} ms of wall time (median "
          f"of {len(walls)}; min {min(walls):.3f}, max {max(walls):.3f})",
          flush=True)


def bench_floor(dev, repeats, rows):
    import torch
    x = torch.zeros(1, device=dev)
    ms, runs = _median_ms(lambda: x.add_(1.0), repeats)
    rows.append(dict(kernel="launch_floor", shape="(1,) add_", ms=ms,
                     ms_runs=runs))
    print(f"launch floor, (1,) add_: {ms:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", default="flash,abby,sheath")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this package's directory: the
    # checkout under test (and this one, for chip_smoke) take its place
    sys.path[0:1] = [root, ROOT]

    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line
    import asr_model_tpu_torch
    assert os.path.abspath(asr_model_tpu_torch.__file__).startswith(root)

    dev = torch.device("cuda")
    rows: list = []
    benches = {"flash": bench_flash, "abby": bench_abby,
               "sheath": bench_sheath, "attn_full": bench_attn_full,
               "attn_cached": bench_attn_cached, "mlp": bench_mlp,
               "router": bench_router, "tail": bench_tail,
               "dio": bench_dio, "floor": bench_floor}
    for name in args.only.split(","):
        benches[name](dev, args.repeats, rows)
    print(json.dumps({"root": root, "card": card_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
