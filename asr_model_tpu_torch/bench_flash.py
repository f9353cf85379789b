#!/usr/bin/env python3
"""Device time of the port's bf16 flash-attention kernel at the decode
paths' shapes, beside SDPA's, on one GPU.

    python3 asr_model_tpu_torch/bench_flash.py [--root DIR] [--repeats 5]

Times ``asr_model_tpu_torch.ops.cuda.attention.flash_attention`` (bf16,
the flagship's 8 utterances x 4 heads of 128) against the cached cross
K/V of a 1001-frame encoding at every prefix-bucket width of the decode
(9, 17, ..., 65), and the self causal call at width 65 with a kv_valid
mask, each beside ``F.scaled_dot_product_attention`` on the same inputs
and held against the plain version.  Times are device time
(chip_smoke.py's ``cuda_ms``), the median of ``--repeats`` readings of
20 calls.  ``--root`` names the checkout whose package is timed (default:
this one), so that two versions of the kernel can be compared in one
call on one card.  Prints one line per shape and, last, one JSON object.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # run as a script, sys.path[0] is this package's directory: the
    # checkout under test (and this one, for chip_smoke) take its place
    sys.path[0:1] = [root, ROOT]

    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import card_line, cuda_ms
    from asr_model_tpu_torch.ops.cuda import attention
    assert os.path.abspath(attention.__file__).startswith(root)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, hd, tk_enc = 8, 4, 128, 1001
    rnd = lambda t: torch.randn(b, h, t, hd, device=dev,
                                generator=g).bfloat16()
    k_enc, v_enc = rnd(tk_enc), rnd(tk_enc)
    shapes = [(f"cached cross ({b},{h},{w},{hd})x({b},{h},{tk_enc},{hd})",
               w, False) for w in range(9, 66, 8)]
    shapes.append((f"self causal ({b},{h},65,{hd}) + kv_valid", 65, True))
    rows = []
    for label, tq, causal in shapes:
        q = rnd(tq)
        k, v = (rnd(tq), rnd(tq)) if causal else (k_enc, v_enc)
        tk = k.shape[2]
        valid, mask = None, None
        if causal:
            lens = torch.arange(b, device=dev) * 3 + 40
            valid = torch.arange(tk, device=dev)[None] < lens[:, None]
            mask = (torch.ones(tq, tk, dtype=torch.bool, device=dev)
                    .tril(tk - tq)[None, None] & valid[:, None, None, :])
        got = attention.flash_attention(q, k, v, causal, valid)
        want = attention.attention_plain(q.float(), k.float(), v.float(),
                                         causal, valid)
        err = float((got.float() - want).abs().max() / want.abs().max())
        ms = [cuda_ms(lambda: attention.flash_attention(q, k, v, causal,
                                                        valid), iters=20)
              for _ in range(args.repeats)]
        sdpa = [cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20) for _ in range(args.repeats)]
        row = dict(shape=label, splits=attention.splits(b * h, tq, tk, sms),
                   err_over_max=err, ms=float(np.median(ms)), ms_runs=ms,
                   sdpa_ms=float(np.median(sdpa)), sdpa_runs=sdpa)
        rows.append(row)
        print(f"{label}: {row['ms']:.4f} ms ({row['splits']} split(s)), "
              f"SDPA {row['sdpa_ms']:.4f} ms, max err {err:.2e} max|plain|",
              flush=True)
    print(json.dumps({"root": root, "card": card_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
