#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's train step on one GPU.

    python3 tools/profile_torch_train_step.py [--dtype f32|bf16] [--top 12]

chip_smoke.py's train cell: the flagship from seed 0, the 8 x 10 s
tones featurised by the training data pipeline (``train_batch``), 64
labels from a seed, dropout and gumbel draws from a seeded generator.
After two warm-up steps it times and profiles (chip_smoke's
``profile_kernels``: torch.profiler, CPU and CUDA activities) three
nested pieces of one step: the step's own forward and loss
(``step.loss_fn``), the same and its backward, and the whole step
(global grad norm, MaxFactor, the BatchNorm statistics).  The
differences give the backward and the optimizer's share.  Per piece:
wall ms (synchronised), kernel launches, device ms (kernels summed, the
optimizer's annotated range left out; one stream), and the kernels with
the most device time in the whole step.  The last line is one JSON
object with the same numbers.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    import chip_smoke as cs
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                                make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    audio = torch.from_numpy(cs.tones(cs.BATCH, cs.UTT_SEC)).to("cuda")
    batch = device_batch(cs.train_batch(audio), "cuda")
    compute = torch.bfloat16 if args.dtype == "bf16" else None
    model = Model(Dimensions(), ModelConfig(), device="cuda", seed=0)
    opt, _ = make_optimizer(Config(), model)
    step = make_train_step(model, opt, 0.0, compute)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = list(model.parameters())

    def backward():
        loss, _, _ = step.loss_fn(batch, gen)
        torch.autograd.grad(loss, params, allow_unused=True)

    pieces = {"forward": lambda: step.loss_fn(batch, gen),
              "forward+backward": backward,
              "step": lambda: step(batch, gen)}
    for _ in range(2):
        step(batch, gen)
    out, top = {}, []
    for name, fn in pieces.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n, dev, kernels = cs.profile_kernels(fn)
        out[name] = dict(wall_ms=wall, launches=n, device_ms=dev)
        if name == "step":
            top = sorted(kernels, reverse=True)[:args.top]
    out["backward"] = {k: out["forward+backward"][k] - out["forward"][k]
                       for k in out["forward"]}
    out["optimizer"] = {k: out["step"][k] - out["forward+backward"][k]
                        for k in out["forward"]}
    print(f"card: {cs.card_line()}; train step {args.dtype}")
    for name in ("forward", "backward", "optimizer", "step"):
        r = out[name]
        print(f"{name:>10}: {r['wall_ms']:9.2f} ms wall, "
              f"{r['launches']:6d} launches, {r['device_ms']:8.2f} ms of "
              f"device time")
    busy = 100 * out["step"]["device_ms"] / out["step"]["wall_ms"]
    print(f"device busy {busy:.1f}% of the step; kernels with the most "
          "device time:")
    for ms, count, key in top:
        print(f"  {ms:8.2f} ms  {count:6d}x  {key[:90]}")
    print(json.dumps({"dtype": args.dtype, "pieces": out,
                      "top": [dict(ms=ms, count=c, kernel=k)
                              for ms, c, k in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
