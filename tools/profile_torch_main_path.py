#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path on one GPU.

    python3 tools/profile_torch_main_path.py [--top 15]

Runs chip_smoke.py's flagship main path (8 x 10 s tones, bf16, 64
tokens with EOS suppressed) once to warm up, then once under
``torch.profiler`` (CPU and CUDA activities), and prints the wall time,
the summed device time of all kernels (one stream: kernels do not
overlap), the device's busy share, the launch count, and the kernels
with the most device time.  The last line is one JSON object with the
same numbers.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.models.model import Model, cast_variables

    model = cast_variables(Model(Dimensions(), device="cuda", seed=0))
    audio = torch.from_numpy(cs.tones(cs.BATCH, cs.UTT_SEC)).cuda()
    cs.transcribe(model, audio)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.transcribe(model, audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, evt.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    launches = sum(r[1] for r in rows)
    card = cs.card_line()
    print(f"card: {card}")
    print(f"one transcribe under the profiler: wall {wall_ms:.3f} ms, "
          f"device kernels {device_ms:.3f} ms over {launches} launches, "
          f"busy {100 * device_ms / wall_ms:.1f}%")
    for key, count, ms in rows[:args.top]:
        print(f"  {ms:10.3f} ms {count:7d} x  {key[:100]}")
    print(json.dumps({
        "wall_ms": wall_ms, "device_ms": device_ms, "launches": launches,
        "busy_share": device_ms / wall_ms, "card": card,
        "top": [{"kernel": k[:100], "count": c, "ms": m}
                for k, c, m in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
