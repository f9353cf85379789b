#!/usr/bin/env python3
"""How far rounding moves step 0 of the flagship train step, against a
planted fault: the witness behind ``chip_smoke.py``'s step-0 gate
(``train_step0``), in several seeded directions.

    python3 tools/train_step0_witness.py [--dtype bf16|f32]
        [--seeds 7,8,9,10,11] [--root DIR] [--by-param]
        [--batch tones|files] [--steps N]

On chip_smoke's train batch (8 x 10 s tones through the training data
pipeline, 64 labels from a seed; ``--batch files``: its FLAC batch, 8
GrammarDataset sentences of 0.9-1.7 s) and the flagship from seed 0 (dropout
and gumbel draws from a generator seeded 0), it takes step 0 on the
kernel route and on the plain route, then on the plain route with every
attention output moved by one ulp and by the planted fault
(``chip_smoke.FAULT_REL``) up or down in the direction each seed draws,
and prints one JSON line: the loss and the global grad norm of each
reading relative to the plain route's.  ``--root`` takes chip_smoke and
the package from another checkout (a ``git archive`` of another commit),
so two versions can be read in one call.  ``--by-param`` also prints,
for the plain route, where the gradient's sensitivity lives: each
parameter's gradient norm at ``--dtype`` and in f32, how far the first
seed's one-ulp move shifts it, and the share of the squared norm held
by parameters that one ulp moves by more than half their norm (after
the readings above, in the same process).  ``--steps N`` also prints
the loss of N steps on the kernel route from step 0.  Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--seeds", default="7,8,9,10,11")
    p.add_argument("--by-param", action="store_true")
    p.add_argument("--batch", default="tones", choices=["tones", "files"])
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--root", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("train_step0_witness: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.ops.cuda import build
    from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                                make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    dt = torch.bfloat16 if args.dtype == "bf16" else None
    if args.batch == "files":
        with tempfile.TemporaryDirectory() as tmp:
            batch = device_batch(cs.file_batch(cs.write_file_fixtures(tmp)),
                                 "cuda")
    else:
        audio = torch.from_numpy(cs.tones(cs.BATCH, cs.UTT_SEC)).to("cuda")
        batch = device_batch(cs.train_batch(audio), "cuda")

    def step0():
        m = Model(Dimensions(), ModelConfig(), device="cuda", seed=0)
        opt, _ = make_optimizer(Config(), m)
        loss, gn, _ = make_train_step(m, opt, 0.0, dt)(
            batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        return float(loss), float(gn)

    def plain(rel=0.0, seed=0):
        undo = cs.plain_route()
        restore = cs.perturb_attention(rel, seed) if rel else (lambda: None)
        try:
            return step0()
        finally:
            restore()
            undo()

    lk, gk = step0()
    lp, gp = plain()
    rel = lambda r: [abs(r[0] - lp) / abs(lp), abs(r[1] - gp) / abs(gp)]
    eps = float(torch.finfo(dt or torch.float32).eps)
    out = {"root": root, "dtype": args.dtype, "batch": args.batch,
           "card": torch.cuda.get_device_name(0),
           "plain": [lp, gp], "kernel": rel((lk, gk)),
           "plain_again": rel(plain()), "ulp": {}, "fault": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        out["ulp"][seed] = rel(plain(eps, seed))
        out["fault"][seed] = rel(plain(cs.FAULT_REL[args.dtype], seed))
    print(json.dumps(out), flush=True)
    if args.steps:
        m = Model(Dimensions(), ModelConfig(), device="cuda", seed=0)
        opt, _ = make_optimizer(Config(), m)
        step = make_train_step(m, opt, 0.0, dt)
        g = torch.Generator(device="cuda").manual_seed(0)
        print(json.dumps({"losses": [float(step(batch, g)[0])
                                     for _ in range(args.steps)]}),
              flush=True)
        del m, opt, step
    if args.by_param:
        print(json.dumps(by_param(dt, plain_grads(cs, batch),
                                  int(args.seeds.split(",")[0]))),
              flush=True)
    return 0


def plain_grads(cs, batch):
    """``grads(dtype, rel, seed) -> {name: f32 gradient}``: step 0's
    gradient on the plain route, every attention output moved by
    ``rel`` of its magnitude in the direction ``seed`` draws."""
    import torch

    def grads(dt, rel=0.0, seed=0):
        undo = cs.plain_route()
        restore = cs.perturb_attention(rel, seed) if rel else (lambda: None)
        try:
            m, st = cs._train_fresh("bf16" if dt is not None else "f32")
            names, ps = zip(*m.named_parameters())
            loss, _js, _st = st.loss_fn(
                batch, torch.Generator(device="cuda").manual_seed(0))
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
            return {n: g.detach().float().flatten()
                    for n, g in zip(names, gs) if g is not None}
        finally:
            restore()
            undo()
    return grads


def by_param(dt, grads, seed: int) -> dict:
    """The plain route's gradient per parameter at ``dt`` against f32
    and against itself with every attention output moved one ulp."""
    import torch
    eps = float(torch.finfo(dt or torch.float32).eps)
    base, f32 = grads(dt), grads(None)
    moved = grads(dt, eps, seed)
    rows = [dict(name=n, norm=float(g.norm()), f32_norm=float(f32[n].norm()),
                 ulp_diff=float((moved[n] - g).norm()),
                 f32_diff=float((g - f32[n]).norm()))
            for n, g in base.items()]
    total = sum(r["norm"] ** 2 for r in rows)
    swung = sum(r["norm"] ** 2 for r in rows if r["ulp_diff"] > 0.5 * r["norm"])
    rows.sort(key=lambda r: -r["ulp_diff"])
    return {"by_param": rows[:12], "ulp_seed": seed, "params": len(rows),
            "swung_params": sum(r["ulp_diff"] > 0.5 * r["norm"] for r in rows),
            "swung_share_of_norm_sq": swung / total,
            "gnorm": total ** 0.5,
            "f32_gnorm": sum(r["f32_norm"] ** 2 for r in rows) ** 0.5}


if __name__ == "__main__":
    sys.exit(main())
