"""DIO's contour fix: the CUDA kernel ``csrc/dio.cu`` and its plain
PyTorch version.

Replaces the XLA ``lax.scan`` pair of
``asr_model_tpu/ops/dio.py:_fix_contour`` (no Pallas kernel there; the
C++ original is ``native/world.cpp:270-323``): jump kill, short-run
drop, then a forward and a backward scan over the frames, each frame
taking the band candidate nearest a running reference.  As PyTorch ops
on the card the scans are ~2 x nf steps of ~10 small launches each
(~20,000 launches for a 10 s batch); the kernel is one launch.  The
scans are serial recurrences over a few tens of KB, so latency bounds
the kernel, not bytes or operations: one CTA an utterance, the two
scans on two warps reading the candidates from device memory through
L1 (``csrc/dio.cu``).  It only compares and selects its inputs (and one
IEEE division a candidate), so it equals the plain version exactly.
"""

from __future__ import annotations

import torch

from asr_model_tpu_torch.ops.cuda import build as B


def dio_contour_plain(cand_f0, f0, vrm: int, allowed_range: float):
    """cand_f0 (B, nb, nf) band candidates (0 = none), f0 (B, nf) the
    best candidate a frame (0 = unvoiced) -> the fixed contour (B, nf):
    steps 1-2 vectorised, steps 3-4 one frame a step over the batch."""
    dio_contour_plain.calls += 1
    batch, nb, nf = cand_f0.shape
    # 1: kill jumps against the original left neighbour
    prev = torch.cat([f0[:, :1], f0[:, :-1]], dim=1)
    jump = (f0 - prev).abs() / torch.where(f0 > 0, f0, torch.ones_like(f0))
    s1 = torch.where((f0 > 0) & (prev > 0) & (jump > allowed_range),
                     torch.zeros_like(f0), f0)
    # 2: drop voiced runs shorter than vrm
    voiced = s1 > 0
    start = voiced & ~torch.cat([torch.zeros_like(voiced[:, :1]),
                                 voiced[:, :-1]], dim=1)
    seg = torch.where(voiced, torch.cumsum(start.long(), dim=1),
                      torch.zeros_like(start, dtype=torch.long))
    run = torch.zeros(batch, nf + 1, dtype=torch.long, device=f0.device)
    run.scatter_add_(1, seg, voiced.long())
    s2 = torch.where(voiced & (run.gather(1, seg) >= vrm), s1,
                     torch.zeros_like(s1))

    inf = torch.tensor(float("inf"), device=f0.device)

    def scan(order):
        ref = torch.zeros(batch, device=f0.device)
        active = torch.zeros(batch, dtype=torch.bool, device=f0.device)
        out = torch.zeros_like(s2)
        for i in order:
            v2 = s2[:, i]
            r = torch.clamp(ref, min=1e-9)
            v = cand_f0[:, :, i]
            err = torch.where(v > 0, (v - r[:, None]).abs() / r[:, None], inf)
            b = torch.argmin(err, dim=1, keepdim=True)
            cand = torch.where(err.gather(1, b)[:, 0] < allowed_range,
                               v.gather(1, b)[:, 0], torch.zeros_like(v2))
            extend = (v2 <= 0) & active & (cand > 0)
            zero = torch.zeros_like(v2)
            out[:, i] = torch.where(v2 > 0, v2,
                                    torch.where(extend, cand, zero))
            ref = torch.where(v2 > 0, v2, torch.where(extend, cand, ref))
            active = (v2 > 0) | extend
        return out

    fwd = scan(range(nf))
    bwd = scan(range(nf - 1, -1, -1))
    return torch.where(s2 > 0, s2, torch.where(bwd > 0, bwd, fwd))


dio_contour_plain.calls = 0


def dio_contour(cand_f0, f0, vrm: int, allowed_range: float):
    """The contour fix of ``dio_contour_plain``: the kernel on CUDA
    tensors (f32, one launch), the plain version on CPU tensors."""
    if f0.device.type == "cpu":
        return dio_contour_plain(cand_f0, f0, vrm, allowed_range)
    if f0.device.type != "cuda":
        raise ValueError(f"dio_contour: unsupported device {f0.device}")
    ok = (cand_f0.dim() == 3 and f0.dim() == 2
          and cand_f0.shape[0] == f0.shape[0]
          and cand_f0.shape[2] == f0.shape[1] and cand_f0.shape[1] >= 1
          and all(t.dtype == torch.float32 and t.is_contiguous()
                  and t.device == f0.device for t in (cand_f0, f0)))
    if not ok:
        raise ValueError(
            "dio_contour kernel takes contiguous f32 (B, nb, nf) candidates "
            f"and (B, nf) f0 on one device; got {tuple(cand_f0.shape)} "
            f"{cand_f0.dtype}, {tuple(f0.shape)} {f0.dtype}")
    batch, nb, nf = cand_f0.shape
    out = torch.empty_like(f0)
    work = torch.empty(batch, 2, nf, device=f0.device)
    rc = B.function("asr_dio_contour",
                    [B.P, B.P, B.P, B.P, B.I, B.I, B.I, B.I, B.F, B.P])(
        cand_f0.data_ptr(), f0.data_ptr(), out.data_ptr(), B.ptr(work),
        batch, nb, nf, int(vrm), float(allowed_range), B.stream_of(f0))
    B.check(rc, "asr_dio_contour")
    dio_contour.launches += 1 if batch else 0
    return out


dio_contour.launches = 0
