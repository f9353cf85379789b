"""MSheath eval layer-slot recurrence: the CUDA kernels
``csrc/sheath.cu`` and their plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/sheath_kernel.py:fused_sheath_scan``.
At encoder length the per-slot row products are bound by operations;
every slot also needs two reductions over all rows (the per-batch
masked mean for the working memory, the global masked mean of ion for
the forced skip) before the next slot can start.  The card runs it as
a fixed sequence of launches per scan step that read the slot index
and the step's action from device memory, so the host never waits;
the reductions read the validity mask directly instead of the TPU
program's pooling matrices.  All arithmetic is f32; x comes back in its
own dtype.
"""

from __future__ import annotations

import math

import torch

from asr_model_tpu_torch.models.stochastic import ste_threshold
from asr_model_tpu_torch.ops.cuda import build as B
from asr_model_tpu_torch.utils import l2norm

# the per-slot stacks, trailing singleton axes squeezed, as f32
WEIGHT_NAMES = ("ln_scale", "ln_bias", "gate_w", "gate_b", "mkey", "mval",
                "vmlp1_w", "vmlp1_b", "vmlp2_w", "vmlp2_b", "vcat_w",
                "vcat_b", "adapt_w", "adapt_b", "memgate_w", "memgate_b")


def sheath_scan_plain(x2, batch: int, valid, mem0, sampled, jump_s,
                      weights: dict, L: int, thresh: float):
    """x2 (N, D) with N = batch * C rows; valid (batch, C) bool or None;
    mem0 (D,); sampled: the caller's argmax action; jump_s (3,);
    weights: ``WEIGHT_NAMES`` in f32.  Returns (x (N, D) in x2's dtype,
    actions (L,) int32, jstat (3,) int32)."""
    sheath_scan_plain.calls += 1
    w = weights
    n, d = x2.shape
    c = n // batch
    ct = torch.promote_types(x2.dtype, torch.float32)
    x0 = x2.to(ct)
    x = x0
    m = (torch.ones(batch, c, device=x2.device, dtype=ct) if valid is None
         else valid.to(ct))
    n_b = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    n_all = max(float(m.sum()), 1.0)
    mem_w = mem0.to(ct).reshape(1, d).expand(batch, d)
    sampled = int(sampled)
    i, actions, jstat = 0, [], [0, 0, 0]
    for _step in range(L):
        if i >= L:
            actions.append(0)
            continue
        logits = l2norm(x) @ l2norm(w["mkey"][i]).t() / math.sqrt(d)
        mem_score = torch.softmax(logits, dim=-1) @ w["mval"][i]
        h = torch.nn.functional.silu(x @ w["vmlp1_w"][i] + w["vmlp1_b"][i])
        mlp_score = h @ w["vmlp2_w"][i] + w["vmlp2_b"][i]
        x_val = (mem_score * w["vcat_w"][i, 0] + mlp_score * w["vcat_w"][i, 1]
                 + w["vcat_b"][i])
        ion = ste_threshold(x_val, thresh)[:, None]
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
        px = (x - mu) * torch.rsqrt(var + 1e-5) * w["ln_scale"][i] \
            + w["ln_bias"][i]
        apx = (px @ w["adapt_w"][i // 2] + w["adapt_b"][i // 2]
               if i % 2 == 0 else px)
        g = torch.sigmoid(px @ w["gate_w"][i] + w["gate_b"][i])[:, None]
        x_new = x + g * (apx * ion)
        mem = (x_new.reshape(batch, c, d) * m[..., None]).sum(dim=1) / n_b
        mem_v = torch.sigmoid(mem @ w["memgate_w"] + w["memgate_b"])[:, None]
        mem_w = mem_v * mem_w + (1.0 - mem_v) * mem
        potential = float((ion.reshape(batch, c) * m).sum()) / n_all
        last = i >= L - 1
        action = 0 if last else (1 if potential < 0.1 else sampled)
        if action > 0:
            jw = float(jump_s[min(max(action - 1, 0), 2)])
            rows = mem_w.repeat_interleave(c, dim=0)
            x_new = x_new + (jw * x0 + (1.0 - jw) * rows)
            i = min(i + action + 1, L)
        else:
            i += 1
        x = x_new
        actions.append(action)
        jstat[action] += batch
    return (x.to(x2.dtype),
            torch.tensor(actions, dtype=torch.int32, device=x2.device),
            torch.tensor(jstat, dtype=torch.int32, device=x2.device))


sheath_scan_plain.calls = 0


def _launch():
    return B.function("asr_fused_sheath_scan",
                      [B.I] + [B.P] * 30 + [B.I] * 7 + [B.F, B.P])


def fused_sheath_scan(x2, batch: int, valid, mem0, sampled, jump_s,
                      weights: dict, L: int, thresh: float):
    """The MSheath eval scan over x2 (N = batch * C rows, D): the kernel
    sequence on CUDA tensors (x2 f32 or bf16; ``sampled`` a device int32
    scalar; mem0, jump_s and the weights f32), the plain version on CPU
    tensors.  Returns (x, actions (L,) int32, jstat (3,) int32)."""
    if x2.device.type == "cpu":
        return sheath_scan_plain(x2, batch, valid, mem0, sampled, jump_s,
                                 weights, L, thresh)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_sheath_scan: unsupported device {x2.device}")
    n, d = x2.shape
    w = weights
    m_keys = w["mkey"].shape[1]
    d2 = w["vmlp1_w"].shape[-1]
    c = n // batch if batch else 0
    shapes = {"ln_scale": (L, d), "ln_bias": (L, d), "gate_w": (L, d),
              "gate_b": (L,), "mkey": (L, m_keys, d), "mval": (L, m_keys),
              "vmlp1_w": (L, d, d2), "vmlp1_b": (L, d2), "vmlp2_w": (L, d2),
              "vmlp2_b": (L,), "vcat_w": (L, 2), "vcat_b": (L,),
              "adapt_w": ((L + 1) // 2, d, d), "adapt_b": ((L + 1) // 2, d),
              "memgate_w": (d,), "memgate_b": (1,)}
    f32 = [mem0, jump_s] + [w[k] for k in WEIGHT_NAMES]
    ok = (x2.dim() == 2 and 1 <= batch <= 64 and c * batch == n
          and x2.is_contiguous() and d <= 1024 and m_keys >= 1
          and all(tuple(w[k].shape) == s for k, s in shapes.items())
          and mem0.shape == (d,) and jump_s.shape == (3,)
          and all(t.dtype == torch.float32 and t.is_contiguous()
                  and t.device == x2.device for t in f32)
          and sampled.dtype == torch.int32 and sampled.numel() == 1
          and sampled.device == x2.device)
    if valid is not None:
        ok = ok and (valid.shape == (batch, c) and valid.dtype == torch.bool
                     and valid.is_contiguous()
                     and valid.device == x2.device)
    if not ok:
        raise ValueError(
            "fused_sheath_scan kernel takes contiguous (batch * C, D<=1024) "
            "x, a (batch<=64, C) bool mask, an int32 device scalar action "
            "and the f32 per-slot stacks of WEIGHT_NAMES; got x "
            f"{tuple(x2.shape)} {x2.dtype}, batch {batch}")
    code = B.dtype_code(x2.dtype)
    dev = x2.device
    out = torch.empty_like(x2)
    xs = torch.empty(n, d, device=dev, dtype=torch.float32)
    ion = torch.empty(n, device=dev, dtype=torch.float32)
    mem = torch.empty(batch, d, device=dev, dtype=torch.float32)
    mem_w = torch.empty(batch, d, device=dev, dtype=torch.float32)
    ctl = torch.empty(3, device=dev, dtype=torch.int32)
    jump_w = torch.empty(1, device=dev, dtype=torch.float32)
    actions = torch.empty(L, device=dev, dtype=torch.int32)
    jstat = torch.empty(3, device=dev, dtype=torch.int32)
    rc = _launch()(
        code, x2.data_ptr(), out.data_ptr(), B.ptr(valid), mem0.data_ptr(),
        sampled.data_ptr(), jump_s.data_ptr(),
        *[w[k].data_ptr() for k in WEIGHT_NAMES],
        xs.data_ptr(), ion.data_ptr(), mem.data_ptr(), mem_w.data_ptr(),
        ctl.data_ptr(), jump_w.data_ptr(), actions.data_ptr(),
        jstat.data_ptr(), n, batch, c, d, d2, m_keys, L, float(thresh),
        B.stream_of(x2))
    B.check(rc, "asr_fused_sheath_scan")
    # sheath_init, then rows, mem, ctl and jump per step, sheath_finish
    fused_sheath_scan.launches += 2 + 4 * L
    return out, actions, jstat


fused_sheath_scan.launches = 0
