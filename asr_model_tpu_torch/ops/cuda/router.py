"""The modality Router over identical inputs, ``Router(*[x] * n_mod)``:
the CUDA kernel ``csrc/router.cu`` and its plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/router_kernel.py:fused_router_same``.
With every modality the same tensor, the stacked product collapses to x
times the sum of the weights' D-column slices, and the weighted sum of
the stack to x * sum_c(w_c).  A reduction far below the card's ridge
(about 3 operations per byte), so bytes bound it: one launch, each block
folding the weights into shared memory and each warp routing one row.
"""

from __future__ import annotations

import torch

from asr_model_tpu_torch.ops.cuda import build as B


def router_same_plain(x2, top_w, top_b, soft_w, soft_b, alpha, n_mod: int):
    """x2 (N, D); top_w / soft_w (nt, n_mod * D) in torch (out, in)
    layout; top_b / soft_b (nt,); alpha the raw (1,) parameter.  The
    top-2 is the module's own (ties to the first occurrence, in rank
    order, as the kernel breaks them)."""
    from asr_model_tpu_torch.models.gates import _topk_hard  # imports us
    router_same_plain.calls += 1
    dt = x2.dtype
    ct = torch.promote_types(dt, torch.float32)
    d = x2.shape[-1]

    def folded(w):                  # summed in f32, rounded as stored
        w = w.to(ct)
        s = w[:, :d]
        for i in range(1, n_mod):
            s = s + w[:, i * d:(i + 1) * d]
        return s.to(dt).to(ct)

    xf = x2.to(ct)
    top = xf @ folded(top_w).t() + top_b.to(ct)
    soft = torch.softmax(xf @ folded(soft_w).t() + soft_b.to(ct), dim=-1)
    a = torch.sigmoid(alpha.to(ct).reshape(()))
    w = a * _topk_hard(top, 2) + (1.0 - a) * soft
    return (xf * w.sum(dim=-1, keepdim=True)).to(dt)


router_same_plain.calls = 0


def fused_router_same(x2, top_w, top_b, soft_w, soft_b, alpha, n_mod: int):
    """``Router(*[x] * n_mod)`` over the rows of x2 (N, D): the kernel on
    CUDA tensors (f32 or bf16, weights of x2's dtype, 2 <= nt <= 8,
    2 nt D <= 49152), the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return router_same_plain(x2, top_w, top_b, soft_w, soft_b, alpha,
                                 n_mod)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_router_same: unsupported device {x2.device}")
    n, d = x2.shape
    nt = top_w.shape[0]
    ok = (x2.dim() == 2 and 2 <= nt <= 8 and 2 * nt * d <= 49152
          and top_w.shape == (nt, n_mod * d) and soft_w.shape == top_w.shape
          and top_b.shape == (nt,) and soft_b.shape == (nt,)
          and alpha.numel() == 1
          and all(t.dtype == x2.dtype and t.is_contiguous()
                  and t.device == x2.device
                  for t in (x2, top_w, top_b, soft_w, soft_b, alpha)))
    if not ok:
        raise ValueError(
            "fused_router_same kernel takes contiguous (N, D) x with (nt, "
            "n_mod * D) weights, (nt,) biases and a 1-element alpha of its "
            f"dtype and device; got x {tuple(x2.shape)} {x2.dtype}, top_w "
            f"{tuple(top_w.shape)} {top_w.dtype}, n_mod {n_mod}")
    out = torch.empty_like(x2)
    rc = B.function("asr_fused_router_same",
                    [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I,
                     B.I, B.P])(
        B.dtype_code(x2.dtype), x2.data_ptr(), top_w.data_ptr(),
        top_b.data_ptr(), soft_w.data_ptr(), soft_b.data_ptr(),
        alpha.data_ptr(), out.data_ptr(), n, d, nt, int(n_mod),
        B.stream_of(x2))
    B.check(rc, "asr_fused_router_same")
    fused_router_same.launches += 1 if n else 0
    return out


fused_router_same.launches = 0
