"""The modality Router over identical inputs, ``Router(*[x] * n_mod)``:
the CUDA kernel ``csrc/router.cu`` and its plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/router_kernel.py:fused_router_same``.
With every modality the same tensor, the stacked product collapses to x
times the sum of the weights' D-column slices, and the weighted sum of
the stack to x * sum_c(w_c).  A reduction far below the card's ridge
(about 3 operations per byte), so bytes bound it, and at decode widths
the serial steps of a CTA: one launch of about one CTA an SM, each
folding the weights into shared memory with 16-byte loads and holding
its rows in registers, every score of a row taken in one pass and
ended in one reduce-scatter across the warp (``csrc/router.cu``).
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


RT_WARPS = 4                     # warps of a CTA (csrc/router.cu)
FOLD_SMEM_MAX = 200 * 1024       # fold bytes a CTA holds (RT_FOLD_SMEM_MAX)


def supports(d: int, nt: int) -> bool:
    """The widths the kernel takes: any D, at least 2 types (the folded
    weights from L2 where shared memory does not hold them)."""
    return d >= 1 and nt >= 2


def launch_plan(n: int, d: int, nt: int, dtype) -> dict:
    """What ``asr_fused_router_same`` launches for (n, d) rows and nt
    types (``csrc/router.cu``): rows a CTA (1 up to 264 rows, 2 up to
    1056, else 4), the CTAs, the 16-byte vectors of a row a lane
    holds in registers (0: read again from L2), the types a pass (4, or
    8 past nt 4), whether the folded weights sit in each CTA's shared
    memory (else one fold launch into a workspace first: two launches)
    and the dynamic shared memory in bytes."""
    es = torch.empty((), dtype=dtype).element_size()
    epv = 16 // es
    rpc = 1 if n <= 264 else 2 if n <= 1056 else 4
    per = -(-(-(-d // epv)) // (32 * (RT_WARPS // rpc)))
    vpl = next((v for v in (1, 2, 4, 8) if per <= v), 0)
    fold = 2 * nt * d * es
    in_smem = fold <= FOLD_SMEM_MAX
    head = -(-4 * (RT_WARPS * 16 + RT_WARPS * 2 * nt) // 16) * 16
    return dict(rows_per_cta=rpc, ctas=-(-n // rpc), vpl=vpl,
                ntc=4 if nt <= 4 else 8, fold_in_smem=in_smem,
                launches=1 if in_smem else 2,
                smem=head + (fold if in_smem else 0))


def fused_router_same(x2, top_w, top_b, soft_w, soft_b, alpha, n_mod: int):
    """``Router(*[x] * n_mod)`` over the rows of x2 (N, D): the kernel on
    CUDA tensors (f32 or bf16, weights of x2's dtype, nt >= 2 types, any
    D: one launch, or two where the folded weights pass shared memory,
    ``launch_plan``), the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return router_same_plain(x2, top_w, top_b, soft_w, soft_b, alpha,
                                 n_mod)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_router_same: unsupported device {x2.device}")
    B.eval_only("fused_router_same", "models/gates.py Router._fused_ok",
                lambda: (x2, top_w, top_b, soft_w, soft_b, alpha))
    n, d = x2.shape
    nt = top_w.shape[0]
    ok = (x2.dim() == 2 and nt >= 2 and n_mod >= 1
          and top_w.shape == (nt, n_mod * d) and soft_w.shape == top_w.shape
          and top_b.shape == (nt,) and soft_b.shape == (nt,)
          and alpha.numel() == 1
          and all(t.dtype == x2.dtype and t.is_contiguous()
                  and t.device == x2.device
                  for t in (x2, top_w, top_b, soft_w, soft_b, alpha)))
    if not ok:
        raise ValueError(
            "fused_router_same kernel takes contiguous (N, D) x with (nt >= "
            "2, n_mod * D) weights, (nt,) biases and a 1-element alpha of "
            f"its dtype and device; got x {tuple(x2.shape)} {x2.dtype}, "
            f"top_w {tuple(top_w.shape)} {top_w.dtype}, n_mod {n_mod}")
    plan = launch_plan(n, d, nt, x2.dtype)
    es = x2.element_size()
    out = torch.empty_like(x2)
    vec = int(d % (16 // es) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, top_w, soft_w, out)))
    work = (None if plan["fold_in_smem"] else
            torch.empty(2 * nt * d, dtype=x2.dtype, device=x2.device))
    rc = B.function("asr_fused_router_same",
                    [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I,
                     B.I, B.I, B.I, B.P])(
        B.dtype_code(x2.dtype), x2.data_ptr(), top_w.data_ptr(),
        top_b.data_ptr(), soft_w.data_ptr(), soft_b.data_ptr(),
        alpha.data_ptr(), B.ptr(work), out.data_ptr(), n, d, nt, int(n_mod),
        vec, B.stream_of(x2))
    B.check(rc, "asr_fused_router_same")
    fused_router_same.launches += plan["launches"] if n else 0
    return out


fused_router_same.launches = 0
