"""Eval-mode AbbyNormal, router MLP included: the CUDA kernel
``csrc/abby.cu`` and its plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/abby_kernel.py:fused_abby``, and with
``fused_abby_tail`` (the tail launch alone, on the caller's logits) that
file's ``fused_abby_tail``.  Every
eval AbbyNormal call of the port on a CUDA tensor goes through the
kernel, at every row count (the TPU's size gate is gone).  The router
product (2 * N * D * D operations) bounds it.  One launch a call: a
thread-block cluster per 32-row tile, one CTA per 64-column slice of the
router (``launch_plan``), the bf16 product on the tensor cores; the
slices' partial logits meet in distributed shared memory, summed in a
fixed order, and each CTA runs the tail on its share of the tile's rows
(x read and written once).  Arithmetic after the router product is f32;
the output is cast back to x's dtype.

Past the width whose staged slices fit a block (D 59,392 in bf16, 92,160
in f32) the global route runs the same function in three launches, the
rows in device memory (``abby.cu:asr_abby_global``: the router product
with its SiLU into a scratch, the routes a warp a row, the tail a thread
per 8 channels; ``launch_plan``, ``fused_abby.routes["global"]``).  The
whole-call attention and the MLP take their norms through it past that
width too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from asr_model_tpu_torch.models.stochastic import hard_argmax
from asr_model_tpu_torch.ops.cuda import build as B


def window_size(d: int) -> int:
    """The AbbyNormal window: 5% of the channels, odd, at least 3."""
    size = max(3, int(d * 0.05))
    return size + 1 if size % 2 == 0 else size


def abby_tail(x, logits, size: int, alpha: float, k: float, beta: float):
    """The normalising tail on f32 values: x (N, D), logits (N, 3)."""
    d = x.shape[-1]
    div = x * x
    mean_abs = x.abs().mean(dim=-1, keepdim=True)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).sum(dim=-1, keepdim=True) / (d - 1)
    cv = torch.sqrt(var) / (mean_abs + 1e-6)
    d0, d1, d2 = hard_argmax(logits + cv).unbind(-1)
    pad = size // 2
    avg = F.avg_pool1d(div[:, None], size, stride=1, padding=pad,
                       count_include_pad=True)[:, 0]
    mx = F.max_pool1d(div[:, None], size, stride=1, padding=pad)[:, 0]
    div2 = torch.where(mx > 2.0 * avg, mx, avg)
    # decisions 0 and 2 both take the windowed mean (no confidence input)
    mix = d0[:, None] * avg + d1[:, None] * div2 + d2[:, None] * avg
    return x / torch.exp(beta * torch.log(mix * alpha + k))


CAST_ELEMS = 1 << 26      # weight elements the plain versions convert at once


def linear_t(a, w, ct):
    """``a @ w.to(ct).t()`` for a torch (out, in) weight w; a weight of more
    than CAST_ELEMS elements is converted a block of its rows at a time,
    so the plain versions hold no whole f32 copy of a weight past the
    widths whose kernels take the global routes (the same sums, column
    block by column block)."""
    if w.dtype == ct or w.numel() <= CAST_ELEMS:
        return a @ w.to(ct).t()
    rows = max(1, CAST_ELEMS // w.shape[1])
    return torch.cat([a @ w[i:i + rows].to(ct).t()
                      for i in range(0, w.shape[0], rows)], dim=-1)


def abby_values(x2, w1, b1, w2, b2, size: int, alpha: float, k: float,
                beta: float):
    """The eval AbbyNormal of x2 (N, D) as f32 (f64 for f64) values, not
    rounded: the fused kernels' shared helper.  w1 (D, D) and w2 (3, D)
    in torch (out, in) layout."""
    ct = torch.promote_types(x2.dtype, torch.float32)
    xf = x2.to(ct)
    h = F.silu(linear_t(xf, w1, ct) + b1.to(ct))
    h = h.to(x2.dtype).to(ct)             # rounded as the kernel rounds it
    logits = h @ w2.to(ct).t() + b2.to(ct)
    return abby_tail(xf, logits, size, alpha, k, beta)


def abby_plain(x2, w1, b1, w2, b2, size: int, alpha: float, k: float,
               beta: float):
    """x2 (N, D); w1 (D, D) and w2 (3, D) in torch (out, in) layout."""
    abby_plain.calls += 1
    return abby_values(x2, w1, b1, w2, b2, size, alpha, k, beta).to(x2.dtype)


abby_plain.calls = 0


ROWS = 32               # rows of a cluster's tile (abby.cu AB_ROWS)
STREAM_D = 2048         # past it the tile stays in device memory (WIDE)
MAX_TAPS = 103          # widest window of the attention calls' tensor-core
                        # route: window_size(2048)
W_RING = 8              # W1 chunks in flight past 16 (AB_WRING)
KCH = 512               # f32 x columns a CTA holds past STREAM_D (AB_KCH)
SMEM_MAX = 232448       # dynamic shared memory a block may use
GLOBAL_LAUNCHES = 3     # the global route (abby.cu asr_abby_global)


def launch_plan(n: int, d: int, dtype) -> dict:
    """What ``abby.cu`` launches for (n, d) rows of ``dtype``: the
    columns of the router each CTA owns (64, 128 past D 512, the
    64-column multiple of D / 8 past 1024), the CTAs of a cluster (one
    row tile), the tiles, the W1 chunks a bf16 pass holds (every chunk,
    or a ring of 8 past 16 chunks), the f32 rows held at once (the
    tile, half of it past D 1024, none past D 2048, where the rows stay
    in device memory: ``wide``, bf16 x's chunks in the ring beside W1's,
    f32 512 columns of x at a time) and the dynamic shared memory of a
    CTA in bytes (the formula of ``abby_smem_bytes``).  Where that passes
    a block's, the plan is the global route's: ``route`` "global", three
    launches, the (n, d) hidden and the n routes in device memory."""
    cols = 64 if d <= 512 else 128 if d <= 1024 else 64 * -(-d // 512)
    cluster = -(-d // cols)
    chunks = -(-d // 64)
    ld = 64 * chunks + 8
    slots = chunks if chunks <= 16 else W_RING
    if d > STREAM_D:
        smem = (2 * W_RING * 96 * 72 if dtype == torch.bfloat16
                else 4 * (16 * KCH + 32 * 65 + 16 * 64))
        smem += 4 * (4 * ROWS * 3 + 4 * cols + (ROWS + 8) * 3 + 2 * ROWS)
        if smem > SMEM_MAX:
            es = torch.empty((), dtype=dtype).element_size()
            return dict(route="global", launches=GLOBAL_LAUNCHES,
                        cluster_smem=smem, hidden_bytes=n * d * es,
                        route_bytes=4 * n)
        return dict(cols=cols, cluster=cluster, tiles=-(-n // ROWS),
                    rows=ROWS, w_slots=slots, f32_rows=0, wide=True,
                    smem=smem)
    f32_rows = ROWS if d <= 1024 else ROWS // 2
    if dtype == torch.bfloat16:
        wbuf = 64 * ld if chunks <= 16 else W_RING * 64 * 72
        smem = 2 * (ROWS * ld + wbuf) + 4 * 4 * ROWS * 3
    else:
        smem = 4 * (f32_rows * d + 32 * 65) + 4 * ROWS * cols
    smem += 4 * (4 * cols + (ROWS + 8) * 3 + 2 * ROWS)
    return dict(cols=cols, cluster=cluster, tiles=-(-n // ROWS),
                rows=ROWS, w_slots=slots, f32_rows=f32_rows, wide=False,
                smem=smem)


def _launch():
    return B.function("asr_fused_abby",
                      [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I,
                       B.F, B.F, B.F, B.P])


def is_global(d: int, dtype) -> bool:
    """Whether rows of width d take the global route."""
    return launch_plan(1, d, dtype).get("route") == "global"


def fused_abby(x2, w1, b1, w2, b2, size: int, alpha: float, k: float,
               beta: float):
    """The whole eval AbbyNormal over the rows of x2 (N, D): the kernel
    on CUDA tensors (f32 or bf16, weights in x2's dtype, any D >= 2:
    past the cluster plan's width the global route; N <= 65535 * 32, any
    window), the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return abby_plain(x2, w1, b1, w2, b2, size, alpha, k, beta)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_abby: unsupported device {x2.device}")
    B.eval_only("fused_abby", "models/norms.py AbbyNormal: "
                "stochastic.eval_route()", lambda: (x2, w1, b1, w2, b2))
    n, d = x2.shape
    ok = (x2.dim() == 2 and d >= 2 and n <= 65535 * ROWS and size >= 1
          and w1.shape == (d, d)
          and b1.shape == (d,) and w2.shape == (3, d) and b2.shape == (3,)
          and all(t.dtype == x2.dtype and t.is_contiguous()
                  and t.device == x2.device
                  for t in (x2, w1, b1, w2, b2)))
    if not ok:
        raise ValueError(
            "fused_abby kernel takes contiguous (N, D >= 2) x with (D, D), "
            "(D,), (3, D), (3,) weights of its dtype and device; "
            f"got x {tuple(x2.shape)} {x2.dtype}, w1 {tuple(w1.shape)} "
            f"{w1.dtype}")
    code = B.dtype_code(x2.dtype)
    out = torch.empty_like(x2)
    if is_global(d, x2.dtype):
        abby_global(x2, w1, b1, w2, b2, None, out, size, alpha, k, beta)
        n_l = GLOBAL_LAUNCHES if n else 0
        fused_abby.launches += n_l
        fused_abby.routes["global"] += n_l
        return out
    rc = _launch()(code, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, d,
                   int(size), float(alpha), float(k), float(beta),
                   B.stream_of(x2))
    B.check(rc, "asr_fused_abby")
    fused_abby.launches += 1 if n else 0      # abby_cluster_kernel
    return out


fused_abby.launches = 0
fused_abby.routes = {"global": 0}


def abby_global(x2, w1, b1, w2, b2, res, out, size: int, alpha: float,
                k: float, beta: float) -> None:
    """One global-route launch sequence into ``out`` (out = res + the norm
    where ``res`` is given), with its scratch; uncounted (the callers
    count)."""
    n, d = x2.shape
    ws, (hbuf, choice) = B.workspace(
        x2.device, [n * d * x2.element_size(), 4 * n])
    rc = B.function("asr_abby_global",
                    [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I,
                     B.I, B.I, B.F, B.F, B.F, B.P])(
        B.dtype_code(x2.dtype), x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), B.ptr(res), out.data_ptr(), hbuf,
        choice, n, d, int(size), float(alpha), float(k), float(beta),
        B.stream_of(x2))
    B.check(rc, "asr_abby_global")


# ------------------------------------------------ the tail on its own

TAIL_MAX_RPC = 32       # rows a CTA of the tail at most (abby.cu)
TAIL_SMEM_MAX = 96 * 1024   # bytes of rows a CTA copies to shared memory


def tail_launch_plan(n: int, d: int, dtype) -> dict:
    """What ``asr_fused_abby_tail`` launches for (n, d) rows
    (``abby.cu:abby_tail_tile``, one launch): rows a CTA (about one CTA
    an SM, at most 32), the CTAs, whether the rows are copied to shared
    memory (else read from L2) and the dynamic shared memory in bytes."""
    es = torch.empty((), dtype=dtype).element_size()
    rpc = 1 if n <= 132 else min(-(-n // 132), TAIL_MAX_RPC)
    in_smem = rpc * d * es <= TAIL_SMEM_MAX
    return dict(rows_per_cta=rpc, ctas=-(-n // rpc), rows_in_smem=in_smem,
                launches=1,
                smem=4 * TAIL_MAX_RPC + (rpc * d * es if in_smem else 0))


def abby_tail_plain(x2, logits, size: int, alpha: float, k: float,
                    beta: float):
    """The tail alone: x2 (N, D), logits (N, 3) from the caller's router."""
    abby_tail_plain.calls += 1
    ct = torch.promote_types(x2.dtype, torch.float32)
    return abby_tail(x2.to(ct), logits.to(ct), size, alpha, k,
                     beta).to(x2.dtype)


abby_tail_plain.calls = 0


def fused_abby_tail(x2, logits, size: int, alpha: float, k: float,
                    beta: float):
    """Replaces ``abby_kernel.py:fused_abby_tail``: the eval AbbyNormal
    tail of x2 (N, D) on precomputed router logits (N, 3).  The kernel is
    ``abby.cu``'s ``abby_tail_tile`` (one launch, rows a CTA in shared
    memory, a thread per 8 channels; ``tail_launch_plan``) on f32 logits,
    no bias, on CUDA tensors (f32 or bf16, any D); the plain version on
    CPU tensors."""
    if x2.device.type == "cpu":
        return abby_tail_plain(x2, logits, size, alpha, k, beta)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_abby_tail: unsupported device {x2.device}")
    B.eval_only("fused_abby_tail", "no caller on the model's paths",
                lambda: (x2, logits))
    n, d = x2.shape
    if not (x2.dim() == 2 and d >= 2 and size >= 1 and x2.is_contiguous()
            and logits.shape == (n, 3) and logits.device == x2.device):
        raise ValueError(
            "fused_abby_tail kernel takes contiguous (N, D >= 2) x and (N, "
            f"3) logits on its device; got x {tuple(x2.shape)}, logits "
            f"{tuple(logits.shape)} on {logits.device}")
    code = B.dtype_code(x2.dtype)
    lg = logits.to(torch.float32).contiguous()
    out = torch.empty_like(x2)
    vec = int(x2.data_ptr() % 16 == 0 and d * x2.element_size() % 16 == 0)
    rc = B.function("asr_fused_abby_tail",
                    [B.I, B.P, B.P, B.P, B.I, B.I, B.I, B.F, B.F, B.F, B.I,
                     B.P])(
        code, x2.data_ptr(), lg.data_ptr(), out.data_ptr(), n, d, int(size),
        float(alpha), float(k), float(beta), vec, B.stream_of(x2))
    B.check(rc, "asr_fused_abby_tail")
    fused_abby_tail.launches += 1 if n else 0
    return out


fused_abby_tail.launches = 0
