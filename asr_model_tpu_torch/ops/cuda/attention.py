"""Scaled dot-product attention: the CUDA flash kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/attention_kernel.py:flash_attention``.
On the card every ``sdpa`` call of the port goes here, decode shapes
included (the TPU gate admitted only Tq, Tk >= 128).  The masking is the
JAX package's plain route (``attention._sdpa_xla``): masked logits are
-1e30, so a fully masked row is the uniform mean of V, and the causal
mask is aligned bottom-right.  bf16 runs on the tensor cores
(``mma.sync``, 64- or 80-query x 64-key tiles, a 3-4 stage cp.async
ring, P rounded to bf16 for the PV product as the Pallas kernel does;
head widths up to 256, past 128 in 64-query tiles);
when a call has too few (batch * head, query tile) blocks to fill the
card, the keys are split over ``splits`` blocks whose partials the last
one merges in the same launch (a workspace per call, tile counters per
device and stream).  f32 stays on the CUDA cores in full f32 (TF32 would
not hold the f32 route's 1e-4).

Head widths past 1024 (either dtype) take the global route
(``csrc/global_attn.cuh``): three launches through an f32 score matrix
(B, H, Tq, Tk) in device memory -- the masked scores, the row softmax in
place, then P (rounded to the storage type) times V -- with the same
masking (``launch_plan``; the route's own count is
``flash_attention.routes["global"]``).

Training: where autograd needs a gradient of a CUDA call, the call goes
through ``FlashTrain``, whose forward is this kernel and whose backward
recomputes the plain masked softmax and differentiates it, as the JAX
package's ``custom_vjp`` does around its Pallas forward
(``asr_model_tpu/models/attention.py:_sdpa_flash``; there is no
backward kernel there either).
"""

from __future__ import annotations

import functools
import math

import torch

from asr_model_tpu_torch.ops.cuda import build as B

NEG_INF = -1e30


def attention_plain(q, k, v, causal: bool = False, kv_valid=None,
                    scale: float | None = None):
    """softmax(q k^T * scale, masked to -1e30) v over (B, H, T, hd)."""
    attention_plain.calls += 1
    return attention_math(q, k, v, causal, kv_valid, scale)


def attention_math(q, k, v, causal: bool = False, kv_valid=None,
                   scale: float | None = None):
    """The plain version's math, uncounted (``FlashTrain``'s backward)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=q.device).tril(tk - tq)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    if kv_valid is not None:
        logits = torch.where(kv_valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


attention_plain.calls = 0


def _launch():
    return B.function("asr_flash_attention",
                      [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I,
                       B.I, B.I, B.I, B.F, B.I, B.I, B.P])


TILE = 64          # keys per tile of the bf16 kernel
TC_MAX_HD = 256    # the widest head of the tensor-core kernel; past it
MAX_HD = 1024      # flash_wide_kernel (CUDA cores, either dtype); past it
GLOBAL_LAUNCHES = 3   # the global route (csrc/global_attn.cuh)
MAX_SPLIT = 16
MIN_SPLIT_TILES = 4


def route(hd: int, dtype) -> str:
    """The kernel a call takes: "tc" (bf16 up to hd 256, the tensor
    cores), "f32" (f32 up to 256, the CUDA cores), "wide" (past 256,
    either dtype: ``flash_wide_kernel``) or "global" (past MAX_HD: the
    three launches of ``csrc/global_attn.cuh``)."""
    if hd > MAX_HD:
        return "global"
    if hd > TC_MAX_HD:
        return "wide"
    return "tc" if dtype == torch.bfloat16 else "f32"


def wide_rows(hd: int) -> int:
    """Query rows a block of ``flash_wide_kernel``: 64 (4 a thread) up to
    hd 512, else 16."""
    return 64 if hd <= 512 else 16


def wide_smem(hd: int) -> int:
    """Dynamic shared memory of ``flash_wide_kernel`` (``fa_wide_smem``):
    the query rows and a 16-key tile of K (padded rows) and V, the tile's
    weights."""
    rows = wide_rows(hd)
    return 4 * ((rows + 16) * (hd + 1) + 16 * hd + rows * 17)


def q_tile(tq: int, hd: int = 128) -> int:
    """Query rows per block of the bf16 kernel (``tc_warps`` in the
    source): 80 when Tq is 65..80 and hd <= 128, the decode width 65 in
    one tile; else 64."""
    return 80 if 64 < tq <= 80 and hd <= 128 else 64


def splits(bh: int, tq: int, tk: int, sms: int, hd: int = 128) -> int:
    """Key splits of the bf16 kernel: 1 when the (batch * head, query
    tile) blocks fill the card's ``sms`` SMs; else enough for the blocks
    an SM holds (two of 64 rows, one of 80), with at least 4 key tiles a
    split (a split's start and its share of the merge cost about as much
    as a few tiles, measured on the H100), at most 16."""
    bq = q_tile(tq, hd)
    blocks = bh * -(-tq // bq)
    nkt = -(-tk // TILE)
    if blocks >= sms:
        return 1
    per_sm = 2 if bq == 64 and hd <= 128 else 1
    n = max(1, min(MAX_SPLIT, nkt // MIN_SPLIT_TILES,
                   -(-per_sm * sms // blocks)))
    return -(-nkt // -(-nkt // n))      # no split left without a tile


def launch_plan(b: int, h: int, tq: int, tk: int, hd: int, dtype,
                sms: int = 132) -> dict:
    """What a call launches: its ``route``, the kernel launches, the key
    splits of the bf16 tensor-core kernel and, on the global route, the
    bytes of its f32 score matrix."""
    r = route(hd, dtype)
    if r == "global":
        return dict(route=r, launches=GLOBAL_LAUNCHES, splits=1,
                    scores_bytes=4 * b * h * tq * tk)
    return dict(route=r, launches=1, splits=(
        splits(b * h, tq, tk, sms, hd) if r == "tc" else 1))


_COUNTERS: dict = {}


def _counters(device, stream: int, n: int):
    """Zeroed tile counters of the split merge, grown as needed (the
    kernel leaves them zero).  One buffer per (device, stream): calls on
    one stream run in order and may share it; calls on two streams at
    once must not."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class FlashTrain(torch.autograd.Function):
    """Flash forward (one counted launch), plain-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_valid, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, kv_valid, scale)
        return _flash(q, k, v, causal, kv_valid, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in
                   zip((q, k, v), ctx.needs_input_grad[:3])]
            out = attention_math(*qkv, *ctx.args)
            wrt = [t for t in qkv if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in qkv) + (None, None, None)


def flash_attention(q, k, v, causal: bool = False, kv_valid=None,
                    scale: float | None = None):
    """(B, H, Tq, hd) x (B, H, Tk, hd) -> (B, H, Tq, hd); ``kv_valid``
    (B, Tk) bool.  The flash kernel on CUDA tensors (f32 or bf16; past
    hd 256 ``flash_wide_kernel``, ``wide_rows`` query rows a block on the
    CUDA cores; past 1024 the global route), on the current stream, the
    plain version on CPU tensors.
    The split merge's tile counters are kept per stream, so calls on
    two streams may run at once."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, kv_valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashTrain.apply(q, k, v, causal, kv_valid, scale)
    return _flash(q, k, v, causal, kv_valid, scale)


def _flash(q, k, v, causal, kv_valid, scale):
    """One call of the kernel (its launches counted)."""
    b, h, tq, hd = q.shape
    tk = k.shape[2]
    # the global route's grid: (key tiles, query tiles, B * H)
    grid_ok = hd <= MAX_HD or (b * h <= 65535 and -(-tq // 16) <= 65535)
    ok = (q.dim() == 4 and k.shape == (b, h, tk, hd) and v.shape == k.shape
          and q.dtype == k.dtype == v.dtype and hd >= 1 and grid_ok
          and tk >= 1
          and all(t.is_contiguous() and t.device == q.device
                  for t in (q, k, v)))
    if kv_valid is not None:
        ok = ok and (kv_valid.shape == (b, tk)
                     and kv_valid.dtype == torch.bool
                     and kv_valid.is_contiguous()
                     and kv_valid.device == q.device)
    if not ok:
        raise ValueError(
            "flash_attention kernel takes contiguous "
            "(B, H, T, hd) (past hd 1024: B * H <= 65535) "
            "q/k/v of one dtype on one device and a (B, Tk) bool mask; "
            f"got q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"{q.dtype}")
    code = B.dtype_code(q.dtype)
    out = torch.empty_like(q)
    stream = B.stream_of(q)
    if route(hd, q.dtype) == "global":
        ws, (scores,) = B.workspace(q.device, [4 * b * h * tq * tk])
        rc = B.function("asr_flash_attention_global",
                        [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I,
                         B.I, B.I, B.F, B.I, B.P])(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), B.ptr(kv_valid),
            out.data_ptr(), scores, b, h, tq, tk, hd, float(scale),
            int(bool(causal)), stream)
        B.check(rc, "asr_flash_attention_global")
        n = GLOBAL_LAUNCHES if b * h * tq else 0
        flash_attention.launches += n
        flash_attention.routes["global"] += n
        return out
    nsplit, part_o, part_ml, counters, ws = 1, None, None, None, None
    if code == 1 and hd <= TC_MAX_HD:
        nsplit = splits(b * h, tq, tk, _sm_count(q.device.index or 0), hd)
    if nsplit > 1:
        bq = q_tile(tq, hd)
        tiles = b * h * -(-tq // bq)
        hdp = 64 if hd <= 64 else 128 if hd <= 128 else 256
        ws, (part_o, part_ml) = B.workspace(
            q.device, [4 * tiles * nsplit * bq * hdp,
                       4 * tiles * nsplit * bq * 2])
        counters = _counters(q.device, stream, tiles).data_ptr()
    rc = _launch()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   B.ptr(kv_valid), out.data_ptr(), part_o, part_ml,
                   counters, b, h, tq, tk, hd,
                   float(scale), int(bool(causal)), nsplit, stream)
    B.check(rc, "asr_flash_attention")
    flash_attention.launches += 1 if b * h * tq else 0
    return out


flash_attention.launches = 0
flash_attention.routes = {"global": 0}
