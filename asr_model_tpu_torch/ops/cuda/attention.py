"""Scaled dot-product attention: the CUDA flash kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/attention_kernel.py:flash_attention``.
On the card every ``sdpa`` call of the port goes here, decode shapes
included (the TPU gate admitted only Tq, Tk >= 128).  The masking is the
JAX package's plain route (``attention._sdpa_xla``): masked logits are
-1e30, so a fully masked row is the uniform mean of V, and the causal
mask is aligned bottom-right.  At the encoder shape the kernel is bound
by operations (~500 per byte); this first version runs the products on
the CUDA cores in f32, one block per (batch * head, 64-query tile),
looping over 32-key tiles with the running max / sum in registers.
"""

from __future__ import annotations

import math

import torch

from asr_model_tpu_torch.ops.cuda import build as B

NEG_INF = -1e30


def attention_plain(q, k, v, causal: bool = False, kv_valid=None,
                    scale: float | None = None):
    """softmax(q k^T * scale, masked to -1e30) v over (B, H, T, hd)."""
    attention_plain.calls += 1
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
                      [B.I, B.P, B.P, B.P, B.P, B.P, B.I, B.I, B.I, B.I, B.I,
                       B.F, B.I, B.P])


def flash_attention(q, k, v, causal: bool = False, kv_valid=None,
                    scale: float | None = None):
    """(B, H, Tq, hd) x (B, H, Tk, hd) -> (B, H, Tq, hd); ``kv_valid``
    (B, Tk) bool.  The flash kernel on CUDA tensors (f32 or bf16,
    hd <= 128), the plain version on CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, kv_valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, tq, hd = q.shape
    tk = k.shape[2]
    ok = (q.dim() == 4 and k.shape == (b, h, tk, hd) and v.shape == k.shape
          and q.dtype == k.dtype == v.dtype and 1 <= hd <= 128 and tk >= 1
          and all(t.is_contiguous() and t.device == q.device
                  for t in (q, k, v)))
    if kv_valid is not None:
        ok = ok and (kv_valid.shape == (b, tk)
                     and kv_valid.dtype == torch.bool
                     and kv_valid.is_contiguous()
                     and kv_valid.device == q.device)
    if not ok:
        raise ValueError(
            "flash_attention kernel takes contiguous (B, H, T, hd<=128) "
            "q/k/v of one dtype on one device and a (B, Tk) bool mask; "
            f"got q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"{q.dtype}")
    code = B.dtype_code(q.dtype)
    out = torch.empty_like(q)
    rc = _launch()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   B.ptr(kv_valid), out.data_ptr(), b, h, tq, tk, hd,
                   float(scale), int(bool(causal)), B.stream_of(q))
    B.check(rc, "asr_flash_attention")
    flash_attention.launches += 1 if b * h * tq else 0
    return out


flash_attention.launches = 0
