"""Multi-head attention with per-component norms and signal-adaptive
rotary.

* q and kv projections each behind an ``n_type`` norm; heads split as
  (B, H, T, hd).
* q and k are scaled by hd^-0.25 before the rotary, and ``sdpa``
  applies the usual 1/sqrt(hd) on top (the reference's double scaling).
* rotary on q conditioned on the query source and on k conditioned on
  the kv source, then the per-head norm ``head_norm`` on both.
* self-attention when ``xa`` is None, cross-attention over ``xa``
  otherwise (``causal`` masks it too: the streaming decoder's d||e
  call, where x and xa are position-aligned), or over a precomputed
  K/V (``cached_kv``).
* the incremental decode's one-position pieces: ``q_step`` and
  ``kv_step`` (the same projection -> scale -> rotary at position
  ``pos`` -> head norm as the buffer call computes for that position)
  and ``attend_cached`` (``sdpa`` against the caches, then out_proj).

Every ``sdpa`` call runs the flash kernel on a CUDA tensor
(``ops/cuda/attention.py``; under autograd its forward, with the plain
masked softmax's backward) and the plain masked softmax on a CPU one.
With ``fused``, a whole call goes to ``ops/cuda/xattn.py`` instead
wherever the JAX package's PALLAS_XATTN gate would route it
(``Attention._fused_ok``: eval route only, no train mode or generator).

Tensor parallelism (``parallel/sharding.py:shard_params``, ``tp`` the
``model`` axis): q_proj and kv_proj hold this rank's heads' rows (kv_proj
its K rows and its V rows), out_proj the matching input columns
(row-parallel: its partial products summed over the axis, the bias added
once), so the attention runs on this rank's heads; the head norm's train
draws are this rank's heads' block of the whole draw.  Under the
sequence-parallel context (``parallel/seq.py:seq_sharding``) the cached
cross call attends over this rank's time block of the cached K/V, merged
over the axis (``seq_sharded_attention``), and no call takes a
whole-call kernel (as in the JAX package).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.norms import AbbyNormal
from asr_model_tpu_torch.models.registry import get_norm
from asr_model_tpu_torch.models.rotary import Rotary
from asr_model_tpu_torch.models.tlayers import Dense
from asr_model_tpu_torch.ops.cuda import attention as K
from asr_model_tpu_torch.ops.cuda import xattn as X
from asr_model_tpu_torch.ops.cuda.abby import window_size
from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.parallel import seq as SP

# the JAX gate's bounds on the K/V elements of a batch row: the cached
# call holds processed K/V tiles, the full one its whole kv-side chain
KV_LIMIT_CACHED = 4096 * 512
KV_LIMIT_FULL = 256 * 512


def split_heads(x: torch.Tensor, head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, head, d // head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def taylor_softmax(x: torch.Tensor, order: int = 2) -> torch.Tensor:
    """The Taylor-series softmax surrogate: 1 + sum_i x^i / i! up to
    ``order``, normalised over the last axis (no model path calls it)."""
    ta = torch.ones_like(x)
    for i in range(1, order + 1):
        ta = ta + x ** i / float(math.factorial(i))
    return ta / torch.sum(ta, dim=-1, keepdim=True)


def rbf_scores(q: torch.Tensor, k: torch.Tensor, rbf_sigma: float = 1.0,
               rbf_ratio: float = 0.3) -> torch.Tensor:
    """Blended dot-product and RBF attention logits over (B, H, T, hd):
    (1 - r) q k^T + r exp(-||q - k||^2 / (2 sigma^2)) (no model path
    calls it)."""
    dot = torch.einsum("bhqd,bhkd->bhqk", q, k)
    q2 = torch.sum(q * q, dim=-1)[..., :, None]
    k2 = torch.sum(k * k, dim=-1)[..., None, :]
    rbf = torch.exp(-(q2 + k2 - 2 * dot) / (2 * rbf_sigma ** 2))
    return (1 - rbf_ratio) * dot + rbf_ratio * rbf


def sdpa(q, k, v, causal: bool = False, kv_valid=None):
    """Scaled dot-product attention over (B, H, T, hd) with the 1/sqrt(hd)
    scale; ``kv_valid`` (B, Tk) bool.  Masked logits are -1e30 (a fully
    masked row averages V), the causal mask aligned bottom-right."""
    return K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, kv_valid=kv_valid,
                             scale=1.0 / math.sqrt(q.shape[-1]))


class Attention(nn.Module):
    tp = None

    def __init__(self, dims: int, head: int, n_type: str,
                 fused: bool = False, device=None, dtype=None):
        super().__init__()
        self.dims, self.head, self.fused = dims, head, fused
        kw = dict(device=device, dtype=dtype)
        self.q_norm = get_norm(n_type, dims, **kw)
        self.q_proj = Dense(dims, dims, **kw)
        self.kv_norm = get_norm(n_type, dims, **kw)
        self.kv_proj = Dense(dims, 2 * dims, **kw)
        self.out_proj = Dense(dims, dims, **kw)
        self.head_norm = get_norm(n_type, dims // head, **kw)
        self.rot = Rotary(dims, head, **kw)

    @property
    def scale(self) -> float:
        return (self.dims // self.head) ** -0.25

    @property
    def heads(self) -> int:
        """The heads this rank runs (all of them without ``tp``)."""
        return self.q_proj.weight.shape[0] // (self.dims // self.head)

    def _hn(self, t):
        with pctx.draw_blocks(1, self.tp):
            return self.head_norm(t)

    def _q(self, x):
        return split_heads(self.q_proj(self.q_norm(x)), self.heads)

    def _kv(self, x):
        k, v = torch.chunk(self.kv_proj(self.kv_norm(x)), 2, dim=-1)
        return split_heads(k, self.heads), split_heads(v, self.heads)

    def precompute_kv(self, xa):
        """Fully processed cross-attention K/V of a fixed source (kv
        projection, scale, rotary conditioned on the source, head norm);
        v stays raw.  Both come back contiguous, so the decode steps that
        read them copy nothing."""
        k, v = self._kv(xa)
        k = self.rot(k * self.scale, cond=xa, causal=False)
        return self._hn(k).contiguous(), v.contiguous()

    # ---- one position at a time (models/generate.py:greedy_decode_stream)

    def q_step(self, x_t, pos: int, causal: bool):
        """(B, 1, D) at position ``pos`` -> normed rotated query heads
        (B, H, 1, hd)."""
        q = self.rot(self._q(x_t) * self.scale, cond=x_t, causal=causal,
                     offset=pos)
        return self._hn(q)

    def kv_step(self, src_t, pos: int, causal: bool):
        """(B, 1, D) at position ``pos`` -> (normed rotated key heads,
        raw value heads), each (B, H, 1, hd)."""
        k, v = self._kv(src_t)
        k = self.rot(k * self.scale, cond=src_t, causal=causal, offset=pos)
        return self._hn(k), v

    def attend_cached(self, qn, kn, v, kv_valid=None):
        """Attention of processed query heads over processed K/V (a
        decode cache, masked by ``kv_valid``), then out_proj."""
        return self.out_proj(merge_heads(sdpa(qn, kn, v, causal=False,
                                              kv_valid=kv_valid)))

    # ---- the whole-call kernels (ops/cuda/xattn.py)

    def _fused_ok(self, x, kv_elems_per_row: int, kv_limit: int) -> bool:
        """The JAX package's PALLAS_XATTN gate (``Attention.
        _fused_call_eligible``): AbbyNormal norms, lane-aligned width and
        head width, decode-prefix sizes, bounded K/V per batch row."""
        return (self.fused and stochastic.eval_route() and self.tp is None
                and isinstance(self.q_norm, AbbyNormal)
                and self.dims % 128 == 0
                and (self.dims // self.head) % 128 == 0
                and x.dtype in (torch.bfloat16, torch.float32)
                and x.numel() <= 400_000 and kv_elems_per_row <= kv_limit)

    @staticmethod
    def _norm_w(mod, dt):
        return {"n_w1": mod.router_in.weight.to(dt),
                "n_b1": mod.router_in.bias.to(dt),
                "n_w2": mod.router_out.weight.to(dt),
                "n_b2": mod.router_out.bias.to(dt)}

    @staticmethod
    def _proj_w(mod, dt):
        return {"proj_w": mod.weight.to(dt), "proj_b": mod.bias.to(dt)}

    def fused_kw(self, dt, full: bool):
        """The whole-call kernels' weights (in dtype ``dt``) and options;
        ``full`` adds the kv side's."""
        kw = dict(wq=self._norm_w(self.q_norm, dt)
                  | self._proj_w(self.q_proj, dt))
        if full:
            kw["wkv"] = (self._norm_w(self.kv_norm, dt)
                         | self._proj_w(self.kv_proj, dt))
        return kw | dict(wh=self._norm_w(self.head_norm, dt),
                         wo=self._proj_w(self.out_proj, dt), head=self.head,
                         size_d=window_size(self.dims),
                         size_h=window_size(self.dims // self.head),
                         alpha=self.q_norm.alpha, k=self.q_norm.k,
                         beta=self.q_norm.beta)

    def forward(self, x, xa=None, causal: bool = False, kv_valid=None,
                cached_kv=None):
        if cached_kv is not None:
            kn, v = cached_kv
            sp = SP.active_seq_sharding()
            if sp is None and self._fused_ok(
                    x, kn.shape[1] * kn.shape[2] * kn.shape[3],
                    KV_LIMIT_CACHED):
                return X.fused_attn_cached(
                    x.contiguous(), kn.to(x.dtype).contiguous(),
                    v.to(x.dtype).contiguous(), kv_valid,
                    self.rot.freqs(False, torch.float32, x.device),
                    **self.fused_kw(x.dtype, full=False))
            q = self.rot(self._q(x) * self.scale, cond=x, causal=False)
            if sp is not None:
                a = SP.seq_sharded_attention(self._hn(q), kn, v, sp,
                                             kv_valid=kv_valid)
            else:
                a = sdpa(self._hn(q), kn, v, causal=False,
                         kv_valid=kv_valid)
            return self.out_proj(merge_heads(a))
        kv_src = xa if xa is not None else x
        if SP.active_seq_sharding() is None and self._fused_ok(
                x, kv_src.shape[1] * self.dims, KV_LIMIT_FULL):
            return X.fused_attn_full(
                x.contiguous(), kv_src.to(x.dtype).contiguous(), kv_valid,
                self.rot.freqs(causal, torch.float32, x.device),
                causal=causal, **self.fused_kw(x.dtype, full=True))
        k, v = self._kv(kv_src)
        q = self.rot(self._q(x) * self.scale, cond=x, causal=causal)
        k = self.rot(k * self.scale, cond=kv_src, causal=causal)
        a = sdpa(self._hn(q), self._hn(k), v, causal=causal,
                 kv_valid=kv_valid)
        return self.out_proj(merge_heads(a))
