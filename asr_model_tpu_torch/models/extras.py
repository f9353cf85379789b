"""The latent attention modules: ``create_attention_mask``,
``calculate_attention`` (SDPA with a q-temperature), ``Curiosity``
(self-attention blended per head with attention over an auxiliary
source), ``AdaptiveSpan`` (attention truncated to a learned span, the
temperature sharpened as the span shrinks) and ``MyelinatedLayer`` (the
older adaptive-depth ancestor of MSheath: node-importance gates and
stochastic layer jumps as a fixed-length masked scan).

No model path calls them; they are the JAX package's API surface
(``asr_model_tpu/models/extras.py``).  The JAX modules are einsum code
with no Pallas kernel, so these are plain PyTorch on every device and
never take the flash kernel.  Submodules and parameters carry the flax
tree's names (``weights.from_jax_params`` maps them).

``MyelinatedLayer`` draws its jump noise through ``jump_draws`` from the
generator of ``stochastic.mode`` (``stochastic.generator()``), the
counterpart of the JAX module's "jump" rng; with no generator the draws
are 1 (no jump is drawn), as in JAX without that rng.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.tlayers import Dense, param, uniform_
from asr_model_tpu_torch.ops.cuda.attention import NEG_INF


def create_attention_mask(batch_size: int, ctx: int, is_causal: bool = True,
                          padding_mask=None, device=None):
    """(B, 1, T, T) bool, True = masked out: the strict upper triangle
    when causal, and the keys ``padding_mask`` (B, T) leaves out."""
    if is_causal:
        m = torch.ones(ctx, ctx, dtype=torch.bool, device=device).triu(1)
    else:
        m = torch.zeros(ctx, ctx, dtype=torch.bool, device=device)
    mask = m[None, None].expand(batch_size, 1, ctx, ctx)
    if padding_mask is not None:
        pm = padding_mask.to(torch.bool)[:, None, None, :]
        mask = mask | ~pm
    return mask


def calculate_attention(q, k, v, mask=None, temperature: float = 1.0,
                        is_causal: bool = True):
    """softmax(q k^T / sqrt(hd)) v over (B, H, T, hd), q scaled by
    (1 / temperature)^0.5 first; ``mask`` (True = masked, logits set to
    NEG_INF) replaces the causal mask, which is aligned bottom-right.
    Returns ((B, Tq, H * hd), the weights)."""
    if temperature != 1.0 and temperature > 0:
        q = q * (1.0 / temperature) ** 0.5
    hd = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(mask, NEG_INF)
        is_causal = False
    if is_causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    a = torch.einsum("bhqk,bhkd->bhqd", w, v)
    b, h, t, d = a.shape
    return a.transpose(1, 2).reshape(b, t, h * d), w


class Curiosity(nn.Module):
    """Self-attention over x and attention of x's queries over the
    auxiliary source xa, blended per head by sigmoid(g)."""

    def __init__(self, d: int, h: int, use_bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.d, self.h = d, h
        self.qkv = Dense(d, 3 * d, use_bias=use_bias, **kw)
        self.qkv_aux = Dense(d, 3 * d, use_bias=use_bias, **kw)
        self.g = param(h, **kw)
        self.o = Dense(d, d, use_bias=use_bias, **kw)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.g.zero_()

    def _split(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.h, self.d // self.h).transpose(1, 2)

    def forward(self, x, xa, mask=None):
        dh = self.d // self.h
        q, k, v = map(self._split, self.qkv(x).chunk(3, dim=-1))
        _qa, ka, va = map(self._split, self.qkv_aux(xa).chunk(3, dim=-1))
        dots = torch.einsum("bhqd,bhkd->bhqk", q, k) / dh ** 0.5
        dots_aux = torch.einsum("bhqd,bhkd->bhqk", q, ka) / dh ** 0.5
        if mask is not None:
            dots = dots.masked_fill(mask, -9e15)
        h_main = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(dots, -1), v)
        h_aux = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(dots_aux, -1),
                             va)
        g = torch.sigmoid(self.g).reshape(1, -1, 1, 1)
        out = h_main * (1 - g) + h_aux * g
        b, hh, t, dd = out.shape
        return self.o(out.transpose(1, 2).reshape(b, t, hh * dd))


class AdaptiveSpan(nn.Module):
    """Causal self-attention of x's first ``min(span, max_dist)`` rows
    (heads of x itself as q, k and v), q's temperature sharpened as the
    learned ``span_scale`` shrinks.  Without ``span_len`` the span is
    the whole context: the span at the parameter's initial value (1.0),
    which is what the JAX module resolves at trace time."""

    def __init__(self, dims: int, head: int, max_dist: int = 512,
                 sharpen: bool = True, temp_scale: float = 0.01,
                 device=None, dtype=None):
        super().__init__()
        self.dims, self.head, self.max_dist = dims, head, max_dist
        self.sharpen, self.temp_scale = sharpen, temp_scale
        self.span_scale = nn.Parameter(
            torch.empty((), device=device, dtype=dtype), requires_grad=False)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.span_scale.fill_(1.0)

    def forward(self, x, span_len: int | None = None):
        b, ctx = x.shape[:2]
        hd = self.dims // self.head
        if span_len is None:
            span_len = min(int(ctx * 1.0), ctx)
        eff = min(span_len, self.max_dist, ctx)
        if eff == 0:
            return x.new_zeros(b, 0, self.dims), None
        q = x[:, :eff].reshape(b, eff, self.head, hd).transpose(1, 2)
        s = self.span_scale
        temperature = (1.0 + self.temp_scale * (1.0 - s) if self.sharpen
                       else 0.5 + self.temp_scale * s)
        qt = q * (1.0 / torch.clamp(temperature, min=1e-6)) ** 0.5
        return calculate_attention(qt, q, q, None, 1.0, is_causal=True)


def jump_draws(gen, steps: int, batch: int, device, dtype):
    """The jump noise of ``MyelinatedLayer``: (steps, batch) uniforms in
    [0, 1) from ``gen``, one row a scan step."""
    return torch.rand(steps, batch, generator=gen, device=device,
                      dtype=dtype)


def _ln(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class MyelinatedLayer(nn.Module):
    """Adaptive-depth stack: per slot a node-importance predictor gates
    a causal self-attention update (an adapter on even slots), a policy
    network drives stochastic layer jumps, and the working memory is an
    EMA of the pooled state; then a gated MLP.  A fixed-length scan of
    ``layerA`` steps whose slot index lives on the device: every
    decision is a ``torch.where``, as in the JAX module's ``lax.scan``."""

    def __init__(self, dims: int, head: int, layerA: int = 3,
                 sparsity_threshold: float = 0.1, max_dist: int = 512,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, L = dims, layerA
        self.dims, self.head, self.layerA = dims, head, layerA
        self.sparsity_threshold, self.max_dist = sparsity_threshold, max_dist
        n_ad = (L + 1) // 2
        self.imp_ln_scale = param(L, d, **kw)
        self.imp_ln_bias = param(L, d, **kw)
        self.imp_w = param(L, d, 1, **kw)
        self.imp_b = param(L, 1, **kw)
        self.ln_scale = param(L, d, **kw)
        self.ln_bias = param(L, d, **kw)
        self.gate_w = param(L, d, 1, **kw)
        self.gate_b = param(L, 1, **kw)
        self.adapt_w = param(n_ad, d, d, **kw)
        self.adapt_b = param(n_ad, d, **kw)
        self.policy1 = Dense(d, 128, **kw)
        self.policy2 = Dense(128, 3, **kw)
        self.jump_weights = param(3, **kw)
        self.mlp1 = Dense(d, 4 * d, **kw)
        self.mlp2 = Dense(4 * d, d, **kw)
        self.mlp_gate_w = param(d, 1, **kw)
        self.mlp_gate_b = param(1, **kw)
        self.mlp_ln_scale = param(d, **kw)
        self.mlp_ln_bias = param(d, **kw)
        self.working_memory = param(1, 1, d, **kw)
        self.memgate_w = param(d, 1, **kw)
        self.memgate_b = param(1, **kw)

    def reset_parameters(self, gen):
        """The reference's init: flax kernels bound by the product of
        every axis but the last, biases by the declared width."""
        d, L = self.dims, self.layerA
        with torch.no_grad():
            for t in (self.imp_ln_scale, self.ln_scale, self.mlp_ln_scale):
                t.fill_(1.0)
            for t in (self.imp_ln_bias, self.ln_bias, self.mlp_ln_bias,
                      self.working_memory):
                t.zero_()
            for w, b in ((self.imp_w, self.imp_b),
                         (self.gate_w, self.gate_b)):
                uniform_(w, L * d, gen)
                uniform_(b, d, gen)
            uniform_(self.adapt_w, self.adapt_w.shape[0] * d, gen)
            uniform_(self.adapt_b, d, gen)
            self.jump_weights.copy_(torch.tensor([0.1, 0.05, 0.01]))
            for w, b in ((self.mlp_gate_w, self.mlp_gate_b),
                         (self.memgate_w, self.memgate_b)):
                uniform_(w, d, gen)
                uniform_(b, d, gen)

    def forward(self, x, mask=None):
        L = self.layerA
        b, ctx, d = x.shape
        hd = d // self.head
        orig = x
        wm = self.working_memory.expand(b, 1, d)
        policy = torch.softmax(
            self.policy2(F.relu(self.policy1(x.mean(dim=1)))), dim=-1)
        gen = stochastic.generator()
        u_all = (None if gen is None
                 else jump_draws(gen, L, b, x.device, x.dtype))
        pick = lambda t, j: t.index_select(0, j.reshape(1))[0]
        i = torch.zeros((), dtype=torch.long, device=x.device)
        jl = torch.argmax(policy, dim=-1).max() + 1
        sw = pick(self.jump_weights, torch.clamp(jl - 1, 0, 2))
        for step in range(L):
            active = i < L
            idx = torch.clamp(i, max=L - 1)
            imp_in = _ln(x, pick(self.imp_ln_scale, idx),
                         pick(self.imp_ln_bias, idx))
            importance = torch.sigmoid(imp_in @ pick(self.imp_w, idx)
                                       + pick(self.imp_b, idx))
            node = (importance > self.sparsity_threshold).to(x.dtype)
            skip = (importance.mean() < 0.2) & (i > 0)
            norm_x = _ln(x, pick(self.ln_scale, idx), pick(self.ln_bias, idx))
            q = norm_x.reshape(b, ctx, self.head, hd).transpose(1, 2)
            attn, _ = calculate_attention(q, q, q, None, 1.0, is_causal=True)
            a_idx = idx // 2
            adapted = attn @ pick(self.adapt_w, a_idx) \
                + pick(self.adapt_b, a_idx)
            attn = torch.where(idx % 2 == 0, adapted, attn)
            gate = torch.sigmoid(norm_x @ pick(self.gate_w, idx)
                                 + pick(self.gate_b, idx))
            strong = importance.mean() > 0.3
            x_upd = x + torch.where(strong, gate * attn * node, 0.0)
            mem = x_upd.mean(dim=1, keepdim=True)
            mv = torch.sigmoid(mem @ self.memgate_w + self.memgate_b)
            wm_new = torch.where(strong, mv * wm + (1 - mv) * mem, wm)
            u = x.new_ones(b) if u_all is None else u_all[step]
            jump_prob = torch.where(i < L - 1, policy[:, 1], 0.0)
            should_jump = torch.any(u < jump_prob)
            i_jump = torch.clamp(i + jl, max=L - 1)
            x_jump = x_upd + sw * orig + (1 - sw) * wm_new
            x_next = torch.where(should_jump, x_jump, x_upd)
            i_next = torch.where(skip, i + 1,
                                 torch.where(should_jump, i_jump, i + 1))
            x_out = torch.where(skip, x, x_next)
            x = torch.where(active, x_out, x)
            wm = torch.where(active, wm_new, wm)
            i = torch.where(active, i_next, i)
        g = torch.sigmoid(x @ self.mlp_gate_w + self.mlp_gate_b)
        out = self.mlp2(F.gelu(self.mlp1(_ln(x, self.mlp_ln_scale,
                                             self.mlp_ln_bias))))
        return x + g * out
