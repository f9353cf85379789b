"""Normalisation modules on channel-last tensors (..., D).

``AbbyNormal`` is the reference's learned-mode local response norm: a
router MLP picks, per row, among squared-activation denominators (the
windowed mean, or the windowed max where it exceeds twice the mean),
then ``x / (alpha * div + k)^beta``.  On the eval route (no train mode,
no generator: ``stochastic.eval_route``) every call is the whole program
of ``ops/cuda/abby.py``: the kernel on a CUDA tensor, its plain version
on a CPU tensor.  Otherwise it is the JAX package's XLA route in PyTorch
ops (``_train_forward``): the router logits plus the coefficient of
variation through the straight-through gumbel-softmax (noise from the
train generator, when there is one), and a std with a zero gradient
where the variance is 0.

``BatchNorm1d`` in train mode normalises with the batch statistics
(means over every axis but the channel one, in at least f32, the
variance E[x^2] - E[x]^2 clipped at 0, as flax computes it) and records
flax's running update, momentum 0.9 with the biased variance, in the
call's ``stochastic.mode`` record; the train step writes it to the
buffers.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.tlayers import Dense, param
from asr_model_tpu_torch.ops.cuda import abby as K


def window_reduce(x, size: int, kind: str):
    """Sliding mean (count including the zero padding) or max (-inf
    padding) of size ``size``, stride 1, over the last axis."""
    shape = x.shape
    x3 = x.reshape(-1, 1, shape[-1])
    if kind == "mean":
        y = F.avg_pool1d(x3, size, stride=1, padding=size // 2,
                         count_include_pad=True)
    else:
        y = F.max_pool1d(x3, size, stride=1, padding=size // 2)
    return y.reshape(shape)


class AbbyNormal(nn.Module):
    def __init__(self, dims: int, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 1.0, device=None, dtype=None):
        super().__init__()
        self.dims, self.alpha, self.beta, self.k = dims, alpha, beta, k
        self.router_in = Dense(dims, dims, device=device, dtype=dtype)
        self.router_out = Dense(dims, 3, device=device, dtype=dtype)

    def _train_forward(self, x):
        dt = torch.promote_types(x.dtype, self.router_in.weight.dtype)
        x = x.to(dt)
        h = F.linear(x, self.router_in.weight.to(dt),
                     self.router_in.bias.to(dt))
        logits = F.linear(F.silu(h), self.router_out.weight.to(dt),
                          self.router_out.bias.to(dt))

        mean_val = x.abs().mean(dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=1)
        nz = var > 0
        std_val = torch.where(nz, torch.sqrt(torch.where(
            nz, var, torch.ones_like(var))), torch.zeros_like(var))
        cv = std_val / (mean_val + 1e-6)
        gen = stochastic.generator()
        noise = (None if gen is None else
                 stochastic.sample_gumbel(logits.shape, gen, logits.dtype))
        dec = stochastic.gumbel_softmax(logits + cv, noise, 1.0, hard=True)
        size = K.window_size(x.shape[-1])
        div = x * x
        avg_d = window_reduce(div, size, "mean")
        max_d = window_reduce(div, size, "max")
        cond = (max_d > 2.0 * avg_d).to(x.dtype)
        div2 = cond * max_d + (1 - cond) * avg_d
        # decisions 0 and 2 both take the windowed mean (no confidence)
        mix = dec[..., 0:1] * avg_d + dec[..., 1:2] * div2 \
            + dec[..., 2:3] * avg_d
        return x / (mix * self.alpha + self.k) ** self.beta

    def forward(self, x):
        if x.numel() == 0:
            return x
        if not stochastic.eval_route():
            return self._train_forward(x)
        d = x.shape[-1]
        dt = x.dtype
        out = K.fused_abby(
            x.reshape(-1, d).contiguous(),
            self.router_in.weight.to(dt), self.router_in.bias.to(dt),
            self.router_out.weight.to(dt), self.router_out.bias.to(dt),
            K.window_size(d), self.alpha, self.k, self.beta)
        return out.reshape(x.shape)


class LayerNorm(nn.Module):
    """Channel-last LayerNorm with affine, eps 1e-5."""

    def __init__(self, dims: int, eps: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = param(dims, device=device, dtype=dtype)
        self.bias = param(dims, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


class BatchNorm1d(nn.Module):
    """BatchNorm over the channel (last) axis with the running
    statistics as buffers (eps 1e-5, flax momentum 0.9)."""

    momentum = 0.9

    def __init__(self, dims: int, eps: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = param(dims, device=device, dtype=dtype)
        self.bias = param(dims, device=device, dtype=dtype)
        self.register_buffer("running_mean", torch.empty(
            dims, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.empty(
            dims, device=device, dtype=dtype))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if stochastic.train_mode():
            return self._train_forward(x)
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * mul + self.bias

    def _train_forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=axes)
        var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
        prev = stochastic.batch_stats_of(self) or (self.running_mean,
                                                   self.running_var)
        m = self.momentum
        stochastic.record_batch_stats(
            self, m * prev[0] + (1 - m) * mean.detach(),
            m * prev[1] + (1 - m) * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * mul + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))
