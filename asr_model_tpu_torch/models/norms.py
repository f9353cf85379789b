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

The rest of the JAX registry's norms (``asr_model_tpu/models/norms.py``),
as PyTorch ops: ``LocalNorm`` (the fixed-mode local response norm),
``GlobalNorm``, ``LinearNorm``, ``RMSNorm``, ``AdaLN``,
``InstanceNorm1d`` and ``GroupNorm``.  Where the JAX module wraps a flax
layer, the port's module holds it under flax's automatic name
(``RMSNorm_0``, ``GroupNorm_0``, ``Dense_0``, ``LayerNorm_0``,
``BatchNorm_0``), so the parameter trees match.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.tlayers import Dense, param
from asr_model_tpu_torch.ops.cuda import abby as K
from asr_model_tpu_torch.parallel import context as pctx


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
        if pctx.batch_axis() is None:
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                              min=0.0)
        else:   # the whole sharded batch's statistics
            mean = pctx.global_mean(xf, axes)
            var = torch.clamp(pctx.global_mean(xf * xf, axes) - mean * mean,
                              min=0.0)
        prev = stochastic.batch_stats_of(self) or (self.running_mean,
                                                   self.running_var)
        m = self.momentum
        stochastic.record_batch_stats(
            self, m * prev[0] + (1 - m) * mean.detach(),
            m * prev[1] + (1 - m) * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean) * mul + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def _ct(x):
    """flax's statistics dtype: at least f32."""
    return torch.promote_types(x.dtype, torch.float32)


class LocalNorm(nn.Module):
    """The fixed-mode local response norm over the last axis: mode "1"
    the windowed mean of x^2, "2" the windowed max where it exceeds
    twice the mean, "3" the mean where ``confidence`` passes
    ``threshold`` and the max elsewhere; ``x / (alpha * div + k)^beta``.
    No parameters."""

    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 1.0, mode: str = "1",
                 threshold: float = 0.8):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.mode, self.threshold = mode, threshold

    def forward(self, x, confidence=None):
        if x.numel() == 0:
            return x
        div = x * x
        avg_d = window_reduce(div, self.size, "mean")
        if self.mode == "1":
            div = avg_d
        elif self.mode == "2":
            max_d = window_reduce(div, self.size, "max")
            cond = (max_d > 2.0 * avg_d).to(x.dtype)
            div = cond * max_d + (1 - cond) * avg_d
        elif self.mode == "3":
            max_d = window_reduce(div, self.size, "max")
            if confidence is None:
                div = avg_d
            else:
                conf = (confidence > self.threshold).to(x.dtype)[..., None]
                div = conf * avg_d + (1 - conf) * max_d
        return x / (div * self.alpha + self.k) ** self.beta


class GlobalNorm(nn.Module):
    """Global L2 rescale of a 4-D input with a learned affine and a
    residual: gamma * (x * nx) + beta + x, nx the L2 norm over axes 1
    and 2 over its mean along the last axis."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.gamma = param(1, 1, 1, dim, device=device, dtype=dtype)
        self.beta = param(1, 1, 1, dim, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.gamma.zero_()
            self.beta.zero_()

    def forward(self, x):
        gx = torch.sqrt(torch.sum(x * x, dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class XavierDense(Dense):
    """flax ``nn.Dense`` with ``xavier_uniform`` kernels (zero bias)."""

    def reset_parameters(self, gen):
        bound = math.sqrt(6.0 / (self.in_features + self.features))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=gen)
            if self.bias is not None:
                self.bias.zero_()


class LinearNorm(nn.Module):
    """A linear map used as a norm (xavier init, ``Dense_0``)."""

    def __init__(self, dims: int, use_bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.Dense_0 = XavierDense(dims, dims, use_bias=use_bias,
                                   device=device, dtype=dtype)

    def forward(self, x):
        return self.Dense_0(x)


class Scale(nn.Module):
    """The ``scale`` (and ``bias``) of a flax norm layer, as ``weight``
    (and ``bias``): ones and zeros at init."""

    def __init__(self, dims: int, use_bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.weight = param(dims, device=device, dtype=dtype)
        self.bias = (param(dims, device=device, dtype=dtype) if use_bias
                     else None)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()


def _affine(y, x, scale: Scale):
    y = y * scale.weight
    if scale.bias is not None:
        y = y + scale.bias
    return y.to(torch.promote_types(x.dtype, scale.weight.dtype))


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` (``RMSNorm_0``): x * rsqrt(mean(x^2) + eps) *
    scale, the statistics in at least f32."""

    def __init__(self, dims: int, eps: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.RMSNorm_0 = Scale(dims, use_bias=False, device=device,
                               dtype=dtype)

    def forward(self, x):
        xf = x.to(_ct(x))
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        return _affine(xf * torch.rsqrt(ms + self.eps), x, self.RMSNorm_0)


def fast_layer_norm(x, eps: float):
    """flax's LayerNorm statistics: the variance as E[x^2] - E[x]^2
    clipped at 0, in at least f32; no affine."""
    xf = x.to(_ct(x))
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps)


class AdaLN(nn.Module):
    """Condition-adaptive LayerNorm: a parameter-free LayerNorm (eps
    1e-6), and with a condition (B, D) ``(1 + gamma) * norm(x) + beta``
    where (gamma, beta) = Dense_1(silu(Dense_0(condition))), Dense_1
    zero at init.  ``conditioned=False`` (the registry's: its callers
    pass no condition) builds no parameters, as the flax module creates
    none without one."""

    def __init__(self, dims: int, conditioned: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.conditioned = conditioned
        if conditioned:
            kw = dict(device=device, dtype=dtype)
            self.Dense_0 = Dense(dims, dims, **kw)
            self.Dense_1 = Dense(dims, 2 * dims, **kw)

    def reset_parameters(self, gen):
        if self.conditioned:
            with torch.no_grad():
                self.Dense_1.weight.zero_()
                self.Dense_1.bias.zero_()

    def forward(self, x, condition=None):
        y = fast_layer_norm(x, 1e-6).to(x.dtype)
        if condition is None:
            return y
        if not self.conditioned:
            raise ValueError("AdaLN(conditioned=False) takes no condition")
        sb = self.Dense_1(F.silu(self.Dense_0(condition)))
        gamma, beta = torch.chunk(sb, 2, dim=-1)
        return y * (1 + gamma[:, None]) + beta[:, None]


class InstanceNorm1d(nn.Module):
    """Over time for (B, T, C): (x - mean) * rsqrt(var + eps), the
    statistics over axis -2, no affine."""

    def __init__(self, dims: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=-2, keepdim=True)
        var = ((x - mean) * (x - mean)).mean(dim=-2, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (``GroupNorm_0``, eps 1e-6): the channels
    (last axis) in ``num_groups`` groups, the statistics of a group over
    every axis but the first (batch) one, E[x^2] - E[x]^2 in at least
    f32; then the affine per channel."""

    def __init__(self, dims: int, num_groups: int = 1, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.GroupNorm_0 = Scale(dims, device=device, dtype=dtype)

    def forward(self, x):
        c, g = x.shape[-1], self.num_groups
        xf = x.to(_ct(x))
        xg = xf.reshape(*x.shape[:-1], g, c // g)
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        mean = xg.mean(dim=axes, keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=axes, keepdim=True)
                          - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(xf.shape)
        return _affine(y, x, self.GroupNorm_0)


class Wrapped(nn.Module):
    """A layer under the flax automatic name its JAX wrapper gives it
    (the registry's "layernorm" -> ``LayerNorm_0``, "batchnorm" ->
    ``BatchNorm_0``)."""

    def __init__(self, name: str, inner: nn.Module):
        super().__init__()
        self.inner_name = name
        self.add_module(name, inner)

    def forward(self, x, *a, **kw):
        return getattr(self, self.inner_name)(x, *a, **kw)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of channel-last (..., T, C) conv
    activations (the reference transposes around ``F.layer_norm``; here
    the channels are last already), under flax's name ``LayerNorm_0``."""

    def __init__(self, dims: int, eps: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dims, eps, device=device, dtype=dtype)

    def forward(self, x):
        return self.LayerNorm_0(x)


class Identity(nn.Module):
    """Returns its first argument; takes and ignores any other."""

    def forward(self, x, *a, **kw):
        return x
