"""Layers with torch-default initialisation, channel-last at their
boundaries.

Init bounds (the reference relies on torch defaults): Dense and Conv
kernels U(+-1/sqrt(fan_in)) with fan_in the product of every kernel
axis but the output one, biases U(+-1/sqrt(fan_in)) of the declared
input width, embeddings N(0, 1).  Every module draws from an explicit
``torch.Generator`` in ``reset_parameters(gen)``; parameter names are
the flax tree's with torch layouts (``weights.from_jax_params`` maps
them).  ``dwconv_same`` is the depthwise convolution with the JAX
package's kernel gradient (per-tap sums); ``dropout`` draws its mask
from the train-mode generator (``models/stochastic.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.parallel.mesh import gather, psum


def uniform_(t: torch.Tensor, fan_in: int, gen) -> torch.Tensor:
    bound = 1.0 / math.sqrt(max(int(fan_in), 1))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def normal_(t: torch.Tensor, gen) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, 1.0, generator=gen)


def param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=False)


class Dense(nn.Module):
    """y = x W^T + b; ``weight`` (out, in).  ``bias_fan_in`` overrides
    the bias bound's width where the reference declares one input width
    and feeds another (the modality router)."""

    # tensor parallelism (``parallel/sharding.py:shard_params``): the
    # axis this layer's weight is split over; a row-parallel layer holds
    # a block of the input columns, sums its partial products over the
    # axis and adds the bias once, after the sum
    tp = None
    tp_row = False

    def __init__(self, in_features: int, features: int, use_bias=True,
                 bias_fan_in: int | None = None, device=None, dtype=None):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.bias_fan_in = bias_fan_in or in_features
        self.weight = param(features, in_features, device=device,
                            dtype=dtype)
        self.bias = (param(features, device=device, dtype=dtype)
                     if use_bias else None)

    def reset_parameters(self, gen):
        uniform_(self.weight, self.in_features, gen)
        if self.bias is not None:
            uniform_(self.bias, self.bias_fan_in, gen)

    def forward(self, x):
        if self.tp_row:
            y = psum(F.linear(x, self.weight), self.tp)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight, self.bias)


class DWConvSame(torch.autograd.Function):
    """Stride-1 'SAME' depthwise convolution over (B, C, T) with an odd
    kernel (C, 1, K).  The backward is the JAX package's custom VJP
    (``tlayers.dwconv_same``): the input gradient is the same
    convolution with the kernel reversed, the kernel gradient a sum over
    batch and time per tap of the padded input times the cotangent."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv1d(x, weight, padding=weight.shape[-1] // 2,
                        groups=x.shape[1])

    @staticmethod
    def backward(ctx, ct):
        x, weight = ctx.saved_tensors
        k = weight.shape[-1]
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = F.conv1d(ct, weight.flip(-1), padding=k // 2,
                          groups=x.shape[1])
        if ctx.needs_input_grad[1]:
            t, lo = x.shape[-1], (k - 1) // 2
            xp = F.pad(x, (lo, k - 1 - lo))
            dk = torch.stack([(xp[..., r:r + t] * ct).sum(dim=(0, 2))
                              for r in range(k)], dim=-1)[:, None, :]
            dk = dk.to(weight.dtype)
        return dx, dk


def dwconv_same(x, weight):
    return DWConvSame.apply(x, weight)


def dropout(x, rate: float):
    """flax ``nn.Dropout``: in train mode, keep each element with
    probability 1 - rate (a uniform draw from the train generator below
    1 - rate) and scale it by 1 / (1 - rate); identity otherwise."""
    if not stochastic.train_mode() or rate == 0.0:
        return x
    gen = stochastic.generator()
    if gen is None:
        raise ValueError("dropout in train mode needs a generator "
                         "(Model.forward(..., gen=))")
    keep = 1.0 - rate
    mask = pctx.draw(x.shape, lambda s: torch.rand(
        s, generator=gen, device=x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Conv1d(nn.Module):
    """Stride-1 'SAME' 1-D convolution over channel-last (..., T, C)
    input; ``weight`` (out, in / groups, k), k odd.  groups == C is the
    depthwise case."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 groups: int = 1, device=None, dtype=None):
        super().__init__()
        assert kernel_size % 2 == 1, "SAME padding needs an odd kernel"
        self.in_features, self.features = in_features, features
        self.kernel_size, self.groups = kernel_size, groups
        self.weight = param(features, in_features // groups, kernel_size,
                            device=device, dtype=dtype)
        self.bias = param(features, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        fan_in = (self.in_features // self.groups) * self.kernel_size
        uniform_(self.weight, fan_in, gen)
        uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        xt = x.transpose(-1, -2)
        if (self.groups > 1 and self.groups == self.in_features
                and torch.is_grad_enabled() and self.weight.requires_grad):
            y = dwconv_same(xt, self.weight) + self.bias[:, None]
        else:
            y = F.conv1d(xt, self.weight, self.bias,
                         padding=self.kernel_size // 2, groups=self.groups)
        return y.transpose(-1, -2)


class Embed(nn.Module):
    """A token embedding; under tensor parallelism (``tp``) this rank
    holds a block of the vocabulary's rows, looks up the ids that fall
    in it and sums the lookups over the axis."""

    tp = None

    def __init__(self, num: int, features: int, device=None, dtype=None):
        super().__init__()
        self.weight = param(num, features, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        normal_(self.weight, gen)

    def forward(self, ids):
        if self.tp is None:
            return F.embedding(ids, self.weight)
        n = self.weight.shape[0]
        local = ids - self.tp.index * n
        mine = (local >= 0) & (local < n)
        e = F.embedding(torch.clamp(local, 0, n - 1), self.weight)
        return psum(e * mine[..., None].to(e.dtype), self.tp)

    def logits(self, x):
        """x @ weight^T over the whole vocabulary (the tied output head):
        the blocks' products gathered along the last axis."""
        return gather(x @ self.weight.t(), -1, self.tp)


def reset_all(module: nn.Module, gen) -> None:
    """Initialise every module of the tree in registration order; each
    ``reset_parameters(gen)`` sets its own direct parameters only."""
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None:
            fn(gen)
