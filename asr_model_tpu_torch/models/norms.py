"""Normalisation modules on channel-last tensors (..., D).

``AbbyNormal`` is the reference's learned-mode local response norm: a
router MLP picks, per row, among squared-activation denominators (the
windowed mean, or the windowed max where it exceeds twice the mean),
then ``x / (alpha * div + k)^beta``.  In eval every call is the whole
program of ``ops/cuda/abby.py``: the kernel on a CUDA tensor, its plain
version on a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models.tlayers import Dense, param
from asr_model_tpu_torch.ops.cuda import abby as K


class AbbyNormal(nn.Module):
    def __init__(self, dims: int, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 1.0, device=None, dtype=None):
        super().__init__()
        self.dims, self.alpha, self.beta, self.k = dims, alpha, beta, k
        self.router_in = Dense(dims, dims, device=device, dtype=dtype)
        self.router_out = Dense(dims, 3, device=device, dtype=dtype)

    def forward(self, x):
        if x.numel() == 0:
            return x
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
    """Eval BatchNorm over the channel (last) axis with the running
    statistics as buffers (eps 1e-5)."""

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
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * mul + self.bias
