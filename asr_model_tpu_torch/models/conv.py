"""Convolutional audio feature encoder.

ConvLite: pointwise -> GLU -> depthwise (k=15) -> BatchNorm -> SiLU ->
pointwise -> dropout, residual. AudioEncoder: a per-modality stem
(``conv1`` for multi-channel spectrograms, ``conv2`` for mono tracks)
then ``layer`` x [act, weight-norm conv k3, LayerNorm, ConvLite, act,
depthwise conv k3, act, dropout], then + sinusoids. With ``norm``
(``ModelConfig.encoder_norm``) the ``n_type`` norm ``out_norm`` follows
the multi-channel stem and the stack, and ``local_norm`` (a LocalNorm)
the mono stem; with ``enc`` (``encoder_transformer``) a post-norm
transformer encoder layer (``TransformerEncoderLayer``) ends the stack.
Activations are channel-last (B, T, C); the convolutions and the encoder
layer are plain PyTorch (the JAX package leaves them to XLA). In train
mode (``stochastic.mode``) each slot is its own pass (BatchNorm's batch
statistics and running updates per modality, as the reference calls it)
and dropout draws from the train generator; in eval identical slots
encode once and slots of one length share one pass.
``process_feature(x, valid=, pe_override=)`` is one track's stem and
stack with the rows where ``valid`` (B, T) is False zeroed before every
padded convolution and ``pe_override`` in place of the sinusoids: the
sequence-parallel encoder's halo-extended block
(``parallel/seq.py:sp_encode``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.config import THETA
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.norms import BatchNorm1d, LayerNorm
from asr_model_tpu_torch.models.registry import get_activation, get_norm
from asr_model_tpu_torch.models.tlayers import (Conv1d, Dense, dropout,
                                               param, uniform_)
from asr_model_tpu_torch.ops.audio import sinusoids


class WeightNormConv1d(nn.Module):
    """Conv1d under weight norm (dim 0): w = g * v / ||v|| with the norm
    over (in, k) per output channel; ``v`` (out, in, k)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, device=None, dtype=None):
        super().__init__()
        self.in_features, self.kernel_size = in_features, kernel_size
        kw = dict(device=device, dtype=dtype)
        self.v = param(features, in_features, kernel_size, **kw)
        self.g = param(features, **kw)
        self.b = param(features, **kw)

    def reset_parameters(self, gen):
        fan_in = self.in_features * self.kernel_size
        uniform_(self.v, fan_in, gen)
        with torch.no_grad():
            self.g.copy_(torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2))))
        uniform_(self.b, fan_in, gen)

    def forward(self, x):
        vn = torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2), keepdim=True))
        w = self.g[:, None, None] * self.v / torch.clamp(vn, min=1e-12)
        y = F.conv1d(x.transpose(-1, -2), w, self.b,
                     padding=self.kernel_size // 2)
        return y.transpose(-1, -2)


def _mask(x, valid):
    """Zero the rows (B, T, C) where ``valid`` (B, T) is False."""
    return x if valid is None else x * valid[..., None].to(x.dtype)


def glu(x):
    a, b = torch.chunk(x, 2, dim=-1)
    return a * torch.sigmoid(b)


class ConvLite(nn.Module):
    def __init__(self, dims: int, kernel_size: int = 15,
                 dropout: float = 0.1, device=None, dtype=None):
        super().__init__()
        self.rate = dropout
        kw = dict(device=device, dtype=dtype)
        self.point1 = Conv1d(dims, 2 * dims, 1, **kw)
        self.depth = Conv1d(dims, dims, kernel_size, groups=dims, **kw)
        self.bn = BatchNorm1d(dims, **kw)
        self.point2 = Conv1d(dims, dims, 1, **kw)

    def forward(self, x, valid=None):
        y = _mask(glu(self.point1(x)), valid)
        y = F.silu(self.bn(self.depth(y)))
        return x + dropout(self.point2(y), self.rate)


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention`` without dropout or mask, its parameters
    in flax's layout: ``query`` / ``key`` / ``value`` kernels (D, H, hd)
    with (H, hd) biases, ``out`` (H, hd, D) with a (D,) bias; q scaled
    by 1 / sqrt(hd), the softmax over the keys."""

    def __init__(self, dims: int, head: int, device=None, dtype=None):
        super().__init__()
        hd = dims // head
        kw = dict(device=device, dtype=dtype)
        self.dims, self.head = dims, head
        for name in ("query", "key", "value"):
            self.add_module(name, _Proj((dims, head, hd), (head, hd), dims,
                                        **kw))
        self.out = _Proj((head, hd, dims), (dims,), dims, **kw)

    def forward(self, x):
        q, k, v = (torch.einsum("btd,dhe->bhte", x, p.kernel)
                   + p.bias[:, None] for p in (self.query, self.key,
                                                self.value))
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = w @ v                                       # (B, H, T, hd)
        return torch.einsum("bhte,hed->btd", o, self.out.kernel) \
            + self.out.bias


class _Proj(nn.Module):
    """A flax ``DenseGeneral`` of ``SelfAttention``: ``kernel`` and
    ``bias`` under their flax names and layout; the kernel uniform in
    +-1 / sqrt(D) (the port's own init), the bias zero."""

    def __init__(self, kshape, bshape, fan_in: int, device=None,
                 dtype=None):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = param(*kshape, device=device, dtype=dtype)
        self.bias = param(*bshape, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        uniform_(self.kernel, self.fan_in, gen)
        with torch.no_grad():
            self.bias.zero_()


class TransformerEncoderLayer(nn.Module):
    """The optional post-encoder layer (torch ``nn.TransformerEncoderLayer``
    defaults): x = LayerNorm(x + SelfAttention(x)), then
    LayerNorm(x + Dense(relu(Dense(x)))) with a 2048-wide hidden layer;
    the flax auto-names ``SelfAttention_0``, ``LayerNorm_0`` / ``_1``,
    ``Dense_0`` / ``_1``."""

    def __init__(self, dims: int, head: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.SelfAttention_0 = SelfAttention(dims, head, **kw)
        self.LayerNorm_0 = LayerNorm(dims, **kw)
        self.Dense_0 = Dense(dims, 2048, **kw)
        self.Dense_1 = Dense(2048, dims, **kw)
        self.LayerNorm_1 = LayerNorm(dims, **kw)

    def forward(self, x):
        x = self.LayerNorm_0(x + self.SelfAttention_0(x))
        h = self.Dense_1(F.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + h)


class AudioEncoder(nn.Module):
    """Per-modality feature encoder: (B, C, T) in (C = mels for a
    spectrogram, 1 for pitch / waveform), (B, T, dims) out."""

    def __init__(self, mels: int, dims: int, head: int, layer: int,
                 act: str, theta: float = THETA, dropout: float = 0.1,
                 n_type: str = "AbbyNormal", norm: bool = False,
                 enc: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.act = get_activation(act)
        self.theta, self.rate = theta, dropout
        self.layer, self.norm, self.enc = layer, norm, enc
        self.conv1 = Conv1d(mels, dims, 3, **kw)
        self.conv2 = Conv1d(1, dims, 3, **kw)
        if norm:
            self.out_norm = get_norm(n_type, dims, **kw)
            self.local_norm = get_norm("localnorm", dims, **kw)
        for i in range(layer):
            self.add_module(f"enc{i}_wn", WeightNormConv1d(dims, dims, 3,
                                                           **kw))
            self.add_module(f"enc{i}_ln", LayerNorm(dims, **kw))
            self.add_module(f"enc{i}_convlite",
                            ConvLite(dims, 15, dropout, **kw))
            self.add_module(f"enc{i}_dw", Conv1d(dims, dims, 3, groups=dims,
                                                 **kw))
        if enc:
            self.encoder_layer = TransformerEncoderLayer(dims, head, **kw)

    def stem(self, x, valid=None):
        x = x if x.dim() == 3 else x[None]
        x = _mask(x.transpose(-1, -2), valid)         # (B, T, C)
        if x.shape[-1] > 1:
            x = self.conv1(x)
            return self.out_norm(x) if self.norm else x
        x = self.conv2(x)
        return self.local_norm(x) if self.norm else x

    def stack(self, x, valid=None, pe_override=None):
        act = self.act
        for i in range(self.layer):
            x = _mask(act(x), valid)         # before the padded wn k3
            x = getattr(self, f"enc{i}_wn")(x)
            x = getattr(self, f"enc{i}_ln")(x)
            x = getattr(self, f"enc{i}_convlite")(x, valid)
            x = _mask(act(x), valid)         # before the padded dw k3
            x = getattr(self, f"enc{i}_dw")(x)
            x = dropout(act(x), self.rate)
        pe = pe_override if pe_override is not None else sinusoids(
            x.shape[1], x.shape[-1], self.theta, device=x.device)
        x = x + pe.to(x.dtype)
        if self.norm:
            x = self.out_norm(x)
        if self.enc:
            x = self.encoder_layer(x)
        return x

    def process_feature(self, x, valid=None, pe_override=None):
        """One (B, C, T) track -> (B, T, dims)."""
        return self.stack(self.stem(x, valid), valid, pe_override)

    def forward(self, xa: dict) -> dict:
        """Encode the a/b/c slots: identical slot tensors once, and every
        stem output of one time length through one batched stack pass
        (every op of the stack is row-local in eval)."""
        keys = [k for k in ("a", "b", "c") if xa.get(k) is not None]
        out = {k: v for k, v in xa.items() if k not in keys}
        if stochastic.train_mode():
            for k in keys:
                out[k] = self.stack(self.stem(xa[k]))
            return out
        groups: dict = {}
        for k in keys:
            groups.setdefault(id(xa[k]), []).append(k)
        by_t: dict = {}
        for g in groups.values():
            t = xa[g[0]]
            t = t if t.dim() == 3 else t[None]
            by_t.setdefault(t.shape[-1], []).append((g, t))
        for gs in by_t.values():
            stems = [self.stem(t) for _g, t in gs]
            enc = self.stack(torch.cat(stems, dim=0))
            ofs = 0
            for (g, _t), s in zip(gs, stems):
                e = enc[ofs:ofs + s.shape[0]]
                ofs += s.shape[0]
                for k in g:
                    out[k] = e
        return out
