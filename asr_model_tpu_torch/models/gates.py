"""Gating and routing: the modality ``Router``, the ``TGate`` mixture of
sigmoid gates inside the residual MLP, the MSheath jump-policy network
``MPNet``, and two modules no model path builds (the JAX package's API
surface): ``Gate`` (a top-2 hard and soft mixture of sigmoid gates) and
``OneShot`` (a cross-modal attention-bias head whose ``scale`` the train
loop's grad-norm controller adjusts).  All through plain PyTorch; with
``fused``, a Router call over one tensor repeated goes to
``ops/cuda/router.py`` wherever the JAX package's PALLAS_ROUTER gate
would route it (on the eval route only: no train mode or generator)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.tlayers import Dense, param
from asr_model_tpu_torch.ops.cuda import router as K


def _topk_hard(scores: torch.Tensor, num: int) -> torch.Tensor:
    """softmax of the top-``num`` values scattered to their indices,
    zeros elsewhere.  Ties go to the first occurrence, in rank order, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order):
    each rank is an argmax (first maximum) over what earlier ranks left."""
    masked = scores
    vals, hots = [], []
    for _ in range(num):
        idx = torch.argmax(masked, dim=-1, keepdim=True)
        vals.append(torch.gather(scores, -1, idx))
        hot = F.one_hot(idx[..., 0], scores.shape[-1]).to(torch.bool)
        hots.append(hot)
        masked = masked.masked_fill(hot, float("-inf"))
    soft = torch.softmax(torch.cat(vals, dim=-1), dim=-1)
    return sum(soft[..., i:i + 1] * hots[i].to(scores.dtype)
               for i in range(num))


class Router(nn.Module):
    """Stack the inputs on a trailing axis, weight them by
    sigmoid(alpha) * top2-hard(top) + (1 - sigmoid(alpha)) * softmax(soft)
    and sum.  The weights are shaped by the stacked width (dims *
    n_modalities); the bias bound uses dims * num_types."""

    def __init__(self, dims: int, num_types: int, n_mod: int,
                 fused: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dims, self.fused = dims, fused
        self.top = Dense(dims * n_mod, num_types,
                         bias_fan_in=dims * num_types, **kw)
        self.soft = Dense(dims * n_mod, num_types,
                          bias_fan_in=dims * num_types, **kw)
        self.alpha = param(1, **kw)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def _fused_ok(self, modalities) -> bool:
        """The JAX package's PALLAS_ROUTER gate (``Router.
        _fused_eligible``): every modality the same tensor, lane-aligned
        width equal to ``dims``, decode-prefix sizes."""
        x = modalities[0]
        return (self.fused and stochastic.eval_route()
                and all(m is x for m in modalities[1:])
                and x.dtype in (torch.bfloat16, torch.float32)
                and x.shape[-1] % 128 == 0 and x.numel() <= 400_000
                and x.shape[-1] == self.dims)

    def fused_args(self, x2, n_mod: int):
        """``fused_router_same``'s arguments for the rows x2 (N, D)."""
        dt = x2.dtype
        return (x2, self.top.weight.to(dt), self.top.bias.to(dt),
                self.soft.weight.to(dt), self.soft.bias.to(dt),
                self.alpha.to(dt), n_mod)

    def forward(self, *modalities):
        if self._fused_ok(modalities):
            x = modalities[0]
            out = K.fused_router_same(*self.fused_args(
                x.reshape(-1, self.dims).contiguous(), len(modalities)))
            return out.reshape(x.shape)
        stack = torch.stack(modalities, dim=-1)              # (b, c, d, n)
        flat = stack.reshape(*stack.shape[:-2], -1)
        top = self.top(flat)
        soft = torch.softmax(self.soft(flat), dim=-1)
        alpha = torch.sigmoid(self.alpha)
        weights = alpha * _topk_hard(top, 2) + (1 - alpha) * soft
        return torch.sum(stack * weights[..., None, :], dim=-1)


class TGate(nn.Module):
    """Softmax-weighted mixture of ``num_types`` sigmoid gates."""

    def __init__(self, dims: int, num_types: int = 3, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_types = num_types
        for i in range(num_types):
            self.add_module(f"ga{i}", Dense(dims, dims, **kw))
        self.cs = Dense(dims, num_types, **kw)

    def forward(self, x):
        ga = torch.stack([torch.sigmoid(getattr(self, f"ga{i}")(x))
                          for i in range(self.num_types)], dim=-1)
        types = torch.softmax(self.cs(x), dim=-1)
        return torch.sum(ga * types[..., None, :], dim=-1)


class MPNet(nn.Module):
    """Jump-policy network: pooled state -> softmax over {0..jump}."""

    def __init__(self, dims: int, jump: int = 2, device=None, dtype=None):
        super().__init__()
        self.fc1 = Dense(dims, 128, device=device, dtype=dtype)
        self.fc2 = Dense(128, jump + 1, device=device, dtype=dtype)

    def forward(self, pooled):
        return torch.softmax(self.fc2(F.silu(self.fc1(pooled))), dim=-1)


class Gate(nn.Module):
    """``num_types`` sigmoid gates mixed by sigmoid(alpha) * top2-hard(top)
    + (1 - sigmoid(alpha)) * softmax(features)."""

    def __init__(self, dims: int, num_types: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_types = num_types
        for i in range(num_types):
            self.add_module(f"gate{i}", Dense(dims, dims, **kw))
        self.features = Dense(dims, num_types, **kw)
        self.top = Dense(dims, num_types, **kw)
        self.alpha = param(1, **kw)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x, num: int = 2):
        gates = torch.stack([torch.sigmoid(getattr(self, f"gate{i}")(x))
                             for i in range(self.num_types)], dim=-1)
        feats = torch.softmax(self.features(x), dim=-1)
        alpha = torch.sigmoid(self.alpha)
        sel = alpha * _topk_hard(self.top(x), num) + (1 - alpha) * feats
        return torch.sum(gates * sel[..., None, :], dim=-1)


class OneShot(nn.Module):
    """Cross-modal attention-bias head: (B, H, L, K) logits q k^T * scale
    / sqrt(hd), q from x and k from xa.  ``scale`` (a float or a tensor)
    is the runtime value the grad-norm controller sets; without it the
    constructor's ``default_scale`` (1 / num_features when given, else
    ``scale``)."""

    def __init__(self, dims: int, head: int, scale: float = 0.3,
                 num_features: int | None = None, device=None, dtype=None):
        super().__init__()
        self.dims, self.head = dims, head
        self.scale, self.num_features = scale, num_features
        self.q = Dense(dims, dims, device=device, dtype=dtype)
        self.k = Dense(dims, dims, device=device, dtype=dtype)

    @property
    def default_scale(self) -> float:
        return 1.0 / self.num_features if self.num_features else self.scale

    def forward(self, x, xa, scale=None):
        hd = self.dims // self.head
        b, n = x.shape[:2]
        q = self.q(x).reshape(b, n, self.head, hd).transpose(1, 2)
        k = self.k(xa).reshape(b, xa.shape[1], self.head, hd).transpose(1, 2)
        s = self.default_scale if scale is None else scale
        return torch.einsum("bhld,bhkd->bhlk", q, k) * s / math.sqrt(hd)
