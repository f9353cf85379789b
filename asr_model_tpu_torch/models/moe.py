"""Mixture-of-experts MLP: the counterpart of ``asr_model_tpu/models/moe.py``.

Each token's top-k experts (a router ``Dense(D, E)``, its softmax in
f32, ties to the lower expert index as ``jax.lax.top_k`` breaks them)
each get a slot in a per-example (E, C) buffer: the assignments are
taken token-major (all of token t's choices before token t + 1's) and
counted per expert with a cumulative sum over the example, and those
past the capacity C drop.  C depends on the length the layer sees
(``expert_capacity``), so a decode bucket's width decides it, and in a
right-padded batch the real tokens claim their slots before the pads.
Dispatch copies each kept token into its slot, the experts (stacked
(E, ...) parameters in flax's layout: ``experts.w_in.kernel`` (E, D, H),
``experts.w_out.kernel`` (E, H, D)) run as two batched products over
every slot, and combine sums each token's kept slots weighted by its
renormalised gate values (in at least f32, rounded once to x's dtype).
The JAX package writes dispatch and combine as one-hot products; every
slot holds at most one token, so the gather and scatter here compute the
same values.

The Switch load-balance aux ``E * sum_e f_e * P_e`` (f_e the share of
the top-k assignments routed to e, P_e the mean router probability of
e, over every position) is added to the forward's record
(``stochastic.add_moe_aux``, one scalar a call) where one is open, and
not computed where none is (a decode); the train step weights it into
the loss.

Expert parallelism (``parallel/sharding.py:shard_params``): with the
experts split over the ``expert`` axis (``ep``), a rank runs its block
of experts on their slots and the combine sums over the axis; within an
expert the pair keeps the column / row split over ``model`` (``w_out``
sums its partial products over the axis before its bias).  Under a
batch sharded over ranks the aux's means are over the whole batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.registry import get_activation
from asr_model_tpu_torch.models.tlayers import Dense, param, uniform_
from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.parallel.mesh import psum


def expert_capacity(seq_len: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots an expert has in one example: ceil(T k / E * factor), at
    least 1 and at most T."""
    c = math.ceil(seq_len * top_k / num_experts * capacity_factor)
    return max(1, min(int(c), seq_len))


def topk_lowest_first(probs, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in index order (``jax.lax.top_k``'s ties): a stable
    descending sort."""
    s = torch.sort(probs, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


class StackedDense(nn.Module):
    """E dense layers as one (E, in, out) ``kernel`` and (E, out)
    ``bias``, each drawn as a torch-default Dense of width ``in``."""

    def __init__(self, experts: int, in_features: int, features: int,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.kernel = param(experts, in_features, features, device=device,
                            dtype=dtype)
        self.bias = param(experts, features, device=device, dtype=dtype)

    def reset_parameters(self, gen):
        uniform_(self.kernel, self.in_features, gen)
        uniform_(self.bias, self.in_features, gen)

    tp = None
    tp_row = False

    def forward(self, x):
        """x (B, E, C, in) -> (B, E, C, out), expert e's layer on its
        slots."""
        y = torch.einsum("becd,edh->bech", x, self.kernel)
        if self.tp_row:
            y = psum(y, self.tp)
        return y + self.bias[:, None]


class Experts(nn.Module):
    """The E expert FFNs: w_in (D -> H), the activation, w_out (H -> D)."""

    def __init__(self, experts: int, dims: int, hidden: int, act: str,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.act = get_activation(act)
        self.w_in = StackedDense(experts, dims, hidden, **kw)
        self.w_out = StackedDense(experts, hidden, dims, **kw)

    def forward(self, x):
        return self.w_out(self.act(self.w_in(x)))


class MoEMLP(nn.Module):
    def __init__(self, dims: int, hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 act: str = "gelu", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.router = Dense(dims, num_experts, **kw)
        self.ep = None
        self.experts = Experts(num_experts, dims, hidden, act, **kw)

    def route(self, x):
        """The routing of x (B, T, D): (probs (B, T, E) f32, expert ids
        (B, T, k), gate values (B, T, k) f32, each assignment's slot
        (B, T k) with drops at C or past, C)."""
        B, T, _ = x.shape
        E, k = self.num_experts, min(self.top_k, self.num_experts)
        C = expert_capacity(T, E, k, self.capacity_factor)
        probs = torch.softmax(self.router(x).float(), dim=-1)
        gate, idx = topk_lowest_first(probs, k)
        gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
        hot = F.one_hot(idx.reshape(B, T * k), E).to(torch.int32)
        slot = ((torch.cumsum(hot, dim=1) * hot).sum(dim=-1) - 1)
        return probs, idx, gate, slot, C

    def forward(self, x):
        B, T, d = x.shape
        E, k = self.num_experts, min(self.top_k, self.num_experts)
        probs, idx, gate, slot, C = self.route(x)
        if stochastic.collects_moe_aux():
            hot = F.one_hot(idx, E).to(torch.float32)
            if pctx.batch_axis() is None:
                f, p = hot.mean(dim=(0, 1, 2)), probs.mean(dim=(0, 1))
            else:
                f = pctx.global_mean(hot, (0, 1, 2))
                p = pctx.global_mean(probs, (0, 1))
            stochastic.add_moe_aux(E * torch.sum(f * p))

        keep = slot < C
        dest = idx.reshape(B, T * k) * C + torch.clamp(slot, max=C - 1)
        # dropped assignments write to a spare slot past the E C real ones
        dest_in = torch.where(keep, dest, torch.full_like(dest, E * C))
        rows = x.repeat_interleave(k, dim=1)                 # (B, T k, D)
        expert_in = x.new_zeros(B, E * C + 1, d).scatter(
            1, dest_in[..., None].expand(B, T * k, d), rows)
        n_local = self.experts.w_in.kernel.shape[0]
        lo = 0 if self.ep is None else self.ep.index * n_local * C
        out = self.experts(expert_in[:, lo:lo + n_local * C].reshape(
            B, n_local, C, d)).reshape(B, n_local * C, d)
        if n_local < E:     # this rank's experts; the others' slots zero
            out = torch.cat([out.new_zeros(B, lo, d), out, out.new_zeros(
                B, E * C - lo - n_local * C, d)], dim=1)
        got = out.gather(
            1, dest[..., None].expand(B, T * k, d))          # (B, T k, D)
        ct = torch.promote_types(x.dtype, torch.float32)
        w = (gate.reshape(B, T * k) * keep).to(x.dtype).to(ct)
        y = (got.to(ct) * w[..., None]).reshape(B, T, k, d).sum(dim=2)
        return psum(y, self.ep).to(x.dtype)
