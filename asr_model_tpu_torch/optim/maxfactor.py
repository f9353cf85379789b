"""MaxFactor: the factored second-moment optimizer with sign-based,
row-scaled updates of the reference (``optimizerc.py``), as the JAX
package's optax transformation computes it
(``asr_model_tpu/optim/maxfactor.py``; its docstring has the math).

Each parameter is updated in the JAX tree's layout: ``layouts`` maps a
parameter to the permutation of its dimensions that gives the flax
array (a Dense ``weight`` (out, in) is the kernel (in, out) transposed;
see ``weights.jax_layout``), so the row/column statistics, the row
scaling and the state are the JAX package's, and a checkpoint holds the
state as it does.  Per step, for a parameter p with gradient g (in the
JAX layout, f32):

* ``beta_t = step ** b_decay``; rho_t = clamp(lr, min_lr, 1/sqrt(step));
  alpha = max(eps2, RMS(p)) * rho_t;
* >= 2-D: EMAs of the squared row and column means (``row_var``,
  ``col_var``), the estimate row @ col / max(row); <= 1-D: an EMA ``v``;
* update = g / sqrt(max(estimate, eps1^2)) over its inf-norm, denom =
  max(1, RMS(update) / d);
* rows move by sign(update) times their max |update| (``bias`` 1, or
  fewer than 3 dimensions) or their lower median (bias 2 and 3-D+);
* p += -(lr * decay) * p - alpha / denom * sign(update) * scale.

Two parameter groups by name, ``bias_groups``: names holding 'jump',
'pnet' or 'micro_filter' take ``jump_bias`` (2), the rest ``bias`` (1).
A parameter whose ``.grad`` is None is updated as if its gradient were
zero: the decoupled decay still applies, as the JAX optimizer applies
it to every leaf.  The step count and the rates are host numbers, so a
step reads nothing back from the device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

JUMP_NAMES = ("jump", "pnet", "micro_filter")
f32 = np.float32


def bias_groups(named_params: Iterable, main_bias: int = 1,
                jump_bias: int = 2) -> list:
    """The reference's two parameter groups: [{"params", "names",
    "bias"}], by parameter name."""
    groups = {main_bias: ([], []), jump_bias: ([], [])}
    for name, p in named_params:
        b = jump_bias if any(j in name for j in JUMP_NAMES) else main_bias
        groups[b][0].append(p)
        groups[b][1].append(name)
    return [{"params": ps, "names": ns, "bias": b}
            for b, (ps, ns) in groups.items() if ps]


def _rms(t):
    return torch.linalg.vector_norm(t.reshape(-1)) / math.sqrt(t.numel())


def lower_median(x, dim: int = -1):
    """torch.median's convention: the lower of the two middle elements,
    kept as a dimension."""
    n = x.shape[dim]
    return torch.sort(x, dim=dim).values.narrow(dim, (n - 1) // 2, 1)


class MaxFactor(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[float, Callable] = 0.025,
                 b_decay: float = -0.8, eps: tuple = (1e-8, 1e-8),
                 d: float = 1.0, decay: float = 0.01, gamma: float = 0.99,
                 maximize: bool = False, bias: int = 1,
                 min_lr: float = 1e-9, clip: bool = False, cap: float = 0.0,
                 layouts: Optional[Dict[torch.Tensor, tuple]] = None):
        defaults = dict(bias=bias)
        super().__init__(params, defaults)
        self.lr = lr
        self.b_decay, self.eps, self.d, self.decay = b_decay, eps, d, decay
        self.gamma, self.maximize, self.min_lr = gamma, maximize, min_lr
        self.clip, self.cap = clip, cap
        self.layouts = layouts or {}
        self.step_count = 0

    def jax_view(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        perm = self.layouts.get(p)
        return t if perm is None else t.permute(*perm)

    def init_state(self, p: torch.Tensor) -> dict:
        """Zero state in the JAX layout: ``row_var`` (..., R, 1) and
        ``col_var`` (..., 1, C) for >= 2-D, ``v`` like p for <= 1-D."""
        shape = self.jax_view(p, p).shape
        kw = dict(dtype=torch.promote_types(p.dtype, torch.float32),
                  device=p.device)
        if len(shape) > 1:
            return {"row_var": torch.zeros(shape[:-1] + (1,), **kw),
                    "col_var": torch.zeros(shape[:-2] + (1, shape[-1]),
                                           **kw)}
        return {"v": torch.zeros(shape, **kw)}

    # the knobs the variants of ``optim/variants.py`` turn: beta_t clamped
    # to [0.001, 0.999], rho_t floored at min_lr, the inf-norm division
    # skipped where the norm is 0
    beta_clamp = False
    rho_floor = True
    guard_inf_norm = True

    def rates(self, step: int):
        """(lr_t, beta_t, rho_t) of 1-based step ``step``, float32."""
        s = f32(step)
        lr_t = f32(self.lr(float(s - f32(1))) if callable(self.lr)
                   else self.lr)
        beta_t = s ** f32(self.b_decay)
        if self.beta_clamp:
            beta_t = min(max(beta_t, f32(0.001)), f32(0.999))
        rho_t = min(lr_t, f32(1) / np.sqrt(s))
        if self.rho_floor:
            rho_t = max(f32(self.min_lr), rho_t)
        return float(lr_t), float(beta_t), float(rho_t)

    def direction(self, update, pv, group: dict, p):
        """The signed row-scaled step direction: rows move by their max
        |update| (``bias`` 1, or fewer than 3 dimensions) or their lower
        median."""
        mag = update.abs()
        if pv.dim() < 3 or int(group["bias"]) == 1:
            scale = mag.amax(dim=-1, keepdim=True)
        else:
            scale = lower_median(mag)
        return torch.sign(update) * scale

    @torch.no_grad()
    def step(self, closure=None):
        self.step_count += 1
        lr_t, beta_t, rho_t = self.rates(self.step_count)
        eps1, eps2 = self.eps
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(self.init_state(p))
                self._update(p, st, group, lr_t, beta_t, rho_t, eps1,
                             eps2)

    def _update(self, p, st, group, lr_t, beta_t, rho_t, eps1, eps2):
        """One parameter's update; returns its trust-ratio alpha."""
        ct = torch.promote_types(p.dtype, torch.float32)
        pj = self.jax_view(p, p)
        g = (torch.zeros_like(pj, dtype=ct) if p.grad is None
             else self.jax_view(p.grad, p).to(ct))
        if self.maximize:
            g = -g
        pv = pj.to(ct)
        if pv.dim() == 0:
            g, pv = g[None], pv[None]
        alpha = torch.clamp(_rms(pv), min=eps2) * rho_t
        if g.dim() > 1:
            rv, cv = st["row_var"], st["col_var"]
            gg = g * g
            rv.add_(beta_t * (gg.sum(dim=-1, keepdim=True)
                              / (g.shape[-1] + 1e-8) - rv))
            cv.add_(beta_t * (gg.sum(dim=-2, keepdim=True)
                              / (g.shape[-2] + 1e-8) - cv))
            var_est = (rv @ cv) / torch.clamp(rv.amax(dim=-2, keepdim=True),
                                              min=eps1)
        else:
            v = st["v"].view(g.shape)
            v.mul_(self.gamma).add_((1 - self.gamma) * g * g)
            var_est = v
        update = torch.rsqrt(torch.clamp(var_est, min=eps1 * eps1)) * g
        inf = update.abs().amax()
        if self.guard_inf_norm:
            update = torch.where(inf > 0, update / torch.clamp(inf, min=eps1),
                                 update)
        else:
            update = update / torch.clamp(inf, min=eps1)
        denom = torch.clamp(_rms(update) / self.d, min=1.0)
        final_dir = self.direction(update, pv, group, p)
        step_size = alpha / denom
        if self.clip:
            max_step = _rms(pv) * self.cap
            upd_rms = _rms(final_dir * step_size)
            step_size = torch.where(upd_rms > max_step,
                                    step_size * (max_step / (upd_rms + 1e-8)),
                                    step_size)
        delta = -float(f32(lr_t) * f32(self.decay)) * pv \
            - step_size * final_dir
        pj.add_(delta.view(pj.shape).to(p.dtype))
        return alpha


class MultiSteps:
    """Gradient accumulation over ``every_k`` calls, as optax
    ``MultiSteps`` does it: the gradients' running mean, the inner
    optimizer stepped on the k-th call with that mean, no update on the
    others.  ``mini_step`` / ``gradient_step`` count as optax's state."""

    def __init__(self, inner: MaxFactor, every_k: int):
        self.inner, self.every_k = inner, int(every_k)
        self.mini_step, self.gradient_step = 0, 0
        self.acc: Dict[torch.Tensor, torch.Tensor] = {}

    @torch.no_grad()
    def step(self):
        n = self.mini_step
        for group in self.inner.param_groups:
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                a = self.acc.get(p)
                self.acc[p] = g.clone() if a is None or n == 0 \
                    else (a * n + g) / (n + 1)
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for group in self.inner.param_groups:
            for p in group["params"]:
                p.grad = self.acc[p]
        self.inner.step()
        for a in self.acc.values():
            a.zero_()
        self.mini_step, self.gradient_step = 0, self.gradient_step + 1
