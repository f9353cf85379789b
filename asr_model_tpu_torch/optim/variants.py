"""The MaxFactor variant family, the counterpart of
``asr_model_tpu/optim/variants.py``: PyTorch optimizers over the port's
parameter groups, each ``optim/maxfactor.py:MaxFactor`` with its knobs
turned (``beta_clamp``, ``rho_floor``, ``guard_inf_norm``) and its own
step direction, every parameter updated in the JAX layout (``layouts``,
as MaxFactor).

* ``MaxFactor99``: beta_t clamped to [0.001, 0.999]; rows by their max
  (``bias`` 1, or fewer than 3 dimensions) or lower median.
* ``MaxFactorA``: per-parameter depth roles (``depth_roles``: the first
  20% of the parameters in the flax tree's order 'robust', the row's
  lower median; to 70% 'balanced', its RMS; the rest 'aggressive', its
  max); no rho floor; clamped beta; the inf-norm division unguarded.
* ``MaxFactor1``: row max, unclamped beta, no floor, unguarded.
* ``MaxFactor2``: clamped beta; 1-D parameters take the raw normalised
  update, the others the row max; tracks the effective rate.
* ``MaxFactorB``: ``bias`` 1 the row max, 2 the lower median, any other
  the raw update; floored rho, unclamped beta.
* ``MaxHeadroom``: MaxFactor1 that tracks the effective rate.
* ``SimpleFAM``: momentum SGD whose momentum rises with the
  high-frequency share of the gradient's FFT (parameters of more than
  1,000 elements, after step 100).

The tracked rate (``get_last_lr``) is the mean over the parameters of
the last step's trust-ratio alpha = max(eps2, RMS(p)) * rho_t, kept on
the device (``TrackedLRState``); reading it is the one host read.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Union

import torch

from asr_model_tpu_torch.optim.maxfactor import MaxFactor, lower_median


def depth_roles(names: Sequence[str]) -> Dict[str, str]:
    """MaxFactorA's roles by position in ``names`` (the flax tree's
    order: ``flax_order``): 'robust' below 20%, 'balanced' below 70%,
    'aggressive' after."""
    total = len(names)
    out = {}
    for i, n in enumerate(names):
        depth = i / total
        out[n] = ("robust" if depth < 0.2 else
                  "balanced" if depth < 0.7 else "aggressive")
    return out


def flax_order(model) -> list:
    """(flax path "a/b/leaf", parameter) of ``model``'s parameters in the
    order ``jax.tree_util`` flattens the flax ``params`` tree (sorted
    keys at every level)."""
    from asr_model_tpu_torch.weights import jax_layout
    layout = jax_layout(model)
    named = [(layout[n][1], p) for n, p in model.named_parameters()]
    return [("/".join(path), p) for path, p in sorted(named,
                                                     key=lambda t: t[0])]


def depth_role_tree(model) -> Dict[torch.Tensor, str]:
    """{parameter: role} of ``model`` (``depth_roles`` over
    ``flax_order``)."""
    order = flax_order(model)
    roles = depth_roles([n for n, _ in order])
    return {p: roles[n] for n, p in order}


def _scale_max(u):
    return torch.sign(u) * u.abs().amax(dim=-1, keepdim=True)


def _scale_median(u):
    return torch.sign(u) * lower_median(u.abs())


def _scale_rms(u):
    return torch.sign(u) * torch.sqrt((u * u).mean(dim=-1, keepdim=True))


class TrackedLRState(NamedTuple):
    """The tracked optimizers' extra state: the last step's mean
    trust-ratio alpha (a 0-d device tensor; 0 before the first step)."""
    effective_lr: torch.Tensor


class _Tracked:
    """Mixin: keeps the mean alpha of the last step."""

    def step(self, closure=None):
        self._alphas = []
        super().step(closure)
        a = torch.stack([torch.as_tensor(x, dtype=torch.float32)
                         for x in self._alphas])
        self.tracked = TrackedLRState(a.mean())

    def _update(self, *args):
        alpha = super()._update(*args)
        self._alphas.append(alpha)
        return alpha


def get_last_lr(opt) -> float:
    """The mean effective rate (trust-ratio alpha) of the last step of a
    ``MaxFactor2`` / ``MaxHeadroom`` (or a ``MultiSteps`` around one)."""
    inner = getattr(opt, "inner", opt)
    if not isinstance(inner, _Tracked):
        raise ValueError("no TrackedLRState found: use maxfactor2/"
                         "maxheadroom")
    t = getattr(inner, "tracked", None)
    return 0.0 if t is None else float(t.effective_lr)


class MaxFactor99(MaxFactor):
    beta_clamp = True


class MaxFactorA(MaxFactor):
    """``roles``: {parameter: 'robust' | 'balanced' | 'aggressive'}
    (``depth_role_tree``); a parameter without one is 'balanced'."""
    beta_clamp, rho_floor, guard_inf_norm = True, False, False

    def __init__(self, params, roles: Optional[dict] = None, **kw):
        super().__init__(params, **kw)
        self.roles = roles or {}

    def direction(self, update, pv, group, p):
        role = self.roles.get(p, "balanced")
        if role == "robust":
            return _scale_median(update)
        if role == "aggressive":
            return _scale_max(update)
        return _scale_rms(update)


class MaxFactor1(MaxFactor):
    beta_clamp, rho_floor, guard_inf_norm = False, False, False

    def direction(self, update, pv, group, p):
        return _scale_max(update)


class MaxFactor2(_Tracked, MaxFactor):
    beta_clamp = True

    def direction(self, update, pv, group, p):
        return _scale_max(update) if pv.dim() > 1 else update


class MaxFactorB(MaxFactor):
    def direction(self, update, pv, group, p):
        b = int(group["bias"])
        if b == 1:
            return _scale_max(update)
        if b == 2:
            return _scale_median(update)
        return update


class MaxHeadroom(_Tracked, MaxFactor1):
    pass


_KNOBS = ("b_decay", "eps", "d", "decay", "gamma", "maximize", "min_lr",
          "clip", "cap", "layouts")


def _kw(kw: dict, **defaults) -> dict:
    bad = set(kw) - set(_KNOBS)
    if bad:
        raise TypeError(f"unknown options {sorted(bad)}")
    return dict(defaults, **kw)


def maxfactor99(params, lr: Union[float, Callable] = 0.025, bias: int = 1,
                **kw) -> MaxFactor99:
    """``params``: tensors or groups (a group's own ``bias`` wins)."""
    return MaxFactor99(params, lr=lr, bias=bias, **_kw(kw))


def maxfactor_a(params, lr=0.00025, roles: Optional[dict] = None,
                **kw) -> MaxFactorA:
    return MaxFactorA(params, roles=roles, lr=lr,
                      **_kw(kw, decay=0.025, min_lr=0.0, cap=0.1))


def maxfactor1(params, lr=0.025, **kw) -> MaxFactor1:
    return MaxFactor1(params, lr=lr, **_kw(kw, eps=(1e-8, 1e-3),
                                           min_lr=0.0))


def maxfactor2(params, lr=0.025, **kw) -> MaxFactor2:
    return MaxFactor2(params, lr=lr, **_kw(kw, eps=(1e-8, 1e-3),
                                           min_lr=1e-7))


def maxfactorb(params, lr=0.00025, bias: int = 1, **kw) -> MaxFactorB:
    return MaxFactorB(params, lr=lr, bias=bias, **_kw(kw, decay=0.025,
                                                      cap=0.1))


def maxheadroom(params, lr=0.025, **kw) -> MaxHeadroom:
    return MaxHeadroom(params, lr=lr, **_kw(kw, eps=(1e-8, 1e-3),
                                            min_lr=0.0))


class SimpleFAM(torch.optim.Optimizer):
    """Momentum SGD with a frequency-adaptive momentum: for a parameter
    of more than 1,000 elements after step 100, alpha + 0.05 times the
    high-frequency share of |rfft| of its gradient's first 1,000
    elements (in the JAX layout's order), at most 0.98; p -= lr * m."""

    def __init__(self, params, lr: float = 0.00025, alpha: float = 0.9,
                 beta: float = 0.99,
                 layouts: Optional[Dict[torch.Tensor, tuple]] = None):
        super().__init__(params, dict(lr=lr))
        self.lr_value, self.alpha, self.beta = lr, alpha, beta
        self.layouts = layouts or {}
        self.step_count = 0

    def _jax(self, t, p):
        perm = self.layouts.get(p)
        return t if perm is None else t.permute(*perm)

    @torch.no_grad()
    def step(self, closure=None):
        self.step_count += 1
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                ct = torch.promote_types(p.dtype, torch.float32)
                if not st:
                    st["exp_avg"] = torch.zeros_like(self._jax(p, p),
                                                     dtype=ct)
                g = (torch.zeros_like(st["exp_avg"]) if p.grad is None
                     else self._jax(p.grad, p).to(ct))
                eff = torch.tensor(self.alpha, dtype=ct, device=p.device)
                if g.numel() > 1000 and self.step_count > 100:
                    power = torch.fft.rfft(g.reshape(-1)[:1000]).abs()
                    half = power.shape[0] // 2
                    high = power[half:].sum() / (power.sum() + 1e-8)
                    eff = torch.clamp(self.alpha + 0.05 * high, max=0.98)
                m = st["exp_avg"]
                m.mul_(eff).add_((1 - eff) * g)
                self._jax(p, p).add_((-self.lr_value * m).to(p.dtype))


def simple_fam(params, lr: float = 0.00025, alpha: float = 0.9,
               beta: float = 0.99, layouts=None) -> SimpleFAM:
    return SimpleFAM(params, lr=lr, alpha=alpha, beta=beta, layouts=layouts)
