"""Frequency-adaptive momentum (``FAMOptimizer``) and the
``FrequencyHandler`` band analysers: the counterpart of
``asr_model_tpu/optim/fam.py``.

A handler splits the normalised |rfft| of a gradient sample into bands
(equal width; log-spaced for convolutions; half the bands over each half
of the spectrum for attention) and raises or lowers the momentum by
where the power sits.  ``FAMOptimizer`` keeps, per parameter, the
momentum and an EMA of its band powers; parameters of more than
``min_size`` elements sample the first ``sample_size`` elements of
their gradient (in the JAX layout's order), and after
``fam_start_step`` their handler picks the step's momentum.  The FFTs
are ``torch.fft`` on the parameter's device; nothing is read back to the
host.  ``get_parameter_groups`` groups parameters by name with the
reference's per-group settings, ``handler_tree_from_params`` names each
parameter's handler, ``dump_debug_info`` writes a band history as JSON.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def _band_powers_linear(power: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Equal-width bands; the frequencies past n_bands * width fold into
    the last band."""
    n = power.shape[0]
    width = n // n_bands
    if width <= 0:
        return power.new_zeros(n_bands)
    idx = torch.clamp(torch.arange(n, device=power.device) // width,
                      max=n_bands - 1)
    return power.new_zeros(n_bands).index_add(0, idx, power)


def _band_powers_log(power: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Log-spaced bands: band i spans [n^(i/B) - 1, n^((i+1)/B) - 1)."""
    n = power.shape[0]
    edges = np.maximum(0, (n ** (np.arange(n_bands + 1) / n_bands) - 1)
                       ).astype(np.int64)
    edges = np.minimum(edges, n)
    return torch.stack([power[edges[i]:edges[i + 1]].sum()
                        for i in range(n_bands)])


def _band_powers_lowhigh(power: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Half the bands over the lower half of the spectrum, the rest over
    the upper."""
    n = power.shape[0]
    half = n_bands // 2
    low = _band_powers_linear(power[:n // 2], max(half, 1))
    high = _band_powers_linear(power[n // 2:], max(n_bands - half, 1))
    return torch.cat([low, high])


class FrequencyHandler:
    """The band split and the momentum rule; subclasses specialise
    both."""

    def analyze(self, grad_sample: torch.Tensor, n_bands: int,
                eps: float = 1e-8) -> torch.Tensor:
        power = torch.fft.rfft(grad_sample.to(torch.float32)).abs()
        total = power.sum()
        power = torch.where(total > 0, power / (total + eps), power)
        return self._split(power, n_bands)

    def _split(self, power, n_bands):
        return _band_powers_linear(power, n_bands)

    def get_adaptive_momentum(self, band_values: torch.Tensor,
                              base_alpha: float) -> torch.Tensor:
        n = band_values.shape[0]
        high = band_values[n // 2:].sum()
        return torch.where(high > 0.3, _c(min(0.95, base_alpha + 0.05),
                                          high), _c(base_alpha, high))


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class ConvFrequencyHandler(FrequencyHandler):
    def _split(self, power, n_bands):
        return _band_powers_log(power, n_bands)

    def get_adaptive_momentum(self, band_values, base_alpha):
        n = band_values.shape[0]
        mid = band_values[n // 4:(3 * n) // 4].sum()
        high = band_values[(3 * n) // 4:].sum()
        return torch.where(
            mid > 0.4, _c(min(0.97, base_alpha + 0.07), mid),
            torch.where(high > 0.3, _c(min(0.95, base_alpha + 0.05), mid),
                        _c(base_alpha, mid)))


class AttentionFrequencyHandler(FrequencyHandler):
    def _split(self, power, n_bands):
        return _band_powers_lowhigh(power, n_bands)

    def get_adaptive_momentum(self, band_values, base_alpha):
        n = band_values.shape[0]
        peak = torch.argmax(band_values)
        return torch.where(
            peak < n // 4, _c(max(0.85, base_alpha - 0.05), band_values),
            torch.where(peak > (3 * n) // 4,
                        _c(min(0.98, base_alpha + 0.08), band_values),
                        _c(base_alpha, band_values)))


class EmbeddingFrequencyHandler(FrequencyHandler):
    def get_adaptive_momentum(self, band_values, base_alpha):
        n = band_values.shape[0]
        high = band_values[(3 * n) // 4:].sum()
        return torch.where(high > 0.2, _c(min(0.98, base_alpha + 0.08),
                                          high), _c(base_alpha, high))


HANDLERS = {
    "default": FrequencyHandler(),
    "conv": ConvFrequencyHandler(),
    "attention": AttentionFrequencyHandler(),
    "embedding": EmbeddingFrequencyHandler(),
}


def handler_for_name(name: str) -> str:
    n = name.lower()
    if "conv" in n or "cnn" in n:
        return "conv"
    if any(x in n for x in ("attention", "mha", "self_attn", "attn")):
        return "attention"
    if any(x in n for x in ("embed", "token")):
        return "embedding"
    return "default"


def handler_tree_from_params(named: Iterable[Tuple[str, Any]]
                             ) -> Dict[str, str]:
    """{name: handler name} of (name, parameter) pairs (the flax paths,
    ``optim/variants.py:flax_order``, name them as the JAX package
    does)."""
    return {n: handler_for_name(n) for n, _ in named}


class FAMOptimizer(torch.optim.Optimizer):
    """``handlers``: {parameter: handler name}, 'default' where absent;
    ``layouts`` as MaxFactor's (the JAX layout's element order for the
    gradient sample)."""

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.9,
                 beta: float = 0.99, eps: float = 1e-8, decay: float = 0.0,
                 n_bands: int = 8, fam_start_step: int = 100,
                 min_size: int = 256, handlers: Optional[dict] = None,
                 sample_size: int = 1000,
                 layouts: Optional[Dict[torch.Tensor, tuple]] = None):
        super().__init__(params, dict(lr=lr))
        self.lr_value, self.alpha, self.beta, self.eps = lr, alpha, beta, eps
        self.decay, self.n_bands = decay, n_bands
        self.fam_start_step, self.min_size = fam_start_step, min_size
        self.sample_size = sample_size
        self.handlers = handlers or {}
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
                self._update(p)

    def _update(self, p):
        st = self.state[p]
        ct = torch.promote_types(p.dtype, torch.float32)
        pj = self._jax(p, p)
        if not st:
            st["exp_avg"] = torch.zeros_like(pj, dtype=ct)
            st["freq_history"] = torch.zeros(self.n_bands, dtype=ct,
                                             device=p.device)
        g = (torch.zeros_like(st["exp_avg"]) if p.grad is None
             else self._jax(p.grad, p).to(ct))
        if self.decay != 0:
            g = g + self.decay * pj.to(ct)
        eff = torch.tensor(self.alpha, dtype=ct, device=p.device)
        if g.numel() > self.min_size:
            handler = HANDLERS[self.handlers.get(p, "default")]
            sample = g.reshape(-1)[:min(self.sample_size, g.numel())]
            bands = handler.analyze(sample, self.n_bands, self.eps)
            hist = st["freq_history"]
            hist.mul_(self.beta).add_((1 - self.beta) * bands)
            if self.step_count > self.fam_start_step:
                eff = handler.get_adaptive_momentum(hist, self.alpha)
        m = st["exp_avg"]
        m.mul_(eff).add_((1 - eff) * g)
        pj.add_((-self.lr_value * m).to(p.dtype))


def fam_optimizer(params, **kw) -> FAMOptimizer:
    return FAMOptimizer(params, **kw)


_GROUPS = {
    "conv": lambda lr, decay: dict(lr=lr, decay=decay, alpha=0.9,
                                   handler="conv", n_bands=10),
    "attention": lambda lr, decay: dict(lr=lr, decay=decay, alpha=0.92,
                                        handler="attention", n_bands=12),
    "embedding": lambda lr, decay: dict(lr=lr * 0.8, decay=decay * 1.5,
                                        alpha=0.95, handler="embedding",
                                        n_bands=8),
    "norm": lambda lr, decay: dict(lr=lr, decay=0.0, alpha=0.9,
                                   handler="default", n_bands=4),
    "other": lambda lr, decay: dict(lr=lr, decay=decay, alpha=0.9,
                                    handler="default", n_bands=8),
}


def get_parameter_groups(named: Iterable[Tuple[str, Any]],
                         lr: float = 1e-3, decay: float = 0.0
                         ) -> Dict[str, Dict[str, Any]]:
    """Name-based groups with the reference's settings: conv, attention,
    embedding (0.8x lr, 1.5x decay), norm (no decay), other; each with
    its ``names``."""
    groups: Dict[str, Dict[str, Any]] = {}
    for name, _ in named:
        n = name.lower()
        if "conv" in n or "cnn" in n:
            key = "conv"
        elif any(x in n for x in ("attention", "mha", "self_attn", "attn")):
            key = "attention"
        elif any(x in n for x in ("embed", "token")):
            key = "embedding"
        elif any(x in n for x in ("norm", "batch", "layer")):
            key = "norm"
        else:
            key = "other"
        groups.setdefault(key, {**_GROUPS[key](lr, decay), "names": []})
        groups[key]["names"].append(name)
    return groups


def dump_debug_info(path: str, history: Dict[str, Any]) -> None:
    """The band history as JSON (host side, between steps)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {"optimizer": "FAMOptimizer",
            "dumped": datetime.now().isoformat(),
            "parameters": {k: {kk: (np.asarray(
                vv.detach().cpu() if torch.is_tensor(vv) else vv).tolist()
                if hasattr(vv, "tolist") else vv) for kk, vv in v.items()}
                for k, v in history.items()}}
    with open(path, "w") as f:
        json.dump(blob, f)
