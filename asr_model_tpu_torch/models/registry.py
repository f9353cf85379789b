"""String-keyed norm and activation registries, as the JAX package's
(``asr_model_tpu/models/registry.py``): every norm name it maps, an
unknown norm name a warning and LayerNorm, an unknown activation the
exact-erf GELU (torch ``nn.GELU``)."""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from asr_model_tpu_torch.models import norms


def get_norm(n_type: str, dims: Optional[int] = None,
             num_groups: Optional[int] = None, device=None, dtype=None):
    if n_type in ("batchnorm", "instancenorm") and dims is None:
        raise ValueError(f"'{n_type}' requires 'dims'.")
    if n_type == "groupnorm" and num_groups is None:
        raise ValueError(f"'{n_type}' requires 'num_groups'.")
    kw = dict(device=device, dtype=dtype)
    layer_norm = lambda: norms.Wrapped("LayerNorm_0",
                                       norms.LayerNorm(dims, **kw))
    norm_map = {
        "layernorm": layer_norm,
        "linearnorm": lambda: norms.LinearNorm(dims, use_bias=False, **kw),
        "adanorm": lambda: norms.AdaLN(dims, **kw),
        "instancenorm": lambda: norms.InstanceNorm1d(dims),
        "rmsnorm": lambda: norms.RMSNorm(dims, **kw),
        "batchnorm": lambda: norms.Wrapped("BatchNorm_0",
                                           norms.BatchNorm1d(dims, **kw)),
        "instancenorm2d": lambda: norms.InstanceNorm1d(dims),
        "groupnorm": lambda: norms.GroupNorm(dims, num_groups or 1, **kw),
        "localnorm": lambda: norms.LocalNorm(size=5),
        "globalnorm": lambda: norms.GlobalNorm(dims, **kw),
        "AbbyNormal": lambda: norms.AbbyNormal(dims, alpha=1e-4, beta=0.75,
                                               k=1.0, **kw),
    }
    fn = norm_map.get(n_type)
    if fn is not None:
        return fn()
    warnings.warn(f"Norm type '{n_type}' not found. Returning LayerNorm.")
    return layer_norm()


def _gelu(x):
    return F.gelu(x, approximate="none")


def _softshrink(x, lambd: float = 0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > lambd, x - lambd,
                       torch.where(x < -lambd, x + lambd, zero))


ACTIVATIONS = {
    "gelu": _gelu,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "swish": F.silu,
    "tanhshrink": lambda x: x - torch.tanh(x),
    "softplus": F.softplus,
    "softshrink": _softshrink,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
}


def get_activation(act: str) -> Callable:
    """The named activation; the exact-erf GELU for an unknown name."""
    return ACTIVATIONS.get(act, _gelu)
