"""String-keyed norm and activation registries.  Ported: the names the
flagship uses (AbbyNormal, exact-erf GELU) and LayerNorm, which is also
the fallback for an unknown norm name; the reference's other named
norms and activations are not ported and raise."""

from __future__ import annotations

import warnings
from typing import Callable

import torch.nn.functional as F

from asr_model_tpu_torch.models import norms


_UNPORTED_NORMS = {"linearnorm", "adanorm", "instancenorm", "rmsnorm",
                   "batchnorm", "instancenorm2d", "groupnorm", "localnorm",
                   "globalnorm"}
_UNPORTED_ACTS = {"relu", "sigmoid", "tanh", "swish", "tanhshrink",
                  "softplus", "softshrink", "leaky_relu", "elu"}


def get_norm(n_type: str, dims: int, device=None, dtype=None):
    if n_type == "AbbyNormal":
        return norms.AbbyNormal(dims, alpha=1e-4, beta=0.75, k=1.0,
                                device=device, dtype=dtype)
    if n_type in _UNPORTED_NORMS:
        raise NotImplementedError(f"norm {n_type!r} is not ported")
    if n_type != "layernorm":
        warnings.warn(f"Norm type '{n_type}' not found. Returning LayerNorm.")
    return norms.LayerNorm(dims, device=device, dtype=dtype)


def get_activation(act: str) -> Callable:
    """Exact-erf GELU (torch nn.GELU), also the fallback for an unknown
    name."""
    if act in _UNPORTED_ACTS:
        raise NotImplementedError(f"activation {act!r} is not ported")
    return lambda x: F.gelu(x, approximate="none")
