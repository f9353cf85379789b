"""Weights from the JAX package's flax trees.

``from_jax_params(params, batch_stats=None)`` takes the flax ``params``
and ``batch_stats`` trees (nested mappings of numpy arrays) and returns
the port model's ``state_dict``.  The port names its submodules after
the flax tree (``processor.block3.attn.q_proj``, ``enc.enc0_convlite.bn``,
...), so the mapping is per leaf:

* Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
* Conv ``kernel`` (k, in / groups, out) -> ``weight`` (out, in / groups, k)
* weight-norm ``v`` (k, in, out)        -> ``v`` (out, in, k); ``g``, ``b`` as they are
* Embed ``embedding``                   -> ``weight``
* LayerNorm / BatchNorm ``scale``       -> ``weight``
* BatchNorm stats ``mean`` / ``var``    -> ``running_mean`` / ``running_var``
* everything else (the MSheath (L, ...) stacks, ``position``,
  ``blend``, ``alpha``, the rotary placeholders) as it is.

``model.load_state_dict(from_jax_params(...), strict=True)`` checks that
the two trees hold the same tensors.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _param_entry(path, a):
    *mod, leaf = path
    if leaf == "kernel" and a.ndim == 2:
        return mod + ["weight"], a.T
    if leaf == "kernel" and a.ndim == 3:
        return mod + ["weight"], a.transpose(2, 1, 0)
    if leaf == "v" and a.ndim == 3:
        return mod + ["v"], a.transpose(2, 1, 0)
    if leaf in ("embedding", "scale"):
        return mod + ["weight"], a
    return mod + [leaf], a


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_jax_params(params, batch_stats=None) -> dict:
    """The port's state_dict (CPU tensors) for flax ``params`` /
    ``batch_stats`` trees."""
    sd = {}
    for path, a in _flatten(params):
        key, val = _param_entry(path, a)
        sd[".".join(key)] = torch.tensor(np.ascontiguousarray(val))
    for path, a in _flatten(batch_stats or {}):
        *mod, leaf = path
        sd[".".join(mod + [_STATS.get(leaf, leaf)])] = torch.tensor(
            np.ascontiguousarray(a))
    return sd
