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
  ``blend``, ``alpha``, the rotary placeholders) as it is, and so are
  the leaves of the modules that keep flax's layout (``FLAX_LAYOUT``:
  the MoE experts' stacked (E, in, out) kernels, the encoder layer's
  ``SelfAttention_0`` (D, H, hd) / (H, hd, D) kernels).

The latent modules (``models/extras.py``, ``gates.Gate`` and ``OneShot``,
``norms.ChannelLayerNorm``) follow the same rules: their Dense layers
transposed, their stacked and scalar parameters (``imp_w``,
``span_scale``, ...) as they are.

``model.load_state_dict(from_jax_params(...), strict=True)`` checks that
the two trees hold the same tensors.  ``to_jax_params(model)`` is the
inverse (the flax ``params`` and ``batch_stats`` trees of a model), and
``jax_layout(model)`` says, per parameter or buffer, where it sits in
those trees and which permutation of its dimensions gives the flax
array (the optimizer and the checkpoint writer work in that layout).
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


# module names whose leaves the port holds in flax's layout, under
# flax's names
FLAX_LAYOUT = ("experts", "SelfAttention_0")


def _param_entry(path, a):
    *mod, leaf = path
    if any(m in FLAX_LAYOUT for m in mod):
        return mod + [leaf], a
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


def _leaf_layout(module, name: str, ndim: int):
    """(collection, flax leaf name, permutation or None) of a module's
    direct parameter or buffer ``name``."""
    from asr_model_tpu_torch.models.conv import WeightNormConv1d
    from asr_model_tpu_torch.models.norms import (BatchNorm1d, LayerNorm,
                                                  Scale)
    from asr_model_tpu_torch.models.tlayers import Conv1d, Dense, Embed
    if isinstance(module, Dense) and name == "weight":
        return "params", "kernel", (1, 0)
    if isinstance(module, Conv1d) and name == "weight":
        return "params", "kernel", (2, 1, 0)
    if isinstance(module, WeightNormConv1d) and name == "v":
        return "params", "v", (2, 1, 0)
    if isinstance(module, Embed) and name == "weight":
        return "params", "embedding", None
    if isinstance(module, (LayerNorm, BatchNorm1d, Scale)) \
            and name == "weight":
        return "params", "scale", None
    if isinstance(module, BatchNorm1d) and name in ("running_mean",
                                                    "running_var"):
        return "batch_stats", name[len("running_"):], None
    return "params", name, None


def jax_layout(model) -> dict:
    """{state_dict name: (collection, flax path tuple, permutation or
    None)} for every parameter and buffer of ``model``."""
    out = {}
    for mod_name, module in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        own = list(module.named_parameters(recurse=False)) \
            + list(module.named_buffers(recurse=False))
        for name, t in own:
            coll, leaf, perm = _leaf_layout(module, name, t.dim())
            key = ".".join(prefix + (name,))
            out[key] = (coll, prefix + (leaf,), perm)
    return out


def to_jax_array(t: torch.Tensor, perm) -> np.ndarray:
    t = t.detach()
    if perm is not None:
        t = t.permute(*perm)
    return np.array(t.cpu().numpy(), order="C")     # keeps 0-d shapes


def set_path(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_jax_params(model):
    """The flax (``params``, ``batch_stats``) trees of ``model``: nested
    dicts of numpy arrays in the JAX package's layout."""
    trees = {"params": {}, "batch_stats": {}}
    sd = model.state_dict()
    for key, (coll, path, perm) in jax_layout(model).items():
        set_path(trees[coll], path, to_jax_array(sd[key], perm))
    return trees["params"], trees["batch_stats"]
