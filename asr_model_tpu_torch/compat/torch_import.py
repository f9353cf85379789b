"""Reference-checkpoint importer: a torch ``state_dict`` of the
reference model (sine2pi/ASR-model, ``Model.state_dict()``) into the
port's model, the counterpart of ``asr_model_tpu/compat/torch_import.py``.

``convert_state_dict`` converts the reference's layouts into the flax
trees of the JAX package (which the port's ``weights`` module maps onto
its ``state_dict``):

* ``nn.Linear`` weight ``(out, in)`` -> flax kernel ``(in, out)``
* ``nn.Conv1d`` weight ``(out, in/groups, k)`` -> flax ``(k, in/g, out)``
* new-style weight_norm (``parametrizations.weight.original0/1``) and
  old-style (``weight_g``/``weight_v``) both map to the
  ``WeightNormConv1d`` ``g``/``v`` pair
* the reference's per-layer ``ModuleDict`` MSheath members stack into
  the ``(L, ...)`` arrays the layer-slot scan gathers from
* ConvLite BatchNorm running stats -> the ``batch_stats`` collection

The conversion is driven by the target tree: a target leaf without its
torch tensor raises, and torch keys the target does not need (the
blocks the port's single live block does not run, the never-called
``shared_head`` AdaptiveSpan beyond ``span_scale``, the pitch-token and
pitch-context weights, whose options the port does not implement yet)
are reported with a warning.
``state_dict`` values may be numpy arrays or torch tensors.
``import_reference_checkpoint(path, model)`` reads a ``.pt`` file
(``torch.load(..., weights_only=True)``) and loads it into a port model
(``load_state_dict(strict=True)`` through ``weights.from_jax_params``).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional, Tuple

import numpy as np

from asr_model_tpu_torch.weights import from_jax_params, set_path, \
    to_jax_params

logger = logging.getLogger(__name__)


def flatten_dict(tree: dict, prefix: Tuple[str, ...] = ()) -> dict:
    """{path tuple: leaf} of a nested dict (``flax.traverse_util``'s)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_dict(flat: dict) -> dict:
    """The nested dict of {path tuple: leaf}."""
    tree: dict = {}
    for path, v in flat.items():
        set_path(tree, path, v)
    return tree


class _Used(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.used = set()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.used.add(key)
        return value


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()  # torch tensor


def _wn_pair(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """(g, v) of a weight-normed conv under either torch naming style."""
    new_g = f"{prefix}.parametrizations.weight.original0"
    if new_g in sd:
        return sd[new_g], sd[f"{prefix}.parametrizations.weight.original1"]
    return sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]


def _linear(sd, key):
    """torch Linear -> (kernel, bias)."""
    return _np(sd[f"{key}.weight"]).T, _np(sd[f"{key}.bias"])


def _conv1d(sd, key):
    """torch Conv1d (out, in/g, k) -> flax (k, in/g, out)."""
    return (_np(sd[f"{key}.weight"]).transpose(2, 1, 0),
            _np(sd[f"{key}.bias"]))


def _abby(sd, key):
    """AbbyNormal mode_router Sequential(Linear, SiLU, Linear(.,3))
    (essentials.py:140-191) -> router_in/router_out subtree."""
    k_in, b_in = _linear(sd, f"{key}.mode_router.0")
    k_out, b_out = _linear(sd, f"{key}.mode_router.2")
    return {"router_in": {"kernel": k_in, "bias": b_in},
            "router_out": {"kernel": k_out, "bias": b_out}}


def _norm_subtree(sd, key, target_subtree):
    """Map a reference norm instance onto whatever norm the target tree
    holds at this position (AbbyNormal is the only parameterized norm
    the default config uses; plain LayerNorms map scale/bias)."""
    flat = flatten_dict(target_subtree)
    if ("router_in", "kernel") in flat:
        return _abby(sd, key)
    out = {}
    if ("scale",) in flat:
        out["scale"] = _np(sd[f"{key}.weight"])
    if ("bias",) in flat:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _stack(sd, fmt, indices, transform):
    return np.stack([transform(_np(sd[fmt.format(i=i)])) for i in indices])


def _convert_msheath(sd, p: str, target: dict) -> dict:
    """MSheath ModuleList/ModuleDict (model.py:387-427) -> the stacked
    (L, ...) arrays of the port's ``models/sheath.py``."""
    L = target["ln_scale"].shape[0]
    li = list(range(L))
    ident = lambda x: x
    out = {
        "mem_w": _np(sd[f"{p}.mem_w"]),
        "jump_s": _np(sd[f"{p}.jump_s"]),
        "span_scale": _np(sd[f"{p}.shared_head.span_scale"]).reshape(1),
        "memgate_w": _np(sd[f"{p}.mem_gate.0.weight"]).T,
        "memgate_b": _np(sd[f"{p}.mem_gate.0.bias"]),
        "ln_scale": _stack(sd, p + ".layers.{i}.ln.weight", li, ident),
        "ln_bias": _stack(sd, p + ".layers.{i}.ln.bias", li, ident),
        "gate_w": _stack(sd, p + ".layers.{i}.gate.0.weight", li,
                         lambda w: w.T),
        "gate_b": _stack(sd, p + ".layers.{i}.gate.0.bias", li, ident),
        "mkey": _stack(sd, p + ".layers.{i}.v_gate.mkey", li, ident),
        "mval": _stack(sd, p + ".layers.{i}.v_gate.mval", li, ident),
        "vmlp1_w": _stack(sd, p + ".layers.{i}.v_gate.mlp.0.weight", li,
                          lambda w: w.T),
        "vmlp1_b": _stack(sd, p + ".layers.{i}.v_gate.mlp.0.bias", li, ident),
        "vmlp2_w": _stack(sd, p + ".layers.{i}.v_gate.mlp.2.weight", li,
                          lambda w: w.T),
        "vmlp2_b": _stack(sd, p + ".layers.{i}.v_gate.mlp.2.bias", li, ident),
        "vcat_w": _stack(sd, p + ".layers.{i}.v_gate.concat.weight", li,
                         lambda w: w.T),
        "vcat_b": _stack(sd, p + ".layers.{i}.v_gate.concat.bias", li, ident),
        # adapters exist on even layers only (model.py:408)
        "adapt_w": _stack(sd, p + ".layers.{i}.adapter.weight",
                          li[::2], lambda w: w.T),
        "adapt_b": _stack(sd, p + ".layers.{i}.adapter.bias", li[::2], ident),
        "mlpgate_w": _np(sd[f"{p}.mlp_gate.0.weight"]).T,
        "mlpgate_b": _np(sd[f"{p}.mlp_gate.0.bias"]),
        "mlp_ln_scale": _np(sd[f"{p}.mlp_ln.weight"]),
        "mlp_ln_bias": _np(sd[f"{p}.mlp_ln.bias"]),
    }
    k1, b1 = _linear(sd, f"{p}.mlp.0")
    k2, b2 = _linear(sd, f"{p}.mlp.2")
    out["mlp1"] = {"kernel": k1, "bias": b1}
    out["mlp2"] = {"kernel": k2, "bias": b2}
    k1, b1 = _linear(sd, f"{p}.pnet.net.0")
    k2, b2 = _linear(sd, f"{p}.pnet.net.2")
    out["pnet"] = {"fc1": {"kernel": k1, "bias": b1},
                   "fc2": {"kernel": k2, "bias": b2}}
    return out


def _convert_attention(sd, p: str, target: dict) -> dict:
    """attention (model.py:234-249): q/kv/c Sequential(norm, Linear,
    Rearrange), out Sequential(Rearrange, Linear), per-head norm ``ln``,
    rotary ``lin`` (unused placeholder, model.py:178)."""
    out = {
        "q_norm": _norm_subtree(sd, f"{p}.q.0", target["q_norm"]),
        "kv_norm": _norm_subtree(sd, f"{p}.kv.0", target["kv_norm"]),
        "head_norm": _norm_subtree(sd, f"{p}.ln", target["head_norm"]),
    }
    for ours, theirs in (("q_proj", "q.1"), ("kv_proj", "kv.1"),
                         ("out_proj", "out.1")):
        k, b = _linear(sd, f"{p}.{theirs}")
        out[ours] = {"kernel": k, "bias": b}
    if "rot" in target:
        k, b = _linear(sd, f"{p}.rot.lin")
        out["rot"] = {"lin_kernel": k, "lin_bias": b}
    return out


def _convert_residual(sd, p: str, target: dict) -> dict:
    """residual (model.py:559-583): shared ln, attn, router, MSheath
    ``jump``, mlp = Sequential(ln, tgate, Linear, act, Linear, ln)."""
    out = {
        "ln": _norm_subtree(sd, f"{p}.ln", target["ln"]),
        "attn": _convert_attention(sd, f"{p}.attn", target["attn"]),
        "jump": _convert_msheath(sd, f"{p}.jump", target["jump"]),
        "router": {"alpha": _np(sd[f"{p}.router.alpha"])},
    }
    for ours, theirs in (("top", "top"), ("soft", "soft.0")):
        k, b = _linear(sd, f"{p}.router.{theirs}")
        out["router"][ours] = {"kernel": k, "bias": b}
    tg = {}
    n_ga = len([k for k in target["tgate"] if k.startswith("ga")])
    for i in range(n_ga):
        k, b = _linear(sd, f"{p}.mlp.1.ga.{i}.0")
        tg[f"ga{i}"] = {"kernel": k, "bias": b}
    k, b = _linear(sd, f"{p}.mlp.1.cs.0")
    tg["cs"] = {"kernel": k, "bias": b}
    out["tgate"] = tg
    k, b = _linear(sd, f"{p}.mlp.2")
    out["mlp_in"] = {"kernel": k, "bias": b}
    k, b = _linear(sd, f"{p}.mlp.4")
    out["mlp_out"] = {"kernel": k, "bias": b}
    return out


def _convert_encoder(sd, p: str, target: dict) -> Tuple[dict, dict]:
    """AudioEncoder (model.py:120-147): conv1/conv2 stems, per-layer
    Sequential[act, wn-conv, LayerNorm(channel-first), ConvLite, act,
    depthwise conv, act, Dropout].  Returns (params, batch_stats)."""
    out, stats = {}, {}
    for ours, theirs in (("conv1", "conv1.0"), ("conv2", "conv2.0")):
        k, b = _conv1d(sd, f"{p}.{theirs}")
        out[ours] = {"kernel": k, "bias": b}
    n_blocks = len([k for k in target if re.fullmatch(r"enc\d+_wn", k)])
    for i in range(n_blocks):
        bp = f"{p}.encoder.{i}"
        g, v = _wn_pair(sd, f"{bp}.1")
        out[f"enc{i}_wn"] = {
            "g": _np(g).reshape(-1),
            "v": _np(v).transpose(2, 1, 0),
            "b": _np(sd[f"{bp}.1.bias"]),
        }
        # channel-first LayerNorm (essentials.py:102-113): gamma/beta
        out[f"enc{i}_ln"] = {"scale": _np(sd[f"{bp}.2.gamma"]),
                             "bias": _np(sd[f"{bp}.2.beta"])}
        cl = {}
        for conv in ("point1", "depth", "point2"):
            k, b = _conv1d(sd, f"{bp}.3.{conv}")
            cl[conv] = {"kernel": k, "bias": b}
        cl["bn"] = {"scale": _np(sd[f"{bp}.3.bn.weight"]),
                    "bias": _np(sd[f"{bp}.3.bn.bias"])}
        out[f"enc{i}_convlite"] = cl
        stats[f"enc{i}_convlite"] = {
            "bn": {"mean": _np(sd[f"{bp}.3.bn.running_mean"]),
                   "var": _np(sd[f"{bp}.3.bn.running_var"])}}
        k, b = _conv1d(sd, f"{bp}.5")
        out[f"enc{i}_dw"] = {"kernel": k, "bias": b}
    return out, stats


def convert_state_dict(state_dict: Dict[str, np.ndarray], params: dict,
                       batch_stats: Optional[dict] = None) -> dict:
    """Convert a reference ``Model.state_dict()`` into flax trees shaped
    like ``params`` (and ``batch_stats``), each leaf in the target's
    dtype: ``{"params": ..., "batch_stats": ..., "unknown": [keys]}``.
    A target leaf the state dict cannot give is a KeyError, a shape that
    differs a ValueError; the state-dict keys no leaf read
    (``unknown``) are logged as a warning."""
    sd = _Used((k, _np(v)) for k, v in state_dict.items())
    proc_t = params["processor"]
    proc = {
        "position": sd["processor.position"],
        "blend": sd["processor.blend"].reshape(()),
        "token": {"embedding": sd["processor.token.weight"]},
        "ln": _norm_subtree(sd, "processor.ln", proc_t["ln"]),
    }
    for name in proc_t:
        m = re.fullmatch(r"block(\d+)", name)
        if m:
            proc[name] = _convert_residual(sd, f"processor.block.{m.group(1)}",
                                           proc_t[name])
    enc, enc_stats = _convert_encoder(sd, "enc", params["enc"])
    want, got = flatten_dict(params), flatten_dict({"processor": proc,
                                                    "enc": enc})
    missing = [k for k in want if k not in got]
    if missing:
        raise KeyError(f"unconverted target params: "
                       f"{['/'.join(k) for k in missing][:10]}")
    out = {}
    for k, ref in want.items():
        arr = np.asarray(got[k], dtype=np.asarray(ref).dtype)
        if arr.shape != np.shape(ref):
            raise ValueError(
                f"shape mismatch at {'/'.join(k)}: torch {arr.shape} "
                f"vs target {np.shape(ref)}")
        out[k] = arr
    variables = {"params": unflatten_dict(out)}
    if batch_stats is not None:
        got_s = flatten_dict({"enc": enc_stats})
        out_s = {}
        for k, ref in flatten_dict(batch_stats).items():
            if k not in got_s:
                raise KeyError(f"unconverted batch stat: {'/'.join(k)}")
            out_s[k] = np.asarray(got_s[k], np.asarray(ref).dtype)
        variables["batch_stats"] = unflatten_dict(out_s)
    unknown = sorted(set(sd) - sd.used)
    if unknown:
        logger.warning("%d reference state_dict key(s) not imported: %s",
                       len(unknown), ", ".join(unknown[:20]))
    variables["unknown"] = unknown
    return variables


def import_reference_checkpoint(path: str, model) -> list:
    """Load a reference ``state_dict`` file (torch ``.pt``) into the port
    model ``model`` in place (``strict=True``); returns the state-dict
    keys it did not need."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    params, stats = to_jax_params(model)
    v = convert_state_dict(sd, params, stats)
    model.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                          strict=True)
    return v["unknown"]
