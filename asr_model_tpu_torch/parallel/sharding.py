"""Data, tensor and expert parallelism: the sharding rules, the in-place
sharding of a model, and the sharded train step.

The counterpart of ``asr_model_tpu/parallel/sharding.py``.  The JAX
package annotates the flax tree and lets XLA insert the collectives;
here a rank holds its blocks of the sharded weights and the modules sum
or gather over the axis where the Megatron pairing needs it:

* ``TP_RULES`` are the JAX package's rules over the port's parameter
  names.  A flax ``kernel`` is (in, out) and an ``nn.Linear.weight``
  (out, in), so flax ``P(None, "model")`` (column-parallel: the output
  features) is dim 0 here and ``P("model", None)`` (row-parallel) dim 1;
  the token embedding's vocabulary rows and the MoE experts' (E, in,
  out) kernels keep their flax dims.  kv_proj's rows are the K rows then
  the V rows: a rank takes its block of each (``CHUNKED``).
* ``param_pspec(model)`` is each parameter's rule (else replicated);
  ``param_specs(model, mesh)`` falls back to replication where a
  dimension does not divide the axis, as the JAX package's
  ``_divisible`` does, but for a whole Megatron pair at once (a sharded
  q_proj needs its out_proj sharded), and for the attention where the
  heads do not divide the axis.
* ``shard_params(model, mesh)`` keeps this rank's block of every
  sharded parameter (in place: the ``nn.Parameter`` objects stay, so an
  optimizer built before or after sees the same ones) and marks the
  modules with their axis (``Dense.tp``/``tp_row``, ``Embed.tp``,
  ``Attention.tp``, ``MoEMLP.ep``).  ``unsharded(model)`` gives the
  whole parameters back for the duration (checkpoints, a restore),
  ``full_state_dict`` a gathered ``state_dict``.
* ``batch_shardings`` / ``batch_rows``: the batch's rows over ``data``;
  a batch whose rows do not divide the axis is replicated, as the JAX
  package replicates a ragged tail batch.
* ``make_sharded_train_step`` is ``train/loop.py:make_train_step`` over
  the mesh, with the same contract (``step(batch, gen) -> (loss, gnorm,
  jstat)``, the whole batch given on every rank).  Every rank's loss is
  its share of one sum over the ranks: its rows' cross entropy over the
  whole batch's count of labels, over the number of ranks that compute
  the same rows; the batch-coupled statistics are the whole batch's
  (``parallel/context.py:batch_pmean``); each gradient is summed over
  the ranks that hold the same block of its parameter; the grad norm
  counts each block once.  MaxFactor sees whole tensors, as under the
  JAX package's mesh step, whose optimizer state is replicated: the
  sharded parameters and their gradients are gathered for the update
  (``GatheredOptimizer``), and each rank keeps its block of the result.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Optional, Tuple

import torch

from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.parallel.mesh import Mesh, psum

TP_RULES = (
    # (port parameter name regex, axis per dimension)
    (r"(^|\.)q_proj\.weight$", ("model", None)),
    (r"(^|\.)kv_proj\.weight$", ("model", None)),
    (r"(^|\.)c_proj\.weight$", ("model", None)),
    (r"(^|\.)q_proj\.bias$", ("model",)),
    (r"(^|\.)kv_proj\.bias$", ("model",)),
    (r"(^|\.)c_proj\.bias$", ("model",)),
    (r"(^|\.)out_proj\.weight$", (None, "model")),
    (r"(^|\.)mlp_in\.weight$", ("model", None)),
    (r"(^|\.)mlp_in\.bias$", ("model",)),
    (r"(^|\.)mlp_out\.weight$", (None, "model")),
    (r"(^|\.)mlp1\.weight$", ("model", None)),
    (r"(^|\.)mlp1\.bias$", ("model",)),
    (r"(^|\.)mlp2\.weight$", (None, "model")),
    (r"(^|\.)token\.weight$", ("model", None)),
    # EP: the experts' leading E axis over 'expert', and within each
    # expert the column / row pairing over 'model'
    (r"experts\.w_in\.kernel$", ("expert", None, "model")),
    (r"experts\.w_in\.bias$", ("expert", "model")),
    (r"experts\.w_out\.kernel$", ("expert", "model", None)),
    (r"experts\.w_out\.bias$", ("expert", None)),
)
# parameters whose dim 0 is two stacked blocks, each split over the axis
CHUNKED = (r"(^|\.)kv_proj\.(weight|bias)$",)


def param_pspec(model) -> Dict[str, tuple]:
    """{parameter name: axis per dimension} by ``TP_RULES`` (``()``:
    replicated), before any fallback."""
    out = {}
    for name, _p in model.named_parameters():
        out[name] = ()
        for pat, spec in TP_RULES:
            if re.search(pat, name):
                out[name] = spec
                break
    return out


def _chunks(name: str) -> int:
    return 2 if any(re.search(p, name) for p in CHUNKED) else 1


def _divisible(t: torch.Tensor, spec: tuple, mesh: Mesh, chunks: int) -> bool:
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        if ax not in mesh.shape or dim >= t.dim():
            return False
        n = mesh.shape[ax] * (chunks if dim == 0 else 1)
        if t.shape[dim] % n:
            return False
    return True


def _units(model):
    """The groups of parameter-name prefixes that shard together (a
    Megatron pair and what shares its layout), with the extra
    divisibility each needs: [(prefix, [leaf modules], heads)]."""
    from asr_model_tpu_torch.models.attention import Attention
    from asr_model_tpu_torch.models.decoder import Processor, Residual
    from asr_model_tpu_torch.models.moe import MoEMLP
    from asr_model_tpu_torch.models.sheath import MSheath
    units = []
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, Attention):
            units.append((pre, ["q_proj", "kv_proj", "out_proj"], mod.head))
        elif isinstance(mod, Residual) and mod.moe is None:
            units.append((pre, ["mlp_in", "mlp_out"], None))
        elif isinstance(mod, MSheath):
            units.append((pre, ["mlp1", "mlp2"], None))
        elif isinstance(mod, Processor):
            units.append((pre, ["token"], None))
        elif isinstance(mod, MoEMLP):
            units.append((pre + "experts.", ["w_in", "w_out"], None))
    return units


def param_specs(model, mesh: Mesh) -> Dict[str, Tuple[tuple, int]]:
    """{name: (axis per dimension, chunks)} of the parameters this mesh
    shards (the others are replicated): a unit shards only where every
    one of its parameters divides and, for the attention, the heads
    divide the ``model`` axis."""
    rules = param_pspec(model)
    params = dict(model.named_parameters())
    out = {}
    for pre, leaves, heads in _units(model):
        names = [n for n in params
                 if any(n.startswith(pre + lf + ".") for lf in leaves)
                 and rules.get(n)]
        if not names:
            continue
        # the axes this unit would use, each of size > 1
        specs = {n: tuple(a if a is not None and mesh.shape.get(a, 1) > 1
                          else None for a in rules[n]) for n in names}
        if all(all(a is None for a in s) for s in specs.values()):
            continue
        ok = all(_divisible(params[n], s, mesh, _chunks(n))
                 for n, s in specs.items())
        if heads is not None and heads % mesh.shape.get("model", 1):
            ok = False
        if not ok:
            # the expert split alone still applies where it divides
            specs = {n: tuple(a if a == "expert" else None for a in s)
                     for n, s in specs.items()}
            if all(all(a is None for a in s) for s in specs.values()) or \
                    not all(_divisible(params[n], s, mesh, _chunks(n))
                            for n, s in specs.items()):
                continue
        for n, s in specs.items():
            if any(a is not None for a in s):
                out[n] = (s, _chunks(n))
    return out


def _ranges(size: int, n: int, i: int, chunks: int):
    c = size // chunks
    w = c // n
    return [(k * c + i * w, k * c + (i + 1) * w) for k in range(chunks)]


def take_block(full: torch.Tensor, spec: tuple, mesh: Mesh,
               chunks: int = 1) -> torch.Tensor:
    """This rank's block of a whole tensor."""
    t = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        rs = _ranges(full.shape[dim], mesh.shape[ax], mesh.coords[ax],
                     chunks if dim == 0 else 1)
        t = torch.cat([t.narrow(dim, a, b - a) for a, b in rs], dim=dim)
    return t.contiguous()


def gather_block(local: torch.Tensor, spec: tuple, mesh: Mesh,
                 chunks: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's block (a sum of zero-padded
    blocks over the ranks that hold the other blocks; no gradient)."""
    t = local.detach()
    axes = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes.append(ax)
        n, i = mesh.shape[ax], mesh.coords[ax]
        size = t.shape[dim] * n
        idx = torch.cat([torch.arange(a, b, device=t.device) for a, b in
                         _ranges(size, n, i, chunks if dim == 0 else 1)])
        shape = list(t.shape)
        shape[dim] = size
        t = t.new_zeros(shape).index_copy_(dim, idx, t)
    return psum(t, mesh.axis(*axes)) if axes else t


def _mark(model, specs, mesh: Mesh) -> None:
    """Tell the modules which axis their weights are split over."""
    from asr_model_tpu_torch.models.attention import Attention
    from asr_model_tpu_torch.models.moe import MoEMLP, StackedDense
    from asr_model_tpu_torch.models.tlayers import Dense, Embed
    model_ax = mesh.axis("model") if "model" in mesh.shape else None
    for name, mod in model.named_modules():
        w = specs.get(name + ".weight") or specs.get(name + ".kernel")
        if isinstance(mod, (Dense, StackedDense)) and w is not None \
                and "model" in w[0]:
            mod.tp = model_ax
            mod.tp_row = w[0][-1] == "model" if isinstance(mod, Dense) \
                else w[0][1] == "model"
        elif isinstance(mod, Embed) and w is not None:
            mod.tp = model_ax
        elif isinstance(mod, Attention) and (name + ".q_proj.weight") in specs:
            mod.tp = model_ax
        elif isinstance(mod, MoEMLP) and \
                "expert" in specs.get(name + ".experts.w_in.kernel",
                                      ((),))[0]:
            mod.ep = mesh.axis("expert")


def shard_params(model, mesh: Mesh):
    """Keep this rank's block of every parameter ``param_specs`` shards
    (in place) and mark the modules; returns the model.  Its
    ``_shard_specs`` maps each sharded ``nn.Parameter`` to (spec,
    chunks)."""
    specs = param_specs(model, mesh)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, (s, c) in specs.items():
            params[n].data = take_block(params[n].data, s, mesh, c).clone()
    _mark(model, specs, mesh)
    model._mesh = mesh
    model._shard_specs = {params[n]: sc for n, sc in specs.items()}
    return model


def sharded(model) -> dict:
    """{parameter: (spec, chunks)} of a model ``shard_params`` sharded."""
    return getattr(model, "_shard_specs", {})


@contextlib.contextmanager
def unsharded(model):
    """The whole parameters in place of the blocks for the duration (a
    collective: every rank enters); what is written to them inside is
    cut back to the blocks on exit."""
    specs = sharded(model)
    mesh = getattr(model, "_mesh", None)
    with torch.no_grad():
        for p, (s, c) in specs.items():
            p.data = gather_block(p.data, s, mesh, c)
    try:
        yield model
    finally:
        with torch.no_grad():
            for p, (s, c) in specs.items():
                p.data = take_block(p.data, s, mesh, c).clone()


def full_numel(model) -> int:
    """The unsharded model's parameter count."""
    specs = sharded(model)
    n = 0
    for p in model.parameters():
        k = p.numel()
        for ax in (specs[p][0] if p in specs else ()):
            if ax is not None:
                k *= model._mesh.shape[ax]
        n += k
    return n


def full_state_dict(model) -> dict:
    """The unsharded ``state_dict`` (every rank gets it)."""
    with unsharded(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}


def batch_shardings(batch: dict, mesh: Mesh) -> dict:
    """{key: ("data",) or ()} per batch entry: rows over 'data' where
    they divide it, else replicated."""
    n = mesh.shape.get("data", 1)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] if getattr(v, "dim", lambda: 0)() else 0
        out[k] = ("data",) if rows > 0 and rows % n == 0 else ()
    return out


def batch_rows(batch: dict, mesh: Mesh):
    """(this rank's rows of ``batch``, whether they are a block of a
    batch sharded over 'data')."""
    ax = mesh.axis("data")
    spec = batch_shardings(batch, mesh)
    if ax.size == 1 or any(s == () for s in spec.values()):
        return batch, False
    return {k: v.chunk(ax.size, dim=0)[ax.index]
            for k, v in batch.items()}, True


class GatheredOptimizer:
    """The optimizer's step on whole tensors: each sharded parameter and
    its gradient are gathered, the wrapped optimizer (MaxFactor or
    MultiSteps, built over the model's parameters) updates them, and the
    rank keeps its block.  The state is the whole tensors', as the JAX
    mesh step replicates it."""

    def __init__(self, opt, model):
        self.opt, self.model = opt, model

    def __getattr__(self, name):
        return getattr(self.__dict__["opt"], name)

    @torch.no_grad()
    def step(self):
        specs = sharded(self.model)
        mesh = self.model._mesh if specs else None
        for p, (s, c) in specs.items():
            g = p.grad
            p.data = gather_block(p.data, s, mesh, c)
            p.grad = None if g is None else gather_block(g, s, mesh, c)
        try:
            self.opt.step()
        finally:
            for p, (s, c) in specs.items():
                p.data = take_block(p.data, s, mesh, c).clone()
                p.grad = None


def _reduce_groups(model, mesh: Mesh):
    """Per parameter: the group its gradient is summed over (the ranks
    holding the same block) and the axes its blocks span."""
    specs = sharded(model)
    out = []
    for p in model.parameters():
        axes = tuple(a for a in (specs[p][0] if p in specs else ())
                     if a is not None)
        out.append((mesh.others(*axes), axes))
    return out


def make_sharded_train_step(model, opt, mesh: Mesh,
                            clip_grad_norm: float = 0.0,
                            compute_dtype: Optional[torch.dtype] = None,
                            remat: bool = False, remat_policy: str = "dots"):
    """The DP / TP / EP train step (module doc): ``step(batch, gen) ->
    (loss, gnorm, jstat)``, ``batch`` the whole batch on every rank,
    ``gen`` the run's generator (the same seed on every rank), ``opt``
    the optimizer over the model's parameters after ``shard_params``.
    The loss, grad norm and jump counter returned are the whole batch's,
    the same on every rank."""
    from asr_model_tpu_torch.models import stochastic
    from asr_model_tpu_torch.models.model import cross_entropy_sum
    from asr_model_tpu_torch.train.loop import remat_context, train_forward
    context = remat_context(remat_policy)
    model.requires_grad_(True)
    params = list(model.parameters())
    groups = _reduce_groups(model, mesh)
    gopt = opt if isinstance(opt, GatheredOptimizer) \
        else GatheredOptimizer(opt, model)
    data = mesh.axis("data")
    # ranks that compute the same rows: every axis but 'data'
    same_rows = mesh.size // data.size
    moe_w = model.cfg.moe_aux_weight if model.cfg.moe_experts > 0 else 0.0

    def loss_parts(batch, gen):
        out = train_forward(model, batch, gen, compute_dtype)
        return (*cross_entropy_sum(out["logits"].float(), batch["labels"]),
                out)

    def step(batch, gen):
        rows, split = batch_rows(batch, mesh)
        # the whole-batch terms are computed alike by every rank of a
        # group of `same`; the rows' cross entropy by `same_rows`
        same = same_rows * (1 if split else data.size)
        with stochastic.remat(remat), \
                pctx.batch_pmean(data if split else None):
            if remat:
                ce, count, out = stochastic.checkpoint(
                    loss_parts, rows, gen, gen=gen, context_fn=context)
            else:
                ce, count, out = loss_parts(rows, gen)
            n_labels = torch.clamp(pctx.batch_sum(count.detach()), min=1.0)
            part = ce / n_labels / same
            if moe_w:
                part = part + moe_w * out["moe_aux"] / (same_rows * data.size)
            grads = torch.autograd.grad(part, params, allow_unused=True)
        with torch.no_grad():
            sq: Dict[tuple, torch.Tensor] = {}
            summed = []
            for p, g, (grp, axes) in zip(params, grads, groups):
                if g is None:
                    summed.append(None)
                    continue
                g = psum(g, grp)
                summed.append(g)
                sq[axes] = sq.get(axes, 0.0) + g.float().pow(2).sum()
            gsq = sum(psum(torch.as_tensor(v, device=part.device),
                           mesh.axis(*axes)) for axes, v in sq.items())
            gnorm = torch.sqrt(torch.as_tensor(gsq, device=part.device,
                                               dtype=torch.float32))
            if clip_grad_norm > 0:
                factor = torch.clamp(clip_grad_norm / (gnorm + 1e-6),
                                     max=1.0)
                summed = [None if g is None else g * factor.to(g.dtype)
                          for g in summed]
            for p, g in zip(params, summed):
                p.grad = g
            gopt.step()
            for p in params:
                p.grad = None
            model.apply_batch_stats(out["batch_stats"])
            ce_all = psum(ce.detach(), data) if split else ce.detach()
            loss = ce_all / n_labels
            if moe_w:
                loss = loss + moe_w * out["moe_aux"].detach()
            jstat = out["jstat"]
            if split:
                jstat = psum(jstat, data)
        return loss, gnorm, jstat

    step.optimizer = gopt
    return step
