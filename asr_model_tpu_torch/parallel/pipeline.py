"""Pipeline parallelism (GPipe) over the chained block stack: the
counterpart of ``asr_model_tpu/parallel/pipeline.py``.

The JAX package runs the schedule as one SPMD scan over ``M + P - 1``
ticks with the blocks stacked on a ``pipe``-sharded axis.  Here the
ranks of a ``(data, pipe)`` mesh (``mesh.make_pipe_mesh``) are
processes and the model keeps its per-block modules: stage ``s`` of
``P`` runs blocks ``[s L/P, (s + 1) L/P)``.

* Forward.  Every rank runs the encoder and the token embedding on its
  data block of every microbatch (batch statistics over the whole batch,
  ``parallel/context.py:batch_pmean``).  Then each stage takes the
  microbatches in order: stage 0 from the embedding, the others
  receiving the carry ``g`` from the previous stage, runs its blocks
  (``Processor.block_forward``) and sends its ``g`` on; stage ``s``
  works on microbatch ``t - s`` at tick ``t``, so the schedule is
  GPipe's ``M + P - 1`` ticks with its bubble.  MSheath's control
  scalars are means over the data shards of one microbatch, as in JAX:
  the microbatch is the unit of the jump control.  The last stage runs
  the logits head.
* Backward.  The stage boundaries are cut (the carry a stage receives,
  the encoder outputs it reads and the head's inputs are leaves), and
  each stage runs autograd on its piece: the last stage from the loss,
  the others from the carry gradient the next stage sends back, every
  stage taking the microbatches in the same order, so each send meets
  its receive and no pair waits on the other.  Last, every rank runs the
  encoder / embedding piece's backward from the gradients its stage's
  pieces left at the leaves.  The gradients of the shared parameters
  (encoder, embedding, head) are summed over every rank, a block's over
  its stage's data group; the grad norm counts each once.
* The optimizer stays MaxFactor per tensor (what the JAX package's
  ``make_pp_optimizer`` vmap exists to keep): a stage's optimizer holds
  the shared parameters and its own blocks' (``stage_params``).
* Checkpoints use the JAX package's pipeline layout
  (``processor/blocks`` stacked on a leading layer axis, the optimizer
  state as ``{"base", "blocks"}`` with the blocks' ``step`` of shape
  (L,)): ``to_pipeline_params`` / ``from_pipeline_params`` and
  ``to_pipeline_opt_state`` / ``from_pipeline_opt_state`` over the flax
  trees of ``weights.to_jax_params`` and ``train/checkpoint.py:
  opt_state_tree``.
* The train step's gumbel and dropout draws come from one generator per
  (block, microbatch), one for the encoder and one for the head, each
  seeded from the step's generator: a valid stream, different from the
  unsharded step's (the JAX package's PP stream differs from its
  unsharded one likewise).  MoE and tensor parallelism are refused, as
  in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.model import (cross_entropy_sum,
                                              modality_slots)
from asr_model_tpu_torch.parallel import context as pctx
from asr_model_tpu_torch.parallel.mesh import Mesh, broadcast_from, psum
from asr_model_tpu_torch.train.loop import FEATURE_KEYS


def check_pipeline(model, mesh: Mesh, microbatches: int,
                   rows: Optional[int] = None) -> None:
    """The JAX package's refusals: a chained stack, layers that divide
    the stages, no MoE, rows that divide into microbatches whose rows
    divide the data axis."""
    if not model.cfg.chained_blocks:
        raise ValueError("pipeline parallelism needs chained_blocks=True "
                         "(parity mode runs a single live block)")
    if model.cfg.moe_experts > 0:
        raise ValueError("mesh_pipe does not compose with MoE (the "
                         "pipeline schedule's loss does not collect the "
                         "load-balance aux)")
    P = mesh.shape["pipe"]
    if model.dims.layer % P:
        raise ValueError(f"layer {model.dims.layer} not divisible by pipe "
                         f"axis {P}")
    if rows is not None:
        if rows % microbatches:
            raise ValueError(f"batch {rows} not divisible by microbatches "
                             f"{microbatches}")
        if (rows // microbatches) % mesh.shape["data"]:
            raise ValueError(f"microbatch rows {rows // microbatches} must "
                             f"divide mesh_data {mesh.shape['data']}")


def stage_blocks(model, mesh: Mesh) -> List[int]:
    """The block indices this rank's stage runs."""
    P, s = mesh.shape["pipe"], mesh.coords["pipe"]
    k = model.dims.layer // P
    return list(range(s * k, (s + 1) * k))


def stage_params(model, mesh: Mesh) -> list:
    """(name, parameter) of what this stage updates: every parameter
    outside the block stack and its own blocks'."""
    own = {f"processor.block{i}." for i in stage_blocks(model, mesh)}
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("processor.block")
            or any(n.startswith(o) for o in own)]


def _mb_rows(t, M: int, data):
    """This data rank's rows of each of the M microbatches of ``t``."""
    out = []
    for mb in t.chunk(M, dim=0):
        out.append(mb.chunk(data.size, dim=0)[data.index]
                   if data.size > 1 else mb)
    return out


def _join_rows(parts, data):
    """The whole batch from each microbatch's data blocks."""
    from asr_model_tpu_torch.parallel.mesh import gather
    return torch.cat([gather(p, 0, data) for p in parts], dim=0)


def _seed_gens(gen, n: int, device):
    """n generators seeded from ``gen`` (the same on every rank)."""
    if gen is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def _send(t, dst_group_rank: int, hops):
    dist.send(t.contiguous(), dist.get_global_rank(hops.group,
                                                   dst_group_rank),
              group=hops.group)


def _recv(like, src_group_rank: int, hops):
    t = torch.empty_like(like)
    dist.recv(t, dist.get_global_rank(hops.group, src_group_rank),
              group=hops.group)
    return t


def _schedule(model, batch, mesh: Mesh, M: int, train: bool, gen,
              differentiable: bool, need_grad: bool):
    """The forward of every piece (module doc).  Returns a dict with the
    stage's pieces for ``_backward``, this rank's data rows of the
    labels, and, on the last stage, the head's leaves and logits."""
    pipe, data = mesh.axis("pipe"), mesh.axis("data")
    P, s = pipe.size, pipe.index
    proc = model.processor
    dev = batch["text_ids"].device
    rows = {k: torch.cat(_mb_rows(batch[k], M, data))
            for k in ("text_ids", *FEATURE_KEYS) if batch.get(k) is not None}
    blocks = stage_blocks(model, mesh)
    # the encoder's, each (block, microbatch)'s, the head's
    gens = _seed_gens(gen, 2 + model.dims.layer * M, dev)
    st = {"jstat": torch.zeros(3, dtype=torch.int32, device=dev)}
    with torch.set_grad_enabled(need_grad), pctx.batch_pmean(data):
        with stochastic.mode(train, gens[0], differentiable) as rec:
            xa = model.encode(modality_slots(rows.get("pitch"),
                                             rows.get("spectrogram"),
                                             rows.get("waveform")))
            x = proc.embed(rows["text_ids"])
            st["batch_stats"] = dict(rec.batch_stats)
        # the pipe region's inputs, as leaves (identical slots share one)
        leaves, xa_leaf = {}, {}
        for k, t in xa.items():
            if id(t) not in leaves:
                leaves[id(t)] = (t, t.detach().requires_grad_(need_grad))
            xa_leaf[k] = leaves[id(t)][1]
        x_leaf = x.detach().requires_grad_(need_grad)
        st["a_out"] = [x] + [t for t, _ in leaves.values()]
        st["a_leaf"] = [x_leaf] + [lf for _, lf in leaves.values()]
        xa_mb = {k: t.chunk(M, dim=0) for k, t in xa_leaf.items()}
        x_mb = x_leaf.chunk(M, dim=0)
        pieces = []
        for mb in range(M):
            if s == 0:
                inp = x_mb[mb]
            else:
                inp = _recv(x_mb[mb], s - 1, mesh.hops).requires_grad_(need_grad)
            h, d = inp, None
            for i in blocks:
                with stochastic.mode(train, gens[1 + i * M + mb],
                                     differentiable) as rec:
                    d, h = proc.block_forward(
                        getattr(proc, f"block{i}"), h,
                        {k: v[mb] for k, v in xa_mb.items()})
                    if rec.jstat is not None:
                        st["jstat"] = st["jstat"] + rec.jstat
            if s < P - 1:
                _send(h.detach(), s + 1, mesh.hops)
            pieces.append((inp, d, h))
        st["pieces"] = pieces
        st["labels"] = torch.cat(_mb_rows(batch["labels"], M, data))
        if s == P - 1:
            d_leaf = torch.cat([p[1] for p in pieces]).detach() \
                .requires_grad_(need_grad)
            g_leaf = torch.cat([p[2] for p in pieces]).detach() \
                .requires_grad_(need_grad)
            st["head_leaf"] = (d_leaf, g_leaf)
            with stochastic.mode(train, gens[-1], differentiable):
                st["logits"] = proc.logits_head(d_leaf, g_leaf, seq=False)
    return st


def _backward(st, mesh: Mesh, M: int, loss_part=None) -> None:
    """Each piece's backward, in the schedule's order (module doc)."""
    pipe = mesh.axis("pipe")
    P, s = pipe.size, pipe.index
    pieces = st["pieces"]
    if s == P - 1:
        loss_part.backward()
        d_leaf, g_leaf = st["head_leaf"]
        gd, gg = d_leaf.grad.chunk(M), g_leaf.grad.chunk(M)
    for mb, (inp, d, g) in enumerate(pieces):
        if s == P - 1:
            torch.autograd.backward([d, g], [gd[mb], gg[mb]])
        else:
            torch.autograd.backward(g, _recv(g, s + 1, mesh.hops))
        if s > 0:
            _send(inp.grad, s - 1, mesh.hops)
    outs, grads = [], []
    for out, leaf in zip(st["a_out"], st["a_leaf"]):
        if leaf.grad is not None:
            outs.append(out)
            grads.append(leaf.grad)
    if outs:
        torch.autograd.backward(outs, grads)


@torch.no_grad()
def pipeline_forward(model, batch: dict, mesh: Mesh, microbatches: int):
    """The eval logits of the whole batch (on every rank) with the block
    stack pipelined over 'pipe' and the rows over 'data'."""
    check_pipeline(model, mesh, microbatches, batch["text_ids"].shape[0])
    st = _schedule(model, batch, mesh, microbatches, train=False, gen=None,
                   differentiable=False, need_grad=False)
    pipe, data = mesh.axis("pipe"), mesh.axis("data")
    logits = st.get("logits")
    if logits is None:
        shape = st["pieces"][0][2].shape[:-1] + (model.dims.tokens,)
        logits = torch.zeros((shape[0] * microbatches,) + shape[1:],
                             dtype=torch.promote_types(
                                 st["pieces"][0][2].dtype, torch.float32),
                             device=batch["text_ids"].device)
    logits = broadcast_from(logits, pipe, pipe.size - 1)
    return _join_rows(logits.chunk(microbatches, dim=0), data)


def _reduce_grads(model, mesh: Mesh, named):
    """Sum each gradient over the ranks that hold the same parameter;
    returns the squared grad norm (each parameter once)."""
    everyone = mesh.axis("data", "pipe")
    data = mesh.axis("data")
    gsq_base = gsq_blocks = None
    for n, p in named:
        block = n.startswith("processor.block")
        if p.grad is None:
            if block:       # unused on every rank of the stage alike
                continue
            # a shared parameter some stage does not reach (the head's
            # norm before the last stage)
            p.grad = torch.zeros_like(p)
        p.grad = psum(p.grad, data if block else everyone)
        sq = p.grad.float().pow(2).sum()
        if block:
            gsq_blocks = sq if gsq_blocks is None else gsq_blocks + sq
        else:
            gsq_base = sq if gsq_base is None else gsq_base + sq
    dev = next(model.parameters()).device
    zero = torch.zeros((), device=dev)
    gsq_blocks = psum(zero if gsq_blocks is None else gsq_blocks,
                      mesh.axis("pipe"))
    return (zero if gsq_base is None else gsq_base) + gsq_blocks


def pipeline_grads(model, batch: dict, mesh: Mesh, microbatches: int
                   ) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} of the eval cross entropy (eval
    semantics on the differentiable routes) through the pipeline, every
    block's from its stage, on every rank."""
    check_pipeline(model, mesh, microbatches, batch["text_ids"].shape[0])
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    st = _schedule(model, batch, mesh, microbatches, train=False, gen=None,
                   differentiable=True, need_grad=True)
    part = None
    data = mesh.axis("data")
    if "logits" in st:
        ce, count = cross_entropy_sum(st["logits"], st["labels"])
        part = ce / torch.clamp(psum(count.detach(), data), min=1.0)
    with pctx.batch_pmean(data):
        _backward(st, mesh, microbatches, part)
    named = list(model.named_parameters())
    _reduce_grads(model, mesh, stage_params(model, mesh))
    out = {}
    pipe = mesh.axis("pipe")
    k = model.dims.layer // pipe.size
    for n, p in named:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if n.startswith("processor.block"):
            i = int(n[len("processor.block"):].split(".")[0])
            g = broadcast_from(g, pipe, i // k)
        out[n] = g.detach().clone()
        p.grad = None
    return out


def make_pp_train_step(model, opt, mesh: Mesh, microbatches: int,
                       clip_grad_norm: float = 0.0, compute_dtype=None,
                       remat: bool = False):
    """The PP(+DP) train step: ``step(batch, gen) -> (loss, gnorm,
    jstat)`` like ``train/loop.py:make_train_step``, ``batch`` the whole
    batch on every rank, ``opt`` built over ``stage_params`` (MaxFactor
    per tensor).  The loss, grad norm and jump counter are the whole
    batch's, on every rank.  bf16 compute is not implemented here yet."""
    if compute_dtype is not None:
        raise ValueError("the pipeline train step runs in float32 only")
    check_pipeline(model, mesh, microbatches)
    model.requires_grad_(True)
    named = stage_params(model, mesh)
    pipe, data = mesh.axis("pipe"), mesh.axis("data")
    M = microbatches

    def step(batch, gen):
        check_pipeline(model, mesh, M, batch["text_ids"].shape[0])
        with stochastic.remat(remat):
            st = _schedule(model, batch, mesh, M, train=True, gen=gen,
                           differentiable=False, need_grad=True)
            part = None
            ce = torch.zeros((), device=batch["text_ids"].device)
            if "logits" in st:
                ce, count = cross_entropy_sum(st["logits"], st["labels"])
                n_labels = torch.clamp(psum(count.detach(), data), min=1.0)
                part = ce / n_labels
            # a checkpointed piece's recompute runs in the backward and
            # reads the batch's sharding
            with pctx.batch_pmean(data):
                _backward(st, mesh, M, part)
        with torch.no_grad():
            gsq = _reduce_grads(model, mesh, named)
            gnorm = torch.sqrt(gsq.float())
            if clip_grad_norm > 0:
                factor = torch.clamp(clip_grad_norm / (gnorm + 1e-6),
                                     max=1.0)
                for _n, p in named:
                    if p.grad is not None:
                        p.grad.mul_(factor.to(p.grad.dtype))
            opt.step()
            for _n, p in model.named_parameters():
                p.grad = None
            model.apply_batch_stats(st["batch_stats"])
            loss = part.detach() if part is not None else ce.detach()
            loss = broadcast_from(psum(loss, data), pipe, pipe.size - 1)
            jstat = psum(st["jstat"], mesh.axis("data", "pipe"))
        return loss, gnorm, jstat

    return step


# ---------------------------------------------------------------------------
# checkpoints in the JAX package's pipeline layout


def _split_blocks(tree: dict):
    proc = dict(tree["processor"])
    blocks, i = [], 0
    while f"block{i}" in proc:
        blocks.append(proc.pop(f"block{i}"))
        i += 1
    out = dict(tree)
    out["processor"] = proc
    return out, blocks


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def to_pipeline_params(params: dict) -> dict:
    """processor/block{i} subtrees -> one stacked processor/blocks
    subtree (leading axis the layer)."""
    base, blocks = _split_blocks(params)
    if len(blocks) < 2:
        raise ValueError("pipeline params need a chained stack (layer>=2)")
    base["processor"] = dict(base["processor"], blocks=_stack(blocks))
    return base


def from_pipeline_params(pp_params: dict) -> dict:
    """Inverse of ``to_pipeline_params``."""
    proc = dict(pp_params["processor"])
    stacked = proc.pop("blocks")
    L = len(next(iter(_leaves(stacked))))
    for i in range(L):
        proc[f"block{i}"] = _unstack(stacked, i)
    out = dict(pp_params)
    out["processor"] = proc
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def to_pipeline_opt_state(state: dict) -> dict:
    """An unsharded MaxFactor state tree (``opt_state_tree``) -> the
    ``{"base", "blocks"}`` layout of ``make_pp_optimizer``."""
    base, blocks = {}, {}
    for key in ("row_var", "col_var", "v"):
        b, bl = _split_blocks(state[key])
        base[key], blocks[key] = b, _stack(bl)
    L = len(next(iter(_leaves(blocks["row_var"]))))
    step = np.asarray(state["step"])
    return {"base": {"step": step, **base},
            "blocks": {"step": np.broadcast_to(step, (L,)).copy(),
                       **blocks}}


def from_pipeline_opt_state(pp_state: dict) -> dict:
    """Inverse of ``to_pipeline_opt_state``: base.step is the step."""
    out = {"step": np.asarray(pp_state["base"]["step"])}
    for key in ("row_var", "col_var", "v"):
        base = pp_state["base"][key]
        out[key] = from_pipeline_params(
            dict(base, processor=dict(base["processor"],
                                      blocks=pp_state["blocks"][key])))
    return out


@torch.no_grad()
def sync_blocks(model, mesh: Mesh) -> None:
    """Every rank's copy of every block set to its stage's (a collective
    over 'pipe')."""
    pipe = mesh.axis("pipe")
    k = model.dims.layer // pipe.size
    for n, p in model.named_parameters():
        if n.startswith("processor.block"):
            i = int(n[len("processor.block"):].split(".")[0])
            p.copy_(broadcast_from(p, pipe, i // k))


def pipeline_training_state(model, opt, mesh: Mesh, step: int,
                            gen=None) -> dict:
    """``train/checkpoint.py:training_state`` in the pipeline layout,
    gathered from the stages (every rank calls it; the blocks' state
    comes from their stages)."""
    from asr_model_tpu_torch.train import checkpoint as ckpt
    from asr_model_tpu_torch.weights import jax_layout
    sync_blocks(model, mesh)
    pipe = mesh.axis("pipe")
    k = model.dims.layer // pipe.size
    state = ckpt.training_state(model, opt, step, gen)
    layout = jax_layout(model)
    tree = state["opt_state"]
    for n, p in model.named_parameters():
        if not n.startswith("processor.block"):
            continue
        i = int(n[len("processor.block"):].split(".")[0])
        _c, path, _perm = layout[n]
        for key in ("row_var", "col_var", "v"):
            node = tree[key]
            for part in path[:-1]:
                node = node[part]
            a = torch.from_numpy(np.ascontiguousarray(node[path[-1]])).to(
                p.device)
            node[path[-1]] = broadcast_from(a, pipe, i // k).cpu().numpy()
    state["params"] = to_pipeline_params(state["params"])
    state["opt_state"] = to_pipeline_opt_state(tree)
    return state
