"""Training and evaluation, single device: the counterpart of
``asr_model_tpu/train/loop.py``.

* ``make_optimizer(cfg, model)``: MaxFactor over the two bias groups
  with the FAMScheduler2 rate, in the JAX layout of every parameter;
  ``acc_steps`` > 1 wraps it in ``MultiSteps`` (optax's accumulation).
* ``make_train_step(model, opt, clip_grad_norm, compute_dtype, remat,
  remat_policy)``: one step of forward (train mode, the step's
  generator; an MoE model's loss adds ``moe_aux_weight`` times its
  aux), backward, global grad norm (accumulated in f32), clipping
  by ``clip_grad_norm`` and the optimizer; returns (loss, gnorm, jstat)
  as device tensors (no host read).  ``compute_dtype=torch.bfloat16``
  is the JAX package's mixed precision: f32 master parameters and
  optimizer state, the loss
  evaluated through ``torch.func.functional_call`` on bf16 copies of the
  parameters and buffers and on bf16 float inputs (the gradients reach
  the masters through the casts), the cross entropy on f32 logits, and
  BatchNorm's new running statistics written back in f32.
  ``remat=True`` is the JAX package's remat: the loss under a
  checkpoint (``remat_policy`` "full" saves nothing of it, "dots" the
  outputs of the matrix products with no batch dimension) and each
  MSheath slot step under one of its own, which is what lowers the
  peak (``models/sheath.py``).
* ``make_grad_diagnostics(model)``: the per-parameter gradients of the
  eval loss (eval semantics on the differentiable routes), in the JAX
  layout under the flax names.
* ``grad_norm_controller``, ``make_eval_step`` (teacher-forced argmax),
  ``evaluate_model`` (free-running greedy WER).
* ``train_and_evaluate``: resume, ``config.json`` beside the
  checkpoints, the Prefetcher depth, the step loop with periodic eval
  and checkpoints, and the TensorBoard scalars under the JAX loop's
  names (``torch.utils.tensorboard`` when it imports, else none); with
  ``log_detail`` also the per-parameter grad norms and spectral
  entropies.  With ``RunConfig.mesh_*`` (or in a process group) every
  rank runs it: ``mesh_pipe`` > 1 the GPipe step over a (data, pipe)
  mesh (``parallel/pipeline.py``; checkpoints in the JAX package's
  pipeline layout, the final model unsharded with a fresh optimizer
  state, as the JAX loop writes them), else the DP / TP / EP step
  (``parallel/sharding.py``; checkpoints gathered to the unsharded
  layout).  Every rank reads the whole batch and takes its rows; the
  eval runs the whole eval batch on every rank (the TP ranks together;
  a pipeline's stages after the blocks are synced); rank 0 alone writes
  the checkpoints, the scalars and the prints.

The model's parameters are switched to ``requires_grad`` by
``make_train_step``; evaluation runs under ``torch.no_grad`` on the
eval route (the kernels).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from asr_model_tpu_torch.config import Config
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.model import Model, cross_entropy_ignore_pad
from asr_model_tpu_torch.optim.maxfactor import (MaxFactor, MultiSteps,
                                                 bias_groups)
from asr_model_tpu_torch.optim.schedules import fam_scheduler2
from asr_model_tpu_torch.train import checkpoint as ckpt
from asr_model_tpu_torch.train.metrics import (compute_metrics,
                                               spectral_entropy,
                                               track_grad_norms)
from asr_model_tpu_torch.weights import jax_layout

logger = logging.getLogger(__name__)

FEATURE_KEYS = ("spectrogram", "waveform", "pitch")


def make_optimizer(cfg: Config, model: Model, named=None):
    """(optimizer, schedule) for ``model``'s parameters (or for the
    (name, parameter) pairs ``named``: a pipeline stage's own)."""
    o = cfg.optim
    sched = fam_scheduler2(o.lr, warmup_steps=o.warmup_steps,
                           total_steps=o.total_steps,
                           decay_start=o.decay_start,
                           warmup_start=o.warmup_start, eta_min=o.eta_min)
    layout = jax_layout(model)
    named = list(model.named_parameters() if named is None else named)
    opt = MaxFactor(bias_groups(named, o.bias, o.jump_bias), lr=sched,
                    b_decay=o.b_decay, eps=tuple(o.eps), d=o.d,
                    decay=o.decay, gamma=o.gamma, maximize=o.maximize,
                    min_lr=o.min_lr, clip=o.clip, cap=o.cap,
                    # every parameter's layout, so a state read for one
                    # outside ``named`` (a pipeline checkpoint) is in it
                    layouts={p: layout[n][2]
                             for n, p in model.named_parameters()})
    if cfg.run.acc_steps > 1:
        opt = MultiSteps(opt, cfg.run.acc_steps)
    return opt, sched


def train_compute_dtype(run) -> Optional[torch.dtype]:
    """RunConfig.train_dtype -> the step's compute dtype (None: f32)."""
    name = run.train_dtype
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", None):
        return None
    raise ValueError(f"unsupported train_dtype {name!r} "
                     "(use 'float32' or 'bfloat16')")


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device`` (ids int64)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def _features(batch, dtype=None):
    out = {}
    for k in FEATURE_KEYS:
        v = batch.get(k)
        if v is not None:
            out[k] = v.to(dtype) if dtype is not None else v
    return out


# ``x @ W`` with x of 3 or more dimensions reaches aten.mm (on x's rows
# flattened, between two views) and ``F.linear`` aten.addmm: the matrix
# products with no batch dimension, which "dots" saves, as the JAX
# package's ``dots_with_no_batch_dims_saveable`` saves its dot_generals
# without batch dimensions; attention's batched products reach aten.bmm
# and are recomputed, as is everything else
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = ("dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    # inside a checkpointed MSheath slot step (depth 2) nothing is saved,
    # as JAX's inner jax.checkpoint saves nothing of its body
    if op in DOTS_SAVED and stochastic.checkpoint_depth() <= 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def train_forward(model: Model, batch, gen, compute_dtype=None) -> dict:
    """The train step's forward (``Model.forward(train=True, gen=)``);
    with a ``compute_dtype``, through ``torch.func.functional_call`` on
    casts of the float32 parameters and buffers and of the features."""
    if compute_dtype is None:
        return model(batch["text_ids"], **_features(batch), train=True,
                     gen=gen)
    cast = {n: t.to(compute_dtype) if t.dtype == torch.float32 else t
            for n, t in list(model.named_parameters())
            + list(model.named_buffers())}
    return torch.func.functional_call(
        model, cast, (batch["text_ids"],),
        dict(_features(batch, compute_dtype), train=True, gen=gen))


def remat_context(remat_policy: str):
    """The selective-checkpoint ``context_fn`` of a remat policy."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r} "
                         f"(one of {REMAT_POLICIES})")
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return (functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy)
            if remat_policy == "dots" else None)


def make_train_step(model: Model, opt, clip_grad_norm: float = 0.0,
                    compute_dtype: Optional[torch.dtype] = None,
                    remat: bool = False, remat_policy: str = "dots"):
    """``step(batch, gen) -> (loss, gnorm, jstat)``; ``batch`` holds
    device tensors (``device_batch``), ``gen`` is the run's
    ``torch.Generator`` on the model's device.  ``step.loss_fn(batch,
    gen) -> (loss, jstat, batch_stats)`` is the step's forward alone
    (the casts of the compute dtype included), for callers that time or
    differentiate it on its own.  ``remat`` (module doc) changes no
    value: the recompute replays the forward's generator draws."""
    context = remat_context(remat_policy)
    model.requires_grad_(True)
    params = list(model.parameters())

    def loss_fn(batch, gen):
        out = train_forward(model, batch, gen, compute_dtype)
        loss = cross_entropy_ignore_pad(out["logits"], batch["labels"])
        if model.cfg.moe_experts > 0:
            # the MoE calls' load-balance aux, weighted into the loss
            loss = loss + model.cfg.moe_aux_weight * out["moe_aux"]
        return loss, out["jstat"], out["batch_stats"]

    def step(batch, gen):
        with stochastic.remat(remat):
            loss, jstat, stats = (
                stochastic.checkpoint(loss_fn, batch, gen, gen=gen,
                                      context_fn=context)
                if remat else loss_fn(batch, gen))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            gsq = sum(g.float().pow(2).sum() for g in grads if g is not None)
            gnorm = torch.sqrt(torch.as_tensor(gsq, device=loss.device,
                                               dtype=torch.float32))
            if clip_grad_norm > 0:
                factor = torch.clamp(clip_grad_norm / (gnorm + 1e-6),
                                     max=1.0)
                grads = [None if g is None else g * factor.to(g.dtype)
                         for g in grads]
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            for p in params:
                p.grad = None
            model.apply_batch_stats(stats)
        return loss.detach(), gnorm, jstat

    step.loss_fn = loss_fn
    return step


def make_grad_diagnostics(model: Model):
    """``grads_fn(batch) -> {flax name: gradient}``: the gradient of the
    teacher-forced eval loss with respect to every parameter, taken as
    the JAX package's ``make_grad_diagnostics`` takes it (``train=False``:
    running BatchNorm statistics, no dropout, the noise-free routing) on
    the differentiable routes (``Model.forward(differentiable=True)``),
    each in the JAX layout under its dotted flax path.  It recomputes a
    forward and a backward, so the loop runs it at log steps only."""
    model.requires_grad_(True)
    named = list(model.named_parameters())
    layout = jax_layout(model)

    def grads_fn(batch) -> Dict[str, torch.Tensor]:
        with torch.enable_grad():
            out = model(batch["text_ids"], labels=batch["labels"],
                        differentiable=True, **_features(batch))
            grads = torch.autograd.grad(out["loss"], [p for _, p in named],
                                        allow_unused=True)
        result = {}
        for (name, p), g in zip(named, grads):
            _coll, path, perm = layout[name]
            g = torch.zeros_like(p) if g is None else g.detach()
            result[".".join(path)] = g if perm is None else g.permute(*perm)
        return result

    return grads_fn


def log_grad_detail(writer, grads: Dict[str, torch.Tensor],
                    step: int) -> None:
    """The JAX loop's ``log_detail`` scalars: ``train/per_layer_norms_<p>``
    for every parameter and ``Entropy/<p>`` for those of more than 1,024
    elements."""
    for name, norm in track_grad_norms(grads.items()).items():
        writer.add_scalar(f"train/per_layer_norms_{name}", norm, step)
    for name, g in grads.items():
        if g.numel() > 1024:
            writer.add_scalar(f"Entropy/{name}", spectral_entropy(g), step)


def grad_norm_controller(grad_history, scales: Dict[str, float],
                         lo: float = 0.8, hi: float = 1.2,
                         shrink: float = 0.9, grow: float = 1.1,
                         clamp=(0.05, 2.0)) -> Dict[str, float]:
    """The OneShot grad-norm feedback controller: the 5-step mean of the
    global grad norm against the 5 before; shrink or grow every scale,
    clamp."""
    if len(grad_history) > 10:
        recent = sum(grad_history[-5:]) / 5
        prev = sum(grad_history[-10:-5]) / 5
        for k in scales:
            if recent > prev * hi:
                scales[k] *= shrink
            elif recent < prev * lo:
                scales[k] *= grow
            scales[k] = float(max(clamp[0], min(clamp[1], scales[k])))
    return scales


def make_eval_step(model: Model):
    """``eval_fn(batch) -> (loss, argmax predictions)``, teacher-forced,
    on the eval route."""

    def eval_fn(batch):
        out = model(batch["text_ids"], labels=batch["labels"],
                    **_features(batch))
        return out["loss"], torch.argmax(out["logits"], dim=-1)

    return eval_fn


def _greedy(model, batch, max_new_tokens: int, suppress_eos: bool):
    from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                     greedy_decode_stream)
    fn = greedy_decode_stream if model.cfg.streaming else greedy_decode
    return fn(model, max_new_tokens=max_new_tokens,
              suppress_eos=suppress_eos, **_features(batch))


def evaluate_model(model: Model, tokenizer, eval_loader,
                   eval_steps: int = 0, max_new_tokens: int = 150,
                   suppress_eos: bool = True,
                   metric_fn: Callable = compute_metrics) -> Dict[str, Any]:
    """Free-running evaluation: greedy decode (the stream decode for a
    streaming model) with EOS suppressed until the budget; returns
    loss, WER, transcripts and the time taken."""
    eval_step = make_eval_step(model)
    start = time.time()
    eval_loss, batches = 0.0, 0
    all_p, all_l = [], []
    for i, batch in enumerate(eval_loader):
        if eval_steps and i >= eval_steps:
            break
        db = device_batch(batch, model.device)
        loss, _ = eval_step(db)
        eval_loss += float(loss)
        batches += 1
        ids = _greedy(model, db, max_new_tokens, suppress_eos)
        all_p.extend(ids.cpu().tolist())
        all_l.extend(np.asarray(batch["labels"]).tolist())
    metrics = metric_fn({"predictions": all_p, "label_ids": all_l},
                        tokenizer=tokenizer)
    return {"loss": eval_loss / max(batches, 1), "wer": metrics["wer"],
            "preds": tokenizer.batch_decode(all_p),
            "labels": tokenizer.batch_decode(all_l),
            "eval_time": time.time() - start}


class NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def default_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return NullWriter()
    return SummaryWriter(log_dir=log_dir)


def run_mesh(run):
    """(mesh or None, whether it is a pipeline's) from RunConfig.mesh_*:
    a (data, pipe) mesh where mesh_pipe > 1, a (data, model, seq,
    expert) mesh where another axis is > 1 or a process group is up
    (one rank goes through the sharded code), else None."""
    import torch.distributed as dist

    from asr_model_tpu_torch.parallel.mesh import make_mesh, make_pipe_mesh
    if run.mesh_pipe > 1:
        return make_pipe_mesh(pipe=run.mesh_pipe, data=run.mesh_data), True
    n = run.mesh_data * run.mesh_model * run.mesh_seq * run.mesh_expert
    if n > 1 or (dist.is_available() and dist.is_initialized()):
        return make_mesh(data=run.mesh_data, model=run.mesh_model,
                         seq=run.mesh_seq, expert=run.mesh_expert), False
    return None, False


def restore_training(model: Model, opt, path: str, gen=None,
                     pipeline: bool = False) -> int:
    """Load a checkpoint (the port's or the JAX loop's) into the model,
    the optimizer and (when it holds one) the generator; returns its
    step.  A sharded model takes it whole and keeps its blocks;
    ``pipeline``: the checkpoint is in the pipeline layout."""
    from asr_model_tpu_torch.parallel.sharding import unsharded
    with unsharded(model):
        return _restore(model, opt, path, gen, pipeline)


def _restore(model, opt, path, gen, pipeline):
    if pipeline:
        from asr_model_tpu_torch.parallel import pipeline as PP
        state = ckpt.restore_checkpoint(path)
        state["params"] = PP.from_pipeline_params(state["params"])
        state["opt_state"] = PP.from_pipeline_opt_state(state["opt_state"])
        ckpt.load_model_state(model, state, mono_stem=False, path=path)
        step = int(state.get("step", 0))
    else:
        state, step = ckpt.restore_model(model, path, mono_stem=False)
    ckpt.load_opt_state(opt, model, state["opt_state"])
    if gen is not None and "rng" in state:
        gen.set_state(torch.from_numpy(np.asarray(state["rng"],
                                                  np.uint8)))
    return step


def train_and_evaluate(model: Model, tokenizer, train_loader: Iterable,
                       eval_loader: Iterable, cfg: Config, writer=None,
                       metric_fn: Callable = compute_metrics,
                       resume_from: Optional[str] = None,
                       log_detail: bool = False):
    """Train ``model`` in place for ``cfg.run.max_steps`` steps (from a
    checkpoint's step with ``resume_from``); returns a summary dict (the
    first and the final step, the last loss and grad norm, the last
    eval's WER and loss).  ``log_detail`` adds the gradient diagnostics
    (``make_grad_diagnostics``) at every log step."""
    run = cfg.run
    mesh, pipe = run_mesh(run)
    rank0 = mesh is None or mesh.rank == 0
    os.makedirs(run.checkpoint_dir, exist_ok=True)
    if rank0:
        with open(os.path.join(run.checkpoint_dir, "config.json"),
                  "w") as f:
            f.write(cfg.to_json())
    writer = writer if writer is not None else (
        default_writer(run.log_dir) if rank0 else NullWriter())
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    if pipe:
        from asr_model_tpu_torch.parallel import pipeline as PP
        if run.mesh_model != 1 or run.mesh_seq != 1 or run.mesh_expert != 1:
            raise ValueError("mesh_pipe composes with mesh_data only (got "
                             f"mesh_model={run.mesh_model} mesh_seq="
                             f"{run.mesh_seq} mesh_expert={run.mesh_expert})")
        PP.check_pipeline(model, mesh, run.microbatches, run.batch_size)
        opt, sched = make_optimizer(cfg, model,
                                    named=PP.stage_params(model, mesh))
    else:
        if mesh is not None:
            from asr_model_tpu_torch.parallel.sharding import shard_params
            if run.batch_size % run.mesh_data:
                raise ValueError(f"batch_size {run.batch_size} must divide "
                                 f"mesh_data {run.mesh_data}")
            shard_params(model, mesh)
        opt, sched = make_optimizer(cfg, model)
    global_step = 0
    if resume_from:
        global_step = restore_training(model, opt, resume_from, gen,
                                       pipeline=pipe)
        logger.info("restored checkpoint at step %d from %s", global_step,
                    resume_from)
    compute = train_compute_dtype(run)
    if pipe:
        train_step = PP.make_pp_train_step(
            model, opt, mesh, run.microbatches, run.clip_grad_norm, compute,
            run.remat)
    elif mesh is not None:
        from asr_model_tpu_torch.parallel.sharding import (
            make_sharded_train_step)
        train_step = make_sharded_train_step(
            model, opt, mesh, run.clip_grad_norm, compute, run.remat,
            run.remat_policy)
    else:
        train_step = make_train_step(model, opt, run.clip_grad_norm,
                                     compute, run.remat, run.remat_policy)

    def saved_state(step: int) -> dict:
        from asr_model_tpu_torch.parallel.sharding import unsharded
        if pipe:
            return PP.pipeline_training_state(model, opt, mesh, step, gen)
        with unsharded(model):
            return ckpt.training_state(model, opt, step, gen)
    eval_step = make_eval_step(model)
    grad_diag = make_grad_diagnostics(model) if log_detail else None

    n_params_m = sum(p.numel() for p in model.parameters()) / 1e6
    grad_history: list = []
    oneshot = {"oneshot": 0.3}
    total_loss, steps_this_run, samples_per_sec = 0.0, 0, 0.0
    summary: Dict[str, Any] = {"start_step": global_step}
    if run.prefetch_depth > 0:
        from asr_model_tpu_torch.data.dataset import Prefetcher
        loader = Prefetcher(train_loader, depth=run.prefetch_depth)
    else:
        loader = train_loader
    it = iter(loader)

    def pull():
        nonlocal it
        skipped = 0
        while True:
            try:
                b = next(it)
            except StopIteration:
                it = iter(loader)
                b = next(it)
            rows = len(b["text_ids"])
            # the pipeline's fixed microbatch grid skips a ragged batch,
            # as the JAX loop does
            if not pipe or (rows % run.microbatches == 0 and (
                    rows // run.microbatches) % run.mesh_data == 0):
                return b
            skipped += 1
            if skipped > 1000:
                raise ValueError(
                    "every batch is ragged for the pipeline grid "
                    f"(microbatches={run.microbatches} x "
                    f"data={run.mesh_data}); fix batch_size")

    batch = pull() if global_step < run.max_steps else None
    while global_step < run.max_steps:
        start = time.time()
        rows = len(batch["text_ids"])
        db = device_batch(batch, dev)
        loss, gnorm, jstat = train_step(db, gen)
        # the step is queued on the device; prepare the next host batch
        # while it runs, then read the two scalars
        if global_step + 1 < run.max_steps:
            batch = pull()
        loss_f, gnorm_f = float(loss), float(gnorm)
        total_loss += loss_f
        steps_this_run += 1
        grad_history = grad_history[-99:] + [gnorm_f]
        oneshot = grad_norm_controller(grad_history, oneshot)
        samples_per_sec = rows / max(time.time() - start, 1e-9)
        summary.update(step=global_step, loss=loss_f, gnorm=gnorm_f)

        if global_step % run.log_interval == 0:
            js = jstat.cpu().tolist()
            for name, val in (
                    ("Loss/train", total_loss / steps_this_run),
                    ("LearningRate", sched(global_step)),
                    ("SamplesPerSec", samples_per_sec),
                    ("GradNorm", gnorm_f),
                    ("OneShot/scale", oneshot["oneshot"]),
                    ("Jumps/Layer_Maintained_0", int(js[0])),
                    ("Jumps/Skipped_1_Layer", int(js[1])),
                    ("Jumps/Skipped_2_Layers", int(js[2]))):
                writer.add_scalar(name, val, global_step)
            if grad_diag is not None:
                log_grad_detail(writer, grad_diag(db), global_step)

        do_eval = (run.eval_interval > 0
                   and global_step > run.warmup_interval
                   and global_step % run.eval_interval == 0) \
            or global_step == run.max_steps - 1
        if do_eval:
            if pipe:
                PP.sync_blocks(model, mesh)
            eval_start = time.time()
            eval_loss, n_eval, batches = 0.0, 0, 0
            all_p, all_l = [], []
            for ebatch in eval_loader:
                edb = device_batch(ebatch, dev)
                l, preds = eval_step(edb)
                eval_loss += float(l)
                batches += 1
                n_eval += len(ebatch["text_ids"])
                if run.generate:
                    preds = _greedy(model, edb, int(edb["labels"].shape[1]),
                                    False)
                all_p.extend(preds.cpu().tolist())
                all_l.extend(np.asarray(ebatch["labels"]).tolist())
            loss_avg = eval_loss / max(batches, 1)
            metrics = metric_fn({"predictions": all_p, "label_ids": all_l},
                                tokenizer=tokenizer, num_params_m=n_params_m)
            for name, val in (("Loss/eval", loss_avg),
                              ("WER", metrics["wer"]),
                              ("EvalSamples", n_eval),
                              ("EvalTimeSeconds", time.time() - eval_start)):
                writer.add_scalar(name, val, global_step)
            summary.update(eval_wer=metrics["wer"], eval_loss=loss_avg)
            if rank0:
                print(f"EVALUATION STEP:{global_step} • "
                      f"samp:{samples_per_sec:.1f} • "
                      f"WER:{metrics['wer']:.2f}% • Loss:{loss_avg:.4f} • "
                      f"LR:{sched(global_step):.8f}", flush=True)

        if run.save_interval > 0 and global_step > 0 \
                and global_step % run.save_interval == 0:
            state = saved_state(global_step)
            if rank0:
                ckpt.save_model_checkpoint(run.checkpoint_dir, global_step,
                                           state)
        global_step += 1
    # stop the prefetch worker (a closed pass joins it) before the
    # caller reads what it counts, such as the mel launches
    getattr(it, "close", lambda: None)()

    if run.save_interval > 0:
        if pipe:    # the unsharded layout, with a fresh optimizer state
            PP.sync_blocks(model, mesh)
            state = ckpt.training_state(
                model, make_optimizer(cfg, model)[0], global_step, gen)
        else:
            state = saved_state(global_step)
        if rank0:
            ckpt.save_checkpoint(
                os.path.join(run.checkpoint_dir, "final_model.msgpack"),
                state)
    summary["step"] = global_step
    logger.info("Training completed after %d steps.", global_step)
    writer.close()
    return summary
