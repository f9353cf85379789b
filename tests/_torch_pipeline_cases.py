"""The multi-rank cases of ``tests/test_torch_pipeline.py`` (run by
``tests/_torch_dist.py:spawn``; torch, numpy and the port only): the
port's pipeline on the JAX init stored in ``tests/golden/pipeline.npz``
(``tests/_pipeline_golden.py``), and the one-device references."""

import numpy as np
import torch

from _pipeline_golden import CFG, KW, STEPS, load, sub
from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.parallel.mesh import make_pipe_mesh
from asr_model_tpu_torch.parallel.pipeline import (
    from_pipeline_opt_state, from_pipeline_params, make_pp_train_step,
    pipeline_forward, pipeline_grads, pipeline_training_state, stage_params)
from asr_model_tpu_torch.train.checkpoint import save_checkpoint
from asr_model_tpu_torch.train.loop import device_batch, make_optimizer
from asr_model_tpu_torch.weights import from_jax_params


def flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def build(dtype=torch.float32):
    g = load()
    m = Model(Dimensions(**KW), ModelConfig(**CFG), device="cpu")
    m.load_state_dict(from_jax_params(sub(g, "params"),
                                      sub(g, "batch_stats")), strict=True)
    batch = device_batch(sub(g, "batch"), "cpu")
    if dtype != torch.float32:
        m = m.to(dtype)
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
    return m, batch


def forward(rank, data, pipe, micro):
    m, batch = build()
    mesh = make_pipe_mesh(pipe=pipe, data=data)
    return {"logits": pipeline_forward(m, batch, mesh, micro).numpy()}


def single_forward(micro: int):
    """The unsharded eval forward applied per microbatch, joined."""
    m, batch = build()
    parts = []
    for i in range(micro):
        b = {k: v.chunk(micro)[i] for k, v in batch.items()}
        parts.append(m(b["text_ids"], spectrogram=b["spectrogram"],
                       pitch=b["pitch"])["logits"])
    return torch.cat(parts).numpy()


def grads64(rank, data=2, pipe=2):
    m, batch = build(torch.float64)
    g = pipeline_grads(m, batch, make_pipe_mesh(pipe=pipe, data=data), 1)
    return {k: v.numpy() for k, v in g.items()}


def single_grads64():
    m, batch = build(torch.float64)
    m.requires_grad_(True)
    out = m(batch["text_ids"], labels=batch["labels"],
            spectrogram=batch["spectrogram"], pitch=batch["pitch"],
            differentiable=True)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(out["loss"], list(m.parameters()),
                                allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).numpy()
            for (n, p), g in zip(m.named_parameters(), grads)
            if n in names}


def steps(rank, ckpt_path=""):
    """Three noise-free PP steps on the (2, 2) mesh with 2 microbatches;
    per step the loss, grad norm, flax-path params, the optimizer state
    in the unsharded layout and the batch statistics.  With
    ``ckpt_path`` rank 0 writes the last state there (pipeline
    layout)."""
    m, batch = build()
    mesh = make_pipe_mesh(pipe=2, data=2)
    opt, _ = make_optimizer(Config(), m, named=stage_params(m, mesh))
    step = make_pp_train_step(m, opt, mesh, 2)
    out = {}
    for n in range(1, STEPS + 1):
        loss, gnorm, _ = step(batch, None)
        state = pipeline_training_state(m, opt, mesh, n)
        out[f"step{n}/loss"] = loss.numpy()
        out[f"step{n}/gnorm"] = gnorm.numpy()
        out.update({f"step{n}/params/{k}": a for k, a in
                    flat(from_pipeline_params(state["params"]))})
        st = from_pipeline_opt_state(state["opt_state"])
        for key in ("row_var", "col_var", "v"):
            out.update({f"step{n}/{key}/{k}": a for k, a in flat(st[key])})
        out.update({f"step{n}/batch_stats/{k}": a
                    for k, a in flat(state["batch_stats"])})
        if n == STEPS and ckpt_path and rank == 0:
            save_checkpoint(ckpt_path, state)
    return out


def remat_step(rank):
    """``steps``' first step with remat (each MSheath slot step
    recomputed in the backward, the batch's sharding with it)."""
    m, batch = build()
    mesh = make_pipe_mesh(pipe=2, data=2)
    opt, _ = make_optimizer(Config(), m, named=stage_params(m, mesh))
    loss, gnorm, _ = make_pp_train_step(m, opt, mesh, 2, remat=True)(batch,
                                                                     None)
    state = pipeline_training_state(m, opt, mesh, 1)
    out = {"loss": loss.numpy(), "gnorm": gnorm.numpy()}
    out.update({f"params/{k}": a for k, a in
                flat(from_pipeline_params(state["params"]))})
    return out
