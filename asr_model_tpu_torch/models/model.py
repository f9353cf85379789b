"""Top-level model: the AudioEncoder over priority-ordered modality
slots a/b/c and the multi-modal Processor.

Features arrive as (B, mels, T) spectrograms and (B, 1, T) pitch /
waveform tracks.  ``Model(dims, cfg, device=None)`` builds on the CUDA
device (an error when there is none) unless ``device="cpu"`` is asked
for, with weights drawn from a seeded ``torch.Generator``.  Its
parameters do not require gradients until a trainer asks
(``train/loop.py``).

``forward(..., train=True, gen=)`` is the training forward: BatchNorm
batch statistics, dropout and gumbel draws from ``gen`` (a
``torch.Generator`` on the model's device; None is the noise-free
limit, which needs ``dropout=0``), the differentiable routes of every
module.  ``forward(..., differentiable=True)`` is the eval forward
(running BatchNorm statistics, no dropout, no noise) on those routes,
for a gradient of the eval loss.  It returns the logits,
``cross_entropy_ignore_pad`` when ``labels`` are given, the summed
MSheath jump counter ``jstat`` (3,), ``batch_stats``, the new running
statistics of each BatchNorm (``apply_batch_stats`` writes them to the
buffers), and ``moe_aux``, the MoE calls' load-balance aux summed in f32
(0 without MoE; the train step weights it into its loss).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from asr_model_tpu_torch.config import Dimensions, ModelConfig
from asr_model_tpu_torch.models import stochastic
from asr_model_tpu_torch.models.conv import AudioEncoder
from asr_model_tpu_torch.models.decoder import Processor
from asr_model_tpu_torch.models.tlayers import reset_all
from asr_model_tpu_torch.utils import aborc, resolve_device


def modality_slots(pitch=None, spectrogram=None, waveform=None
                   ) -> Dict[str, torch.Tensor]:
    """Priority-ordered modality slots: a = pitch first, b = spectrogram
    first, c = waveform first, each falling back to the others."""
    xa = {"a": aborc(pitch, spectrogram, waveform),
          "b": aborc(spectrogram, pitch, waveform),
          "c": aborc(waveform, pitch, spectrogram)}
    return {k: v for k, v in xa.items() if v is not None}


def cross_entropy_sum(logits, labels, ignore_id: int = 0):
    """(summed cross entropy, count) over the labels that are not
    ``ignore_id``: a sharded batch sums both over its shards."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = (labels != ignore_id).to(logits.dtype)
    return -(ll * mask).sum(), mask.sum()


def cross_entropy_ignore_pad(logits, labels, ignore_id: int = 0):
    """Mean cross entropy over the labels that are not ``ignore_id``."""
    total, count = cross_entropy_sum(logits, labels, ignore_id)
    return total / torch.clamp(count, min=1.0)


class Model(nn.Module):
    def __init__(self, dims: Dimensions = Dimensions(),
                 cfg: Optional[ModelConfig] = None, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        cfg = cfg or ModelConfig()
        dev = resolve_device(device)
        self.dims, self.cfg = dims, cfg
        kw = dict(device=dev, dtype=dtype)
        self.processor = Processor(
            dims.tokens, dims.dims, dims.head, dims.layer, dims.act,
            dims.n_type, ctx=cfg.ctx, num_types=cfg.num_types,
            mem=cfg.msheath_mem, theta=cfg.theta,
            causal_all=cfg.causal_all, streaming=cfg.streaming,
            chained=cfg.chained_blocks,
            fused_attention=cfg.fused_attention, fused_mlp=cfg.fused_mlp,
            fused_router=cfg.fused_router, moe_experts=cfg.moe_experts,
            moe_top_k=cfg.moe_top_k,
            moe_capacity_factor=cfg.moe_capacity_factor, **kw)
        self.enc = AudioEncoder(dims.mels, dims.dims, dims.head, dims.layer,
                                dims.act, theta=cfg.theta,
                                dropout=cfg.dropout, n_type=dims.n_type,
                                norm=cfg.encoder_norm,
                                enc=cfg.encoder_transformer, **kw)
        gen = torch.Generator(device=dev).manual_seed(seed)
        reset_all(self, gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.processor.position.device

    def encode(self, xa: Dict[str, torch.Tensor]):
        """Run the AudioEncoder over the a/b/c slots."""
        return self.enc(xa)

    def forward(self, text_ids, labels=None, spectrogram=None, pitch=None,
                waveform=None, text_valid=None, train: bool = False,
                gen=None, differentiable: bool = False):
        if not (train or gen is not None or differentiable):
            with torch.no_grad():
                return self._forward(text_ids, labels, spectrogram, pitch,
                                     waveform, text_valid)
        with stochastic.mode(train, gen, differentiable) as rec:
            out = self._forward(text_ids, labels, spectrogram, pitch,
                                waveform, text_valid)
            jstat, aux = rec.jstat, rec.moe_aux
            out["batch_stats"] = rec.batch_stats
        out["jstat"] = (torch.zeros(3, dtype=torch.int32,
                                    device=text_ids.device)
                        if jstat is None else jstat)
        out["moe_aux"] = sum((a.float() for a in aux), torch.zeros(
            (), device=text_ids.device))
        return out

    def _forward(self, text_ids, labels, spectrogram, pitch, waveform,
                 text_valid):
        xa = self.encode(modality_slots(pitch, spectrogram, waveform))
        logits = self.processor(text_ids, xa, seq=False,
                                text_valid=text_valid)
        loss = None
        if labels is not None:
            loss = cross_entropy_ignore_pad(logits, labels)
        return {"logits": logits, "loss": loss}

    @torch.no_grad()
    def apply_batch_stats(self, stats: dict) -> None:
        """Write a train forward's new BatchNorm running statistics to
        the buffers, in the buffers' dtype."""
        for bn, (mean, var) in stats.items():
            bn.running_mean.copy_(mean.to(bn.running_mean.dtype))
            bn.running_var.copy_(var.to(bn.running_var.dtype))


def cast_variables(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter and buffer to ``dtype`` in place
    (bf16 inference: the logits are still returned in f32)."""
    for t in list(model.parameters()) + list(model.buffers()):
        if t.dtype == torch.float32:
            t.data = t.data.to(dtype)
    return model


def init_w(model: nn.Module) -> Dict[str, int]:
    """The module-count self-check over a model's parameters, counted as
    the JAX package's ``init_w`` counts its flax params tree: each
    parameter's flax path (``weights.jax_layout``), a 2-D Dense kernel a
    Linear, a 3-D kernel or weight-norm ``v`` a Conv1d, a norm scale a
    LayerNorm (a stacked (L, d) one L of them), an embedding an
    Embedding; prints the summary."""
    from asr_model_tpu_torch.weights import jax_layout
    counts = {"Linear": 0, "Conv1d": 0, "LayerNorm": 0, "Embedding": 0,
              "Other": 0}
    shapes = dict(model.state_dict())
    leaves = sorted((path, shapes[key]) for key, (coll, path, perm)
                    in jax_layout(model).items() if coll == "params")
    seen = set()
    for path, leaf in leaves:
        parent, name = "/".join(path[:-1]), path[-1]
        if parent in seen:
            continue
        if name == "kernel" and leaf.dim() == 2:
            counts["Linear"] += 1
            seen.add(parent)
        elif name in ("kernel", "v") and leaf.dim() == 3:
            counts["Conv1d"] += 1
            seen.add(parent)
        elif name in ("scale", "ln_scale", "mlp_ln_scale", "gamma"):
            counts["LayerNorm"] += leaf.shape[0] if leaf.dim() == 2 else 1
            seen.add(parent + "/" + name)
        elif name == "embedding":
            counts["Embedding"] += 1
            seen.add(parent)
    print("Initialization summary:")
    for k, v in counts.items():
        if v > 0:
            print(f"{k}: {v}")
    return counts
