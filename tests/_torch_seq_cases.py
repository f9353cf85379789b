"""The multi-rank cases of ``tests/test_torch_seq.py`` (run by
``tests/_torch_dist.py:spawn``; torch, numpy and the port only): the
port's sequence parallelism at ``seq`` 4 on the JAX inits and inputs
stored in ``tests/golden/seq.npz`` (``tests/_seq_golden.py``)."""

import numpy as np
import torch

from _seq_golden import KW, SEQ, load, sub
from asr_model_tpu_torch.config import Dimensions, ModelConfig
from asr_model_tpu_torch.models.generate import greedy_decode_sp
from asr_model_tpu_torch.models.longform import transcribe_long_sp
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.parallel.mesh import block, gather, make_mesh
from asr_model_tpu_torch.parallel.seq import seq_sharded_attention, sp_encode
from asr_model_tpu_torch.weights import from_jax_params


def build(name: str = "enc"):
    """The JAX init ``name`` ("enc", or "enc_norm" with encoder_norm) in
    a port model on the CPU, and its feature."""
    g = load()
    m = Model(Dimensions(**KW), ModelConfig(encoder_norm=name == "enc_norm"),
              device="cpu")
    m.load_state_dict(from_jax_params(sub(g, f"{name}/params"),
                                      sub(g, f"{name}/batch_stats")),
                      strict=True)
    return m, torch.from_numpy(g[f"{name}/spec"])


def attention(rank):
    g = load()
    ax = make_mesh(seq=SEQ).axis("seq")
    k, v = (block(torch.from_numpy(g[f"attn/{n}"]), 2, ax) for n in "kv")
    valid = block(torch.from_numpy(g["attn/valid"]), 1, ax)
    out = seq_sharded_attention(torch.from_numpy(g["attn/q"]), k, v, ax,
                                kv_valid=valid)
    return {"out": out.numpy()}


def encode(rank, name):
    m, spec = build(name)
    mesh = make_mesh(seq=SEQ)
    y = gather(sp_encode(m, spec, mesh), 1, mesh.axis("seq"))
    return {"out": y.numpy()}


def decode(rank):
    m, spec = build()
    ids = greedy_decode_sp(m, make_mesh(seq=SEQ), spectrogram=spec,
                           max_new_tokens=6, suppress_eos=True)
    return {"ids": ids.numpy()}


def long(rank):
    m, _ = build()
    ids, _ = transcribe_long_sp(m, load()["long/audio"], make_mesh(seq=SEQ),
                                max_new_tokens=8, use_pitch=False)
    return {"ids": np.asarray(ids, np.int64)}
