"""Length-normalised beam search over the buffer decode.

The counterpart of ``asr_model_tpu/models/beam.py``.  The K beams of each
utterance are folded into the batch: the cross K/V are computed once and
repeated B -> B K, and every step runs the decoder over the (B K, s)
prefix buffer (the prefix buckets of ``greedy_decode``: the same tokens
as the full-width buffer).  Only beam 0 is live at first (the others
start at -1e9, so identical beams do not fill the list); a finished beam
continues only with PAD at no cost; each step keeps the K best of the K
x vocab candidates of an utterance.  Ties keep the first candidate in
(beam, token) order, as ``jax.lax.top_k`` does: a stable descending sort
(the dead beams' candidates tie, since -1e9 + log p rounds to -1e9 in
f32).  At the end the beam with the best score / length ** penalty wins.
"""

from __future__ import annotations

import torch

from asr_model_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from asr_model_tpu_torch.models.generate import (_bucket_sizes,
                                                 _decode_stages, decode_step,
                                                 prepare_cross)
from asr_model_tpu_torch.models.model import Model, modality_slots

NEG = -1e9


def _repeat(tree, k: int):
    if isinstance(tree, dict):
        return {key: _repeat(v, k) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_repeat(v, k) for v in tree)
    return tree.repeat_interleave(k, dim=0)


@torch.no_grad()
def beam_search(model: Model, spectrogram=None, pitch=None, waveform=None,
                beam_size: int = 4, max_new_tokens: int = 150,
                length_penalty: float = 1.0):
    """Returns (ids (B, 1 + max_new_tokens), length-normalised scores
    (B,))."""
    K = int(beam_size)
    xa = modality_slots(pitch, spectrogram, waveform)
    xa_kv = _repeat(prepare_cross(model, xa), K)
    fx = next(iter(xa.values()))
    B, dev = fx.shape[0], fx.device
    T = 1 + int(max_new_tokens)
    ids = torch.full((B, K, T), PAD_ID, dtype=torch.long, device=dev)
    ids[..., 0] = BOS_ID
    scores = torch.full((B, K), NEG, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros(B, K, dtype=torch.bool, device=dev)
    V = model.dims.tokens
    pad_only = torch.full((V,), NEG, device=dev)
    pad_only[PAD_ID] = 0.0
    rows = torch.arange(B, device=dev)[:, None]
    length = 1
    for s in _bucket_sizes(T, _decode_stages()):
        if bool(done.all()):
            break
        while length < s:
            logits = decode_step(model, ids.reshape(B * K, T)[:, :s], xa_kv,
                                 length)
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            logp = torch.where(done[..., None], pad_only, logp)
            cand = (scores[..., None] + logp).reshape(B, K * V)
            top = torch.sort(cand, dim=-1, descending=True, stable=True)
            scores, flat = top.values[:, :K], top.indices[:, :K]
            src, token = flat // V, flat % V
            ids, done = ids[rows, src], done[rows, src]
            token = torch.where(done, torch.full_like(token, PAD_ID), token)
            ids[..., length] = token
            done = done | (token == EOS_ID)
            length += 1
    lengths = ((ids != PAD_ID) & (ids != EOS_ID)).sum(-1).float()
    norm = scores / lengths ** length_penalty
    best = torch.argmax(norm, dim=-1)
    return ids[rows[:, 0], best], norm[rows[:, 0], best]
