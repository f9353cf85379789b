"""Greedy full-prefix buffer decode.

BOS starts each row; each step runs the decoder over the prefix
buffer (every length-dependent op masked to the live prefix by
``text_valid``), takes the argmax of the newest position's logits
(the seq=True head), writes it, and turns the row to PAD after its
EOS.  ``suppress_eos`` forbids EOS until the last token of the budget.

What runs once per utterance: the AudioEncoder, the last block's
per-slot re-encode and the cross-attention K/V precompute.  Short
prefixes run in short buffers: the buffer width steps through
``_bucket_sizes(1 + max_new_tokens, GRAFT_DECODE_STAGES)`` (default 8
stages), with identical tokens to the full-width buffer because every
length-dependent op reads the mask and positions are absolute.  The
step loop is a plain Python loop that never waits on the device inside
a bucket: whether every row has finished is read once per bucket
boundary, and steps past a row's EOS write PAD either way.
"""

from __future__ import annotations

import os

import torch

from asr_model_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from asr_model_tpu_torch.models.model import Model, modality_slots


def _decode_stages() -> int:
    """Prefix-bucket stage count (GRAFT_DECODE_STAGES, default 8)."""
    try:
        return max(1, int(os.environ.get("GRAFT_DECODE_STAGES", "8")))
    except ValueError:
        return 8


def _bucket_sizes(T: int, n_stages: int):
    """Prefix-bucket buffer widths for a 1 + max_new_tokens decode."""
    if T <= 24 or n_stages <= 1:
        return [T]
    sizes = sorted({min(T, 1 + ((T - 1) * k + n_stages - 1) // n_stages)
                    for k in range(1, n_stages + 1)})
    return [s for s in sizes if s >= 8] or [T]


@torch.no_grad()
def prepare_cross(model: Model, xa: dict) -> dict:
    """Encoder, re-encode and cross K/V precompute: the per-utterance
    half of the decode."""
    proc = model.processor
    return proc.precompute_cross(proc.encode_xa(model.encode(xa)))


@torch.no_grad()
def decode_step(model: Model, ids, xa_kv: dict, length: int):
    """Logits (B, vocab) of position ``length - 1`` over the buffer
    ``ids`` (B, s) whose first ``length`` positions are live."""
    batch, s = ids.shape
    valid = (torch.arange(s, device=ids.device) < length)[None].expand(
        batch, s).contiguous()
    logits = model.processor(ids, seq=True, text_valid=valid,
                             logits_position=min(max(length - 1, 0), s - 1),
                             xa_kv=xa_kv)
    return logits[:, 0]


@torch.no_grad()
def greedy_decode(model: Model, spectrogram=None, pitch=None, waveform=None,
                  max_new_tokens: int = 150, suppress_eos: bool = False):
    """Returns (B, 1 + max_new_tokens) int64 ids: BOS, the generated
    tokens, PAD after a row's EOS."""
    xa = modality_slots(pitch, spectrogram, waveform)
    xa_kv = prepare_cross(model, xa)
    fx = next(iter(xa.values()))
    batch, dev = fx.shape[0], fx.device
    T = 1 + int(max_new_tokens)
    ids = torch.full((batch, T), PAD_ID, dtype=torch.long, device=dev)
    ids[:, 0] = BOS_ID
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    length = 1
    for s in _bucket_sizes(T, _decode_stages()):
        if length >= s:
            continue
        if bool(done.all()):
            break
        while length < s:
            logits = decode_step(model, ids[:, :s], xa_kv, length)
            if suppress_eos and length < T - 1:
                logits[:, EOS_ID] = float("-inf")
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, PAD_ID), nxt)
            ids[:, length] = nxt
            done = done | (nxt == EOS_ID)
            length += 1
    return ids
