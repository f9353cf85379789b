"""Greedy decode: the full-prefix buffer decode (plain, or prompted after
BOS), and the incremental decode of the streaming variant.

BOS starts each row; each step runs the decoder over the prefix
buffer (every length-dependent op masked to the live prefix by
``text_valid``), takes the argmax of the newest position's logits
(the seq=True head; a streaming model decodes from the blended head it
trains, seq=False, as in the JAX package), writes it, and turns the row
to PAD after its EOS.  ``suppress_eos`` forbids EOS until the last token
of the budget.

What runs once per utterance: the AudioEncoder, the last block's
per-slot re-encode and the cross-attention K/V precompute.  Short
prefixes run in short buffers: the buffer width steps through
``_bucket_sizes(1 + max_new_tokens, GRAFT_DECODE_STAGES)`` (default 8
stages), with identical tokens to the full-width buffer because every
length-dependent op reads the mask and positions are absolute.  The
step loop is a plain Python loop that never waits on the device inside
a bucket: whether every row has finished is read once per bucket
boundary, and steps past a row's EOS write PAD either way.

``greedy_decode_stream`` (streaming models only) runs one position a
step through ``Processor.decode_stream_step`` against per-site caches
and MSheath running sums: O(1) work a token besides the attention reads
of the caches, the same tokens as ``greedy_decode`` on the same model.
Whether every row has finished is read once every ``STREAM_CHECK``
positions.

``greedy_decode_sp`` is the sequence-parallel decode of long audio
(``asr_model_tpu/models/generate.py:greedy_decode_sp``): the encoder
runs time-split over a mesh axis (``parallel/seq.py:sp_encode``), the
encoder output is gathered and re-encoded on every rank, each rank
keeps its time block of the cross K/V, and every cached cross call of
the decode merges over the axis (``seq_sharding``).  As the JAX
package's SP decode it runs one full-length ids buffer (no prefix
buckets).
"""

from __future__ import annotations

import os

import torch

from asr_model_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID
from asr_model_tpu_torch.models.model import Model, modality_slots
from asr_model_tpu_torch.ops.audio import sinusoids

STREAM_CHECK = 8    # positions between the stream decode's done checks


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
    logits = model.processor(ids, seq=not model.cfg.streaming,
                             text_valid=valid,
                             logits_position=min(max(length - 1, 0), s - 1),
                             xa_kv=xa_kv)
    return logits[:, 0]


def _next_tokens(logits, done, length: int, T: int, suppress_eos: bool):
    """The argmax token of each row, EOS forbidden before the budget's
    last token under ``suppress_eos``, PAD on finished rows."""
    if suppress_eos and length < T - 1:
        logits[:, EOS_ID] = float("-inf")
    nxt = torch.argmax(logits, dim=-1)
    return torch.where(done, torch.full_like(nxt, PAD_ID), nxt)


def _start(xa: dict, max_new_tokens: int, prompt=None):
    fx = next(iter(xa.values()))
    batch, dev = fx.shape[0], fx.device
    p = 0 if prompt is None else prompt.shape[-1]
    T = 1 + p + int(max_new_tokens)
    ids = torch.full((batch, T), PAD_ID, dtype=torch.long, device=dev)
    ids[:, 0] = BOS_ID
    if p:
        ids[:, 1:1 + p] = prompt.to(dev)
    return ids, torch.zeros(batch, dtype=torch.bool, device=dev), T


def _greedy(model: Model, xa: dict, max_new_tokens: int, suppress_eos: bool,
            prompt=None, xa_kv=None, buckets: bool = True):
    xa_kv = prepare_cross(model, xa) if xa_kv is None else xa_kv
    ids, done, T = _start(xa, max_new_tokens, prompt)
    length = 1 if prompt is None else 1 + prompt.shape[-1]
    sizes = _bucket_sizes(T, _decode_stages()) if buckets else [T]
    # only the buffer widths past the prompt serve a step
    for s in [s for s in sizes if s > length] or [T]:
        if bool(done.all()):
            break
        while length < s:
            logits = decode_step(model, ids[:, :s], xa_kv, length)
            nxt = _next_tokens(logits, done, length, T, suppress_eos)
            ids[:, length] = nxt
            done = done | (nxt == EOS_ID)
            length += 1
    return ids


@torch.no_grad()
def greedy_decode(model: Model, spectrogram=None, pitch=None, waveform=None,
                  max_new_tokens: int = 150, suppress_eos: bool = False):
    """Returns (B, 1 + max_new_tokens) int64 ids: BOS, the generated
    tokens, PAD after a row's EOS."""
    return _greedy(model, modality_slots(pitch, spectrogram, waveform),
                   max_new_tokens, suppress_eos)


@torch.no_grad()
def greedy_decode_prompted(model: Model, prompt, spectrogram=None,
                           pitch=None, waveform=None,
                           max_new_tokens: int = 150,
                           suppress_eos: bool = False):
    """Greedy decode seeded with a (B, P) token prompt after BOS (the
    long-form decode's carry from one chunk to the next): (B, 1 + P +
    max_new_tokens) ids, the prompt echoed.  An empty prompt gives
    ``greedy_decode``'s tokens."""
    return _greedy(model, modality_slots(pitch, spectrogram, waveform),
                   max_new_tokens, suppress_eos, prompt=prompt.long())


@torch.no_grad()
def greedy_decode_sp(model: Model, mesh, spectrogram=None, pitch=None,
                     waveform=None, axis: str = "seq",
                     max_new_tokens: int = 150, suppress_eos: bool = False):
    """The sequence-parallel greedy decode (module doc), on every rank of
    ``mesh``'s ``axis`` with the whole features; the feature time axes
    must divide the axis with blocks of at least the encoder's halo.
    Returns ``greedy_decode``'s (B, 1 + max_new_tokens) ids, the same on
    every rank."""
    from asr_model_tpu_torch.parallel.mesh import block, gather
    from asr_model_tpu_torch.parallel.seq import seq_sharding, sp_encode
    ax = mesh.axis(axis)
    xa = modality_slots(pitch, spectrogram, waveform)
    enc, by_id = {}, {}
    for k, v in xa.items():
        if id(v) not in by_id:          # shared slots encode once
            by_id[id(v)] = gather(sp_encode(model, v, mesh, axis), 1, ax)
        enc[k] = by_id[id(v)]
    proc = model.processor
    kv = proc.precompute_cross(proc.encode_xa(enc))
    kv = {k: (block(kn, 2, ax).contiguous(), block(v, 2, ax).contiguous())
          for k, (kn, v) in kv.items()}
    with seq_sharding(mesh, axis):
        return _greedy(model, xa, max_new_tokens, suppress_eos, xa_kv=kv,
                       buckets=False)


def generate_predictions(model: Model, tokenizer=None, spectrogram=None,
                         pitch=None, waveform=None,
                         max_new_tokens: int = 150):
    """The reference's ``generate``: greedy with EOS suppressed until the
    budget's last token."""
    return greedy_decode(model, spectrogram=spectrogram, pitch=pitch,
                         waveform=waveform, max_new_tokens=max_new_tokens,
                         suppress_eos=True)


@torch.no_grad()
def greedy_decode_stream(model: Model, spectrogram=None, pitch=None,
                         waveform=None, max_new_tokens: int = 150,
                         suppress_eos: bool = False):
    """The incremental greedy decode of a streaming model (``ModelConfig.
    streaming``): the output contract of ``greedy_decode``, one position
    a step.  The K/V caches take the features' dtype (MSheath's running
    sums are f32)."""
    if not model.cfg.streaming:
        raise ValueError("greedy_decode_stream needs ModelConfig("
                         "streaming=True); use greedy_decode")
    xa = modality_slots(pitch, spectrogram, waveform)
    xa_kv = prepare_cross(model, xa)
    ids, done, T = _start(xa, max_new_tokens)
    proc = model.processor
    fx = next(iter(xa.values()))
    state = proc.init_stream_state(ids.shape[0], T, fx.dtype)
    pe = sinusoids(T, proc.dims, proc.theta, device=ids.device)
    for length in range(1, T):
        if length > 1 and (length - 1) % STREAM_CHECK == 0 \
                and bool(done.all()):
            break
        logits, state = proc.decode_stream_step(ids[:, length - 1],
                                                length - 1, state, xa_kv, pe)
        nxt = _next_tokens(logits, done, length, T, suppress_eos)
        ids[:, length] = nxt
        done = done | (nxt == EOS_ID)
    return ids
