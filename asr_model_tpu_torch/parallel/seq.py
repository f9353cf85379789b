"""Sequence parallelism: the counterpart of
``asr_model_tpu/parallel/seq.py``.

* ``seq_sharded_attention``: attention of replicated queries over keys
  and values whose time axis is split over the ranks of an axis; each
  rank holds its time block.  Every rank computes its block's running
  max, normaliser and weighted values; the max merges with an
  ``all_reduce`` MAX and the other two with a SUM (flash attention's
  tile merge across ranks).  A row with no valid key on any rank gives
  zeros (the merged max is -inf, taken as 0, as in JAX).  The products
  are ``torch.matmul`` in f32 (the JAX package's are einsums outside
  any kernel), the result in q's dtype.
* ``seq_sharding(mesh, axis)`` / ``active_seq_sharding()``: while the
  context is open, the cached cross-attention of a decode
  (``models/attention.py``) takes this route over the axis.
* ``sp_encode``: the AudioEncoder over a feature track whose time axis
  is split over the axis.  The conv stack is time-local (one-sided
  receptive field ``encoder_halo(layer) = 1 + 9 layer`` frames), so a
  rank exchanges ``halo`` frames with each neighbour (send / receive),
  runs the stack on halo + block + halo with the rows outside the
  sequence zeroed before every padded convolution (the unsharded SAME
  padding) and the global positions' sinusoids, and keeps its block:
  exactly the unsharded encoder.  Train mode, ``encoder_transformer``
  (a global self-attention) and, under ``encoder_norm``, a norm that
  couples time positions are refused, as in JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from asr_model_tpu_torch.parallel.mesh import Axis, pmax, psum

TIME_COUPLED_NORMS = ("instancenorm", "instancenorm2d", "groupnorm",
                      "globalnorm")


def seq_sharded_attention(q, k, v, axis: Axis, kv_valid=None):
    """(B, H, Tq, D) queries (the same on every rank) over this rank's
    (B, H, Tk/n, D) block of keys and values (``kv_valid`` (B, Tk/n)
    bool, its block of the mask) -> (B, H, Tq, D), the unsharded
    softmax attention with the 1/sqrt(D) scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s,
                        torch.full_like(s, float("-inf")))
    m = pmax(torch.amax(s, dim=-1, keepdim=True), axis)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    l_g = psum(p.sum(dim=-1, keepdim=True), axis)
    acc_g = psum(torch.matmul(p, v.float()), axis)
    return (acc_g / torch.clamp(l_g, min=1e-30)).to(q.dtype)


_SEQ: list = []


@contextlib.contextmanager
def seq_sharding(mesh, axis: str = "seq"):
    """While open, a decode's cached cross-attention runs
    ``seq_sharded_attention`` over ``mesh``'s ``axis``; the cached K/V it
    is given must be this rank's time block."""
    _SEQ.append(mesh.axis(axis))
    try:
        yield
    finally:
        _SEQ.pop()


def active_seq_sharding():
    """The open context's axis, or None."""
    return _SEQ[-1] if _SEQ else None


def encoder_halo(layer: int) -> int:
    """One-sided receptive field of the AudioEncoder's conv stack: the
    stem k3 (+1), per block the wn k3 (+1), ConvLite's depthwise k15
    (+7) and the dw k3 (+1)."""
    return 1 + 9 * layer


def _exchange(x, halo: int, axis: Axis):
    """(left, right): the previous rank's last ``halo`` frames and the
    next rank's first, zeros past either end of the sequence."""
    left = torch.zeros_like(x[..., :halo])
    right = torch.zeros_like(x[..., :halo])
    if axis.group is None:
        return left, right
    n, i = axis.size, axis.index
    peer = lambda j: dist.get_global_rank(axis.group, j)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, x[..., :halo].contiguous(), peer(i - 1),
                           axis.group),
                dist.P2POp(dist.irecv, left, peer(i - 1), axis.group)]
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, x[..., -halo:].contiguous(),
                           peer(i + 1), axis.group),
                dist.P2POp(dist.irecv, right, peer(i + 1), axis.group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return left, right


@torch.no_grad()
def sp_encode(model, feature, mesh, axis: str = "seq",
              train: bool = False):
    """``model.enc`` on one (B, C, T) feature track (the whole track on
    every rank) with T split over ``mesh``'s ``axis``: returns this
    rank's (B, T/n, dims) block of the unsharded encoder's output (the
    module doc; ``mesh.gather`` joins the blocks)."""
    from asr_model_tpu_torch.ops.audio import sinusoids
    if train:
        raise ValueError("sp_encode is inference-only")
    if model.cfg.encoder_transformer:
        raise ValueError("sp_encode requires encoder_transformer=False "
                         "(global self-attention is not time-local)")
    if model.cfg.encoder_norm and model.dims.n_type in TIME_COUPLED_NORMS:
        raise ValueError(
            f"sp_encode with encoder_norm=True requires a position-wise "
            f"norm; {model.dims.n_type!r} couples positions across time")
    ax = mesh.axis(axis)
    n, i = ax.size, ax.index
    B, C, T = feature.shape
    if T % n:
        raise ValueError(f"time axis {T} not divisible by '{axis}' size {n}")
    halo = encoder_halo(model.dims.layer)
    t_local = T // n
    if t_local < halo:
        raise ValueError(f"shard length {t_local} < halo {halo}")
    x = feature[..., i * t_local:(i + 1) * t_local]
    left, right = _exchange(x, halo, ax)
    ext = torch.cat([left, x, right], dim=-1)
    dev = feature.device
    inner = torch.ones(t_local, dtype=torch.bool, device=dev)
    valid = torch.cat([torch.full((halo,), i > 0, device=dev), inner,
                       torch.full((halo,), i < n - 1, device=dev)])
    valid = valid[None].expand(B, -1).contiguous()
    # the extended block's global positions; the halo rows' are clamped
    # (they are discarded)
    pos = torch.clamp(i * t_local - halo + torch.arange(
        t_local + 2 * halo, device=dev), 0, T - 1)
    pe = sinusoids(T, model.dims.dims, model.cfg.theta, device=dev)[pos]
    y = model.enc.process_feature(ext, valid=valid, pe_override=pe)
    return y[:, halo:halo + t_local]
