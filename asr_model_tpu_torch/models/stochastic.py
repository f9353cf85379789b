"""Stochastic routing primitives and the train-mode context.

The reference draws its gumbel noise from torch's global RNG; the JAX
package draws it from the flax rng collection ``"gumbel"`` and routes
deterministically (a hard argmax) without one.  Here a caller's
``torch.Generator`` draws the noise (``sample_gumbel``), and
``gumbel_softmax(logits, noise)`` is the straight-through form: the
forward value is the one-hot of the argmax, the gradient the soft
one's.  ``noise=None`` is the noise-free limit (ties go to the first
maximum, like ``jax.lax.top_k``).

``mode(train, gen)`` is the counterpart of flax's ``train=`` flag and
``rngs=`` collection for one forward call: modules read
``train_mode()`` (BatchNorm batch statistics, dropout) and
``generator()`` (gumbel and dropout draws, in call order), collect their
side results there (BatchNorm's new running statistics, MSheath's jump
counter), and take the eval-only kernels only when ``eval_route()``:
not training and no generator, the JAX package's ``rng is None`` gate.
Outside a ``mode`` block every module is in eval with no generator.
``mode(differentiable=True)`` keeps eval semantics (running BatchNorm
statistics, no dropout, the noise-free routing) on the differentiable
routes: the gradient diagnostics take their gradients so, as the JAX
package takes them with ``train=False``.

``remat()`` turns on the checkpoint of the MSheath scan's slot step
(the counterpart of the JAX package's ``scan_remat``), and
``checkpoint(fn, *args)`` is ``torch.utils.checkpoint`` for a piece of
the train forward: its recompute runs inside the backward, on autograd's
thread and after ``mode`` has exited, so it replays the forward's state
(train mode, generator, differentiable flag, remat) with the generator
rewound to where the forward found it (``preserve_rng_state`` restores
only the default generators), and records into a throwaway record, so
no BatchNorm statistic, jump count or MoE aux is taken twice.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from asr_model_tpu_torch.parallel import context as pctx


class _State(threading.local):
    def __init__(self):
        self.train = False
        self.gen = None
        self.differentiable = False  # eval semantics, differentiable routes
        self.remat = False          # checkpoint the MSheath slot steps
        self.depth = 0              # nesting of ``checkpoint`` bodies
        self.batch_stats = None     # {module: (mean, var)} of this call
        self.jstat = None           # summed MSheath jump counter (3,)
        self.moe_aux = None         # the MoE calls' load-balance aux


_STATE = _State()
_FIELDS = ("train", "gen", "differentiable", "remat", "depth",
           "batch_stats", "jstat", "moe_aux")


def _get():
    return tuple(getattr(_STATE, k) for k in _FIELDS)


def _set(values) -> None:
    for k, v in zip(_FIELDS, values):
        setattr(_STATE, k, v)


@contextlib.contextmanager
def mode(train: bool = False, gen=None, differentiable: bool = False):
    """Run a forward in train mode and/or with a noise generator (or, with
    ``differentiable``, in eval on the differentiable routes); yields the
    call's record (``batch_stats``, ``jstat``, ``moe_aux``: a list, one
    scalar an MoE call)."""
    prev = _get()
    _STATE.train, _STATE.gen = bool(train), gen
    _STATE.differentiable = bool(differentiable)
    _STATE.batch_stats, _STATE.jstat, _STATE.moe_aux = {}, None, []
    try:
        yield _STATE
    finally:
        _set(prev)


@contextlib.contextmanager
def remat(on: bool = True):
    """While active, the MSheath scan checkpoints each slot step."""
    prev = _STATE.remat
    _STATE.remat = bool(on)
    try:
        yield
    finally:
        _STATE.remat = prev


def remat_active() -> bool:
    return _STATE.remat


def checkpoint_depth() -> int:
    """How many ``checkpoint`` bodies enclose the running code."""
    return _STATE.depth


def checkpoint(fn, *args, gen=None, context_fn=None):
    """``torch.utils.checkpoint.checkpoint(fn, *args)`` (non-reentrant)
    whose recompute replays this forward's state and the draws of
    ``gen`` (by default the forward's generator; module doc);
    ``context_fn`` as there (a selective policy)."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    state = _get()
    gen = _STATE.gen if gen is None else gen
    start = None if gen is None else gen.get_state()
    runs = [0]

    def body(*a):
        runs[0] += 1
        prev = _get()
        replay = runs[0] > 1 and gen is not None
        if runs[0] == 1:
            _STATE.depth += 1
        else:
            # the recompute, inside the backward: the forward's train,
            # gen, differentiable and remat, one body deeper, and a
            # throwaway record
            _set(state[:4] + (state[4] + 1, {}, None, []))
        if replay:
            after = gen.get_state()
            gen.set_state(start)
        try:
            return fn(*a)
        finally:
            if replay:
                gen.set_state(after)
            _set(prev)

    kw = {} if context_fn is None else {"context_fn": context_fn}
    return torch_checkpoint(body, *args, use_reentrant=False, **kw)


def train_mode() -> bool:
    return _STATE.train


def generator():
    return _STATE.gen


def eval_route() -> bool:
    """True where the eval-only kernels may run: no train mode, no
    generator, no gradient asked of the eval forward."""
    return (not _STATE.train and _STATE.gen is None
            and not _STATE.differentiable)


def record_batch_stats(module, mean, var) -> None:
    if _STATE.batch_stats is not None:
        _STATE.batch_stats[module] = (mean, var)


def batch_stats_of(module):
    """This call's running statistics of ``module`` so far, or None."""
    if _STATE.batch_stats is None:
        return None
    return _STATE.batch_stats.get(module)


def add_jstat(jstat) -> None:
    if _STATE.batch_stats is not None:
        _STATE.jstat = jstat if _STATE.jstat is None else _STATE.jstat + jstat


def collects_moe_aux() -> bool:
    """Whether a record takes the MoE calls' aux (a ``mode`` is open):
    without one, as in a decode, an MoE call skips computing it."""
    return _STATE.moe_aux is not None


def add_moe_aux(aux) -> None:
    if _STATE.moe_aux is not None:
        _STATE.moe_aux.append(aux)


def sample_gumbel(shape, gen, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform on [tiny, 1), drawn
    from ``gen`` on its device (in f32, then cast to ``dtype``); under a
    sharded forward, this rank's block of the whole batch's draw
    (``parallel/context.py:draw``)."""
    u = pctx.draw(shape, lambda s: torch.rand(
        s, generator=gen, device=gen.device, dtype=torch.float32))
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(dtype)


def _straight_through(hard, soft):
    """``hard + soft - soft.detach()``: the forward value ``hard``, the
    gradient ``soft``'s.  Summed in at least f32 and rounded once, as
    XLA's fusion computes the JAX package's form: in bf16 a rounding
    after each op would leave ``hard`` off by up to an ulp of |soft|."""
    ct = torch.promote_types(soft.dtype, torch.float32)
    return (hard.to(ct) + soft.to(ct) - soft.detach().to(ct)).to(soft.dtype)


def gumbel_softmax(logits: torch.Tensor, noise=None, tau: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """softmax((logits + noise) / tau); with ``hard`` the straight-through
    one-hot of its argmax (``y_hard + y_soft - y_soft.detach()``, the
    JAX package's form)."""
    y = logits if noise is None else logits + noise.to(logits.dtype)
    y_soft = torch.softmax(y / tau, dim=-1)
    if not hard:
        return y_soft
    return _straight_through(hard_argmax(y_soft), y_soft)


def hard_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Eval gumbel-softmax (tau = 1, hard): one-hot of the argmax."""
    idx = torch.argmax(logits, dim=-1)
    return F.one_hot(idx, logits.shape[-1]).to(logits.dtype)


def ste_threshold(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """``(x > threshold)`` in x's dtype; where autograd tracks x, the
    straight-through form ``hard + x - x.detach()`` (identity backward)."""
    hard = (x > threshold).to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _straight_through(hard, x)
    return hard
