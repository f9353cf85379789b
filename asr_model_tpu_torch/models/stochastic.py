"""The stochastic routing primitives in their eval forms.

With no random draw, the reference's hard gumbel-softmax is a one-hot
of the argmax (first maximum on ties) and the straight-through
threshold is ``x > t``; the port is eval-only, so these are the whole
forward."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hard_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Eval gumbel-softmax (tau = 1, hard): one-hot of the argmax."""
    idx = torch.argmax(logits, dim=-1)
    return F.one_hot(idx, logits.shape[-1]).to(logits.dtype)


def ste_threshold(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return (x > threshold).to(x.dtype)
