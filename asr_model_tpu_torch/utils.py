"""Small shared helpers: modality-priority selection, the safe L2
normalisation, and device resolution for the port's entry points."""

from __future__ import annotations

import torch


def have(a):
    return a is not None


def aorb(a, b):
    return a if have(a) else b


def aborc(a, b, c):
    return aorb(a, aorb(b, c))


def abcord(a, b, c, d):
    return aorb(a, aborc(b, c, d))


def no_none(x: dict) -> dict:
    """The entries of a feature dict that are not None."""
    return {k: v for k, v in x.items() if v is not None}


def exact_div(x: int, y: int) -> int:
    if x % y:
        raise ValueError(f"{x} is not a multiple of {y}")
    return x // y


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """``F.normalize`` semantics: t / max(||t||, eps), with a norm that
    is exactly 0 (not NaN) for an all-zero row."""
    sq = torch.sum(t * t, dim=dim, keepdim=True)
    n = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq,
                                                   torch.ones_like(sq))),
                    torch.zeros_like(sq))
    return t / torch.clamp(n, min=eps)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA, and a
    missing CUDA device is an error unless the caller asked for the
    CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
