"""Evaluation metrics and gradient diagnostics, the counterparts of
``asr_model_tpu/train/metrics.py``: word-level ``levenshtein`` and
``wer_batch`` (WER% = errors / reference words * 100 over lowercased
whitespace tokens) through the native engine (``native/wer.cpp``, the
words interned to int ids), with ``levenshtein_dp``, the same two-row DP
in Python, kept as its oracle; ``clean_ids`` / ``clean_batch``
(dropping -100, PAD, BOS, EOS), ``compute_metrics`` (WER and
efficiency score), ``track_grad_norms`` and ``spectral_entropy``."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def levenshtein(reference_words: List[str],
                hypothesis_words: List[str]) -> int:
    """Word-level edit distance by the native engine."""
    from asr_model_tpu_torch.native import wer_levenshtein
    interned: Dict[str, int] = {}
    ids = lambda words: [interned.setdefault(w, len(interned))
                         for w in words]
    return wer_levenshtein(ids(reference_words), ids(hypothesis_words))


def levenshtein_dp(reference_words: List[str],
                   hypothesis_words: List[str]) -> int:
    """The same edit distance in Python (two-row DP): the native
    engine's oracle."""
    m, n = len(reference_words), len(hypothesis_words)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for q in range(1, m + 1):
        cur = [q] + [0] * n
        rw = reference_words[q - 1]
        for k in range(1, n + 1):
            if rw == hypothesis_words[k - 1]:
                cur[k] = prev[k - 1]
            else:
                cur[k] = 1 + min(prev[k - 1], cur[k - 1], prev[k])
        prev = cur
    return prev[n]


def wer_batch(references: List[str], hypotheses: List[str]) -> float:
    errors = words = 0
    for ref, hyp in zip(references, hypotheses):
        ref_words = ref.lower().split()
        errors += levenshtein(ref_words, hyp.lower().split())
        words += len(ref_words)
    return errors / words * 100 if words > 0 else 0.0


def clean_ids(ids, pad_token_id=0, bos_token_id=1, eos_token_id=2):
    if hasattr(ids, "tolist"):
        ids = ids.tolist()
    skip = (-100, pad_token_id, bos_token_id, eos_token_id)
    return [int(i) for i in ids if i not in skip]


def clean_batch(batch_ids, pad_token_id=0, bos_token_id=1, eos_token_id=2):
    return [clean_ids(seq, pad_token_id, bos_token_id, eos_token_id)
            for seq in batch_ids]


def track_grad_norms(named_grads) -> Dict[str, float]:
    """L2 norm of each gradient, keyed by parameter name (pairs of
    (name, grad); a None grad counts as 0)."""
    return {name: 0.0 if g is None else float(torch.linalg.vector_norm(
        g.detach().float().reshape(-1)))
        for name, g in named_grads}


def spectral_entropy(grad, n_bands: int = 64) -> float:
    """Normalised Shannon entropy of the FFT power of the first 2048
    gradient values."""
    if isinstance(grad, torch.Tensor):
        grad = grad.detach().float().cpu().numpy()
    if grad is None or np.size(grad) < n_bands:
        return 1.0
    flat = np.asarray(grad).reshape(-1)[:2048].astype(np.float32)
    psd = np.abs(np.fft.rfft(flat)) ** 2
    p = psd / (psd.sum() + 1e-8)
    return float(-np.sum(p * np.log(p + 1e-8)) / math.log(p.shape[0]))


def compute_metrics(pred: Dict[str, Any], tokenizer=None,
                    num_params_m: Optional[float] = None, grads=None,
                    print_pred: bool = False,
                    num_samples: int = 0) -> Dict[str, float]:
    """WER and efficiency score ((100 - WER) / M params) from
    {"predictions", "label_ids"}; 3-D predictions are logits (argmax)."""
    pred_ids, label_ids = pred["predictions"], pred["label_ids"]
    if isinstance(pred_ids, tuple):
        pred_ids = pred_ids[0]
    if getattr(pred_ids, "ndim", 0) == 3:
        pred_ids = np.argmax(np.asarray(pred_ids, dtype=np.float32), -1)
    label_ids = clean_batch(list(label_ids))
    pred_ids = clean_batch(list(pred_ids))
    pred_str = tokenizer.batch_decode(pred_ids)
    label_str = tokenizer.batch_decode(label_ids)
    if print_pred:
        for q in range(min(num_samples, len(pred_ids))):
            print(f"Pred tokens: {pred_ids[q]}")
            print(f"Label tokens: {label_ids[q]}")
            print(f"Pred: '{pred_str[q]}'")
            print(f"Label: '{label_str[q]}'")
            print("-" * 40)
    wer = wer_batch(label_str, pred_str)
    out = {"wer": float(wer),
           "efficiency_score": float((100 - wer) / num_params_m)
           if num_params_m else 0.0}
    if grads is not None:
        for k, v in track_grad_norms(grads).items():
            out[f"per_layer_norms_{k}"] = v
    return out
