"""Batch collation, the counterpart of ``asr_model_tpu/data/collator.py``:
labels become BOS-prefixed ``text_ids`` and EOS-suffixed ``labels``, both
padded with PAD to (batch max + 1), rounded up to ``text_pad_to_multiple``
(else ``pad_to_multiple``); feature tensors are zero-padded on the time
axis to the batch max rounded up to ``pad_to_multiple`` and stacked;
``with_masks`` adds the validity masks.  numpy in, numpy out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

FEATURE_KEYS = ("spectrogram", "waveform", "pitch", "pitch_tokens")


def _round_up(n: int, m: Optional[int]) -> int:
    return ((n + m - 1) // m) * m if m else n


def collate(features: List[Dict[str, Any]], pad_token_id: int = 0,
            bos_token_id: int = 1, eos_token_id: int = 2,
            pad_to_multiple: Optional[int] = None,
            text_pad_to_multiple: Optional[int] = None,
            with_masks: bool = False) -> Dict[str, np.ndarray]:
    batch: Dict[str, np.ndarray] = {}
    keys = set().union(*(f.keys() for f in features))
    if "labels" in keys:
        labels = [list(np.asarray(f["labels"]).tolist()) for f in features]
        tmult = (text_pad_to_multiple if text_pad_to_multiple is not None
                 else pad_to_multiple)
        tgt = _round_up(max(len(l) for l in labels) + 1, tmult)
        ids, labs, mask = [], [], []
        for label in labels:
            dec_in = [bos_token_id] + label
            lab_eos = label + [eos_token_id]
            ids.append(dec_in + [pad_token_id] * (tgt - len(dec_in)))
            labs.append(lab_eos + [pad_token_id] * (tgt - len(lab_eos)))
            mask.append([1] * len(dec_in) + [0] * (tgt - len(dec_in)))
        batch["text_ids"] = np.asarray(ids, dtype=np.int64)
        batch["labels"] = np.asarray(labs, dtype=np.int64)
        if with_masks:
            batch["text_mask"] = np.asarray(mask, dtype=np.bool_)
    for key in FEATURE_KEYS:
        items = [np.asarray(f[key]) for f in features
                 if f.get(key) is not None]
        if not items:
            continue
        n = _round_up(max(it.shape[-1] for it in items), pad_to_multiple)
        padded, masks = [], []
        for it in items:
            pad = n - it.shape[-1]
            padded.append(np.pad(it, [(0, 0)] * (it.ndim - 1) + [(0, pad)],
                                 constant_values=pad_token_id)
                          if pad > 0 else it)
            masks.append([1] * it.shape[-1] + [0] * pad)
        batch[key] = np.stack(padded)
        if with_masks:
            batch[f"{key}_mask"] = np.asarray(masks, dtype=np.bool_)
    return batch


@dataclass
class DataCollator:
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_to_multiple: Optional[int] = None
    text_pad_to_multiple: Optional[int] = None
    with_masks: bool = False

    def __call__(self, features):
        return collate(features, self.pad_token_id, self.bos_token_id,
                       self.eos_token_id, self.pad_to_multiple,
                       self.text_pad_to_multiple, self.with_masks)
