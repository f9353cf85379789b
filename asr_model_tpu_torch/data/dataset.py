"""Datasets and loaders, the counterparts of
``asr_model_tpu/data/dataset.py``: ``SyntheticDataset`` (deterministic
harmonic tones with a random F0 and a random word sequence, seeded per
utterance), ``data_loader`` (collated numpy batches, one pass),
``Repeated`` (a re-iterable loader), ``random_split`` (the reference's
80/20 split) and ``Prefetcher`` (a worker thread keeping batches ahead).
The dataset over real files (``PreparedDataset``), ``GrammarDataset``
and the FLAC decoder come with data in the repository (ROADMAP Queue 1
item 7)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from asr_model_tpu_torch.data.collator import collate
from asr_model_tpu_torch.data.features import extract_features

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "hello", "world", "speech", "model"]


class SyntheticDataset:
    def __init__(self, n: int = 16, tokenizer=None, seed: int = 0,
                 sample_rate: int = 16000, dur_range=(0.5, 2.0),
                 extract_args: Optional[Dict[str, Any]] = None,
                 sentences: Optional[Sequence[str]] = None, device=None):
        self.n, self.tokenizer = n, tokenizer
        self.sample_rate, self.device = sample_rate, device
        self.extract_args = extract_args or {}
        self.specs = []
        for i in range(n):
            rng = np.random.RandomState(seed + i)
            dur = float(rng.uniform(*dur_range))
            f0 = float(rng.uniform(100, 300))
            if sentences is not None:
                text = sentences[i % len(sentences)]
            else:
                text = " ".join(rng.choice(WORDS, size=rng.randint(2, 8)))
            self.specs.append((dur, f0, text, seed + i))

    def __len__(self):
        return self.n

    def audio(self, idx: int) -> np.ndarray:
        dur, f0, _text, seed = self.specs[idx]
        sr = self.sample_rate
        t = np.arange(int(sr * dur)) / sr
        rng = np.random.RandomState(seed)
        x = sum((0.5 ** k) * np.sin(2 * np.pi * f0 * (k + 1) * t)
                for k in range(3))
        x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t))   # AM envelope
        x = x + 0.01 * rng.randn(len(t))
        return (x / np.abs(x).max()).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return extract_features(
            {"audio": {"array": self.audio(idx),
                       "sampling_rate": self.sample_rate},
             "transcription": self.specs[idx][2]},
            tokenizer=self.tokenizer, device=self.device,
            **self.extract_args)


def data_loader(dataset, batch_size: int = 1, shuffle: bool = False,
                seed: int = 0, pad_to_multiple: Optional[int] = None,
                text_pad_to_multiple: Optional[int] = None,
                with_masks: bool = False, drop_last: bool = False
                ) -> Iterator[Dict[str, np.ndarray]]:
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for start in range(0, len(idx), batch_size):
        sel = idx[start:start + batch_size]
        if drop_last and len(sel) < batch_size:
            return
        yield collate([dataset[int(i)] for i in sel],
                      pad_to_multiple=pad_to_multiple,
                      text_pad_to_multiple=text_pad_to_multiple,
                      with_masks=with_masks)


class Prefetcher:
    """Iterate ``iterable`` on a worker thread, ``depth`` items ahead.
    Each pass is a generator: closing it (``close()``, or dropping it)
    stops the worker and joins it, so nothing of the pass runs after:
    the item in progress is finished and dropped, none is begun."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable, self.depth = iterable, depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self.iterable:
                    if not put(item):
                        return
            except BaseException as e:       # re-raised on the consumer
                put(e)
            finally:
                put(end)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()


class Repeated:
    """A re-iterable ``data_loader`` (one pass per ``iter``)."""

    def __init__(self, dataset, **kw):
        self.dataset, self.kw = dataset, kw

    def __iter__(self):
        return data_loader(self.dataset, **self.kw)

    def __len__(self):
        bs = self.kw.get("batch_size", 1)
        return (len(self.dataset) + bs - 1) // bs


class _Subset:
    def __init__(self, ds, idx):
        self.ds, self.idx = ds, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[int(self.idx[i])]


def random_split(dataset, train_frac: float = 0.8, seed: int = 0):
    idx = np.arange(len(dataset))
    np.random.RandomState(seed).shuffle(idx)
    cut = int(train_frac * len(dataset))
    return _Subset(dataset, idx[:cut]), _Subset(dataset, idx[cut:])
