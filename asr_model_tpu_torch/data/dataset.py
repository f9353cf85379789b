"""Datasets and loaders, the counterparts of
``asr_model_tpu/data/dataset.py``: ``PreparedDataset`` (alias
``prepare_datasets``: audio files listed in a ``metadata.csv``),
``SyntheticDataset`` (deterministic harmonic tones with a random F0 and
a random word sequence, seeded per utterance), ``GrammarDataset``
(speech whose audio is a fixed function of its text: each lexicon word
a two-tone signature), ``data_loader`` (collated numpy batches, one
pass), ``Repeated`` (a re-iterable loader), ``random_split`` (the
reference's 80/20 split) and ``Prefetcher`` (a worker thread keeping
batches ahead).  The LibriSpeech reader is ``data/librispeech.py``.
Each dataset featurises on ``device`` (``extract_features``)."""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from asr_model_tpu_torch.data.collator import collate
from asr_model_tpu_torch.data.features import extract_features

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "hello", "world", "speech", "model"]


def read_metadata(path: str) -> List[Dict[str, str]]:
    """The rows of a ``metadata.csv`` (a header, then one row a line) as
    ``pd.read_csv`` gives them to the JAX package's ``PreparedDataset``:
    in file order, empty and whitespace-only lines skipped, RFC 4180
    quoting, a leading UTF-8 byte-order mark dropped, every field a
    string.  The ``audio`` and ``sentence`` columns must exist; a row
    longer than the header, or with either column empty (where pandas
    would shift the columns or give NaN), is a ValueError."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [r for r in csv.reader(f)
                 if len(r) > 1 or (r and r[0].strip())]
    if not lines:
        raise ValueError(f"{path}: empty metadata file")
    head, body = lines[0], lines[1:]
    missing = {"audio", "sentence"} - set(head)
    if missing:
        raise KeyError(f"{path}: no column {sorted(missing)}")
    rows = []
    for i, r in enumerate(body):
        if len(r) > len(head):
            raise ValueError(f"{path}: row {i} has {len(r)} fields, the "
                             f"header {len(head)}")
        row = dict(zip(head, r))
        for col in ("audio", "sentence"):
            if not row.get(col):
                raise ValueError(f"{path}: row {i} has no {col!r}")
        rows.append(row)
    return rows


class PreparedDataset:
    """A ``metadata.csv`` (columns ``audio``, a path under ``data_dir``,
    and ``sentence``), featurised one row an item (with ``cache``, once
    a row)."""

    def __init__(self, metadata_file: str, data_dir: str, tokenizer=None,
                 extract_args: Optional[Dict[str, Any]] = None,
                 cache: bool = False, device=None):
        self.metadata = read_metadata(metadata_file)
        self.data_dir, self.tokenizer = data_dir, tokenizer
        self.extract_args, self.device = extract_args or {}, device
        self._cache: Optional[List] = ([None] * len(self.metadata)
                                       if cache else None)

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self._cache is not None and self._cache[idx] is not None:
            return self._cache[idx]
        row = self.metadata[idx]
        item = extract_features(
            {"audio": os.path.join(self.data_dir, row["audio"]),
             "transcription": row["sentence"]},
            tokenizer=self.tokenizer, device=self.device,
            **self.extract_args)
        if self._cache is not None:
            self._cache[idx] = item
        return item


prepare_datasets = PreparedDataset


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


class GrammarDataset:
    """Speech from a 12-word grammar whose audio is a function of its
    text: each lexicon word renders to a fixed two-tone signature, a
    sentence to its words' signatures with a short silence between
    them and a noise floor seeded per utterance, so a model can
    transcribe sentences it never saw (``make_split`` keeps the eval
    sentences out of the train ones)."""

    LEXICON = WORDS

    def __init__(self, sentences: Sequence[str], tokenizer=None,
                 extract_args: Optional[Dict[str, Any]] = None,
                 sample_rate: int = 16000, tone_sec: float = 0.12,
                 gap_sec: float = 0.04, noise: float = 0.003,
                 seed: int = 0, device=None):
        self.sentences = list(sentences)
        self.tokenizer, self.extract_args = tokenizer, extract_args or {}
        self.sample_rate, self.tone_sec, self.gap_sec = (sample_rate,
                                                         tone_sec, gap_sec)
        self.noise, self.seed, self.device = noise, seed, device
        # a word's two frequencies: log-spaced from 220 Hz to 2.2 kHz by
        # its lexicon index, the second a fixed permutation of the first
        rng = np.random.RandomState(1234)
        n = len(self.LEXICON)
        base = 220.0 * (2200.0 / 220.0) ** (np.arange(n) / max(n - 1, 1))
        second = base[rng.permutation(n)]
        self._freqs = {w: (float(base[i]), float(second[i]))
                       for i, w in enumerate(self.LEXICON)}

    @classmethod
    def make_split(cls, n_train: int, n_eval: int, words=(3, 6),
                   seed: int = 0):
        """Disjoint lists of distinct train and eval sentences of
        ``words[0]``..``words[1]`` lexicon words."""
        rng = np.random.RandomState(seed)
        seen, out = set(), []
        while len(out) < n_train + n_eval:
            k = rng.randint(words[0], words[1] + 1)
            s = " ".join(rng.choice(cls.LEXICON, size=k))
            if s not in seen:
                seen.add(s)
                out.append(s)
        return out[:n_train], out[n_train:]

    def render(self, text: str, seed: int = 0) -> np.ndarray:
        """The waveform of a sentence, peak-normalised float32."""
        sr = self.sample_rate
        t = np.arange(int(sr * self.tone_sec)) / sr
        gap = np.zeros(int(sr * self.gap_sec), np.float32)
        rng = np.random.RandomState(seed)
        e = int(0.005 * sr)         # 5 ms raised-cosine edges
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(e) / e)
        segs = []
        for w in text.split():
            for f in self._freqs[w]:
                x = np.sin(2 * np.pi * f * t) \
                    + 0.3 * np.sin(2 * np.pi * 2 * f * t)
                env = np.ones_like(x)
                env[:e] = ramp
                env[-e:] = ramp[::-1]
                segs.append((x * env).astype(np.float32))
            segs.append(gap)
        audio = np.concatenate(segs[:-1]) if segs else np.zeros(1, np.float32)
        audio = audio + self.noise * rng.randn(len(audio)).astype(np.float32)
        return (audio / np.abs(audio).max()).astype(np.float32)

    def __len__(self):
        return len(self.sentences)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        text = self.sentences[idx]
        return extract_features(
            {"audio": {"array": self.render(text, seed=self.seed + idx),
                       "sampling_rate": self.sample_rate},
             "transcription": text},
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
