"""LibriSpeech corpus access, the counterpart of
``asr_model_tpu/data/librispeech.py``:

* ``LIBRISPEECH_URLS`` / ``download_and_extract``: fetch and extract one
  OpenSLR split (needs the network; a split already extracted under
  ``cache_dir`` is returned as it is, with no fetch);
* ``iter_librispeech_split(split_dir)``: walk an extracted
  ``LibriSpeech/<split>`` tree, read the ``<spk>-<chap>.trans.txt``
  transcripts and yield ``{file, text, speaker_id, chapter_id, id}``;
  malformed lines, malformed utterance ids and utterances without audio
  are skipped with a warning;
* ``LibriSpeechDataset``: a map-style dataset featurising one example an
  item on ``device`` (FLAC through the native decoder), with optional
  caching;
* ``load_dataset``: ``download_and_extract`` then the dataset.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterator, List, Optional

from asr_model_tpu_torch.data.features import extract_features

logger = logging.getLogger(__name__)

_BASE = "http://www.openslr.org/resources/12/"
LIBRISPEECH_URLS = {
    split: _BASE + split + ".tar.gz"
    for split in ("dev-clean", "test-clean", "train-clean-100",
                  "train-clean-360", "dev-other", "test-other",
                  "train-other-500")}


def download_and_extract(split: str, cache_dir: str) -> str:
    """Fetch and extract one split; returns the split directory.  No-op
    when it is already extracted."""
    os.makedirs(cache_dir, exist_ok=True)
    out_dir = os.path.join(cache_dir, "LibriSpeech", split)
    if os.path.isdir(out_dir):
        return out_dir
    import tarfile
    import urllib.request
    url = LIBRISPEECH_URLS[split]
    tar_path = os.path.join(cache_dir, os.path.basename(url))
    if not os.path.exists(tar_path):
        logger.info("downloading %s", url)
        urllib.request.urlretrieve(url, tar_path)
    with tarfile.open(tar_path, "r:gz") as tf:
        tf.extractall(cache_dir)
    return out_dir


def iter_librispeech_split(split_dir: str) -> Iterator[Dict[str, Any]]:
    """Yield {file, text, speaker_id, chapter_id, id} from an extracted
    split tree, in sorted walk order (the audio is decoded later, by the
    dataset)."""
    for dirpath, _dirnames, filenames in sorted(os.walk(split_dir)):
        for fname in sorted(filenames):
            if not fname.endswith(".trans.txt"):
                continue
            trans_path = os.path.join(dirpath, fname)
            with open(trans_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split(" ", 1)
                    if len(parts) != 2:
                        logger.warning("malformed transcript line in %s: %r",
                                       trans_path, line[:80])
                        continue
                    utt_id, text = parts
                    ids = utt_id.split("-")
                    if len(ids) < 3:
                        logger.warning("malformed utterance id %r", utt_id)
                        continue
                    audio = next((c for c in (os.path.join(dirpath,
                                                           utt_id + ext)
                                              for ext in (".flac", ".wav"))
                                  if os.path.exists(c)), None)
                    if audio is None:
                        logger.warning("missing audio for %s", utt_id)
                        continue
                    yield {"file": audio, "text": text,
                           "speaker_id": int(ids[0]),
                           "chapter_id": int(ids[1]), "id": utt_id}


class LibriSpeechDataset:
    """Map-style dataset over an extracted split: one example featurised
    an item (with ``cache``, once an example); ``limit`` keeps the first
    examples of the walk."""

    def __init__(self, split_dir: str, tokenizer=None,
                 extract_args: Optional[Dict[str, Any]] = None,
                 cache: bool = False, limit: Optional[int] = None,
                 device=None):
        self.examples: List[Dict[str, Any]] = list(
            iter_librispeech_split(split_dir))
        if limit:
            self.examples = self.examples[:limit]
        self.tokenizer, self.extract_args = tokenizer, extract_args or {}
        self.device = device
        self._cache: Optional[List] = ([None] * len(self.examples)
                                       if cache else None)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self._cache is not None and self._cache[idx] is not None:
            return self._cache[idx]
        ex = self.examples[idx]
        item = extract_features({"audio": ex["file"],
                                 "transcription": ex["text"]},
                                tokenizer=self.tokenizer, device=self.device,
                                **self.extract_args)
        if self._cache is not None:
            self._cache[idx] = item
        return item


def load_dataset(split: str = "dev-clean", cache_dir: str = "./cache",
                 tokenizer=None, extract_args=None, **kw):
    """``download_and_extract`` (a no-op where the split is extracted),
    then the split's ``LibriSpeechDataset``."""
    split_dir = download_and_extract(split, cache_dir)
    return LibriSpeechDataset(split_dir, tokenizer=tokenizer,
                              extract_args=extract_args, **kw)
