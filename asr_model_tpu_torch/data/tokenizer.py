"""Byte-level BPE tokenizer: the port's own copy of
``asr_model_tpu/data/tokenizer.py``.

The HF ``tokenizers`` pipeline that ``assets/tokenizer.json`` describes:
NFKC normalizer -> ByteLevel pre-tokenizer (a prefix space, the GPT-2
split) -> BPE (40k vocab, 39,741 merges, no unk, no byte fallback) ->
ByteLevel decoder.  Specials are pinned: ``<PAD>`` = 0, ``<BOS>`` = 1,
``<EOS>`` = 2.

It needs neither ``regex`` nor ``tokenizers``.  The GPT-2 split pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

is the hand-written scanner ``split_words``: letters and numbers are the
``L*`` and ``N*`` categories of ``unicodedata`` (not ``str.isalpha`` /
``isnumeric``: ``isnumeric`` accepts Lo numerals such as U+4E00), and
whitespace is ``str.isspace()`` without U+001C..U+001F, which ``regex``'s
``\\s`` rejects.  Python's tables are Unicode 15.0 on Python 3.12; on
every code point assigned there the scanner splits as the pattern does.
A ``regex`` build with newer tables classes some code points that
Python's tables leave unassigned (U+0C5C, a letter since Unicode 16)
otherwise, and there the two differ.

Decoding, all that serving needs, is a pure byte mapping.
"""

from __future__ import annotations

import functools
import json
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _kind(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if _is_space(c):
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "O"


def split_words(text: str) -> List[str]:
    """The GPT-2 pre-tokenizer split, alternative by alternative in the
    pattern's leftmost-first order."""
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []

    def run(j: int, kind: str) -> int:
        while j < n and kinds[j] == kind:
            j += 1
        return j

    while i < n:
        c, k = text[i], kinds[i]
        if c == "'":
            con = next((s for s in _CONTRACTIONS
                        if text.startswith(s, i + 1)), None)
            if con is not None:
                out.append(text[i:i + 1 + len(con)])
                i += 1 + len(con)
                continue
        if c == " " and i + 1 < n and kinds[i + 1] != "S":
            # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+' with the space
            j = run(i + 1, kinds[i + 1])
        elif k != "S":
            j = run(i, k)
        else:
            j = run(i, "S")
            # '\s+(?!\S)': a run before a non-space gives up its last
            # character; a single one falls through to '\s+'
            if j < n and j - i > 1:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte -> unicode visible-character table (the ByteLevel
    alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


class Tokenizer:
    """Byte-level BPE encode / decode with the HF crate's results."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 added_tokens: Optional[Dict[str, int]] = None,
                 add_prefix_space: bool = True, normalize_nfkc: bool = True):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.added_tokens = dict(added_tokens or {})
        self.add_prefix_space = add_prefix_space
        self.normalize_nfkc = normalize_nfkc
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self.pad_token_id, self.bos_token_id, self.eos_token_id = 0, 1, 2

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        model = blob["model"]
        merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" "))
                  for m in model["merges"]]
        added = {t["content"]: t["id"] for t in blob.get("added_tokens", [])}
        pre = blob.get("pre_tokenizer") or {}
        norm = blob.get("normalizer") or {}
        return cls(model["vocab"], merges, added_tokens=added,
                   add_prefix_space=pre.get("add_prefix_space", True),
                   normalize_nfkc=norm.get("type") == "NFKC")

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        while len(word) > 1:
            best = min(_pairs(word),
                       key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def _split_on_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """Split out the added (special) tokens, which match before
        normalisation."""
        segments: List[Tuple[str, Optional[int]]] = [(text, None)]
        for content, tid in self.added_tokens.items():
            nxt: List[Tuple[str, Optional[int]]] = []
            for seg, seg_id in segments:
                if seg_id is not None or content not in seg:
                    nxt.append((seg, seg_id))
                    continue
                parts = seg.split(content)
                for i, part in enumerate(parts):
                    if part:
                        nxt.append((part, None))
                    if i < len(parts) - 1:
                        nxt.append((content, tid))
            segments = nxt
        return segments

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Text -> ids.  The pipeline adds no specials;
        ``add_special_tokens=False`` also drops any special id that
        appeared literally in the text."""
        ids: List[int] = []
        for seg, seg_id in self._split_on_added(text):
            if seg_id is not None:
                ids.append(seg_id)
                continue
            if self.normalize_nfkc:
                seg = unicodedata.normalize("NFKC", seg)
            if self.add_prefix_space and seg and not seg.startswith(" "):
                seg = " " + seg
            for piece in split_words(seg):
                mapped = "".join(self.byte_encoder[b]
                                 for b in piece.encode("utf-8"))
                ids.extend(self.vocab[s] for s in self._bpe(mapped)
                           if s in self.vocab)
        if not add_special_tokens:
            special = set(self.added_tokens.values())
            ids = [i for i in ids if i not in special]
        return ids

    def _decode_raw(self, ids: Iterable[int]) -> str:
        data = bytearray()
        for ch in "".join(self.inv_vocab.get(int(i), "") for i in ids):
            b = self.byte_decoder.get(ch)
            if b is None:
                data.extend(ch.encode("utf-8"))
            else:
                data.append(b)
        # the ByteLevel decoder keeps the prefix space encode added
        return data.decode("utf-8", errors="replace")

    def decode(self, ids, pad_token_id=0, bos_token_id=1,
               eos_token_id=2) -> str:
        """Drop PAD, BOS, EOS and -100, then byte-decode."""
        skip = (pad_token_id, bos_token_id, eos_token_id, -100)
        return self._decode_raw(int(i) for i in _to_list(ids)
                                if int(i) not in skip)

    def batch_decode(self, ids_list, pad_token_id=0, bos_token_id=1,
                     eos_token_id=2) -> List[str]:
        return [self.decode(ids, pad_token_id, bos_token_id, eos_token_id)
                for ids in _to_list(ids_list)]

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added_tokens.get(token, self.vocab.get(token))

    def get_vocab_size(self) -> int:
        return len(self.vocab)


def _to_list(x):
    return x.tolist() if hasattr(x, "tolist") else x


def setup_tokenizer(path: str) -> Tokenizer:
    """Loads tokenizer.json and pins PAD / BOS / EOS = 0 / 1 / 2."""
    tok = Tokenizer.from_file(path)
    tok.pad_token_id, tok.bos_token_id, tok.eos_token_id = 0, 1, 2
    return tok
