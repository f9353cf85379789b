"""The port's tokenizer (``asr_model_tpu_torch/data/tokenizer.py``, no
``regex``, no ``tokenizers``) against the JAX package's, which splits
with ``regex``: the same ids on the JAX test corpus and on hypothesis
text drawn from code points assigned in Python's Unicode tables (15.0 on
Python 3.12), the same strings from ``decode`` / ``batch_decode``, the
same asset.  Where ``regex``'s tables are newer than Python's, the two
differ on code points Python leaves unassigned; one test pins that.
"""

import hashlib
import os
import sys
import unicodedata

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from asr_model_tpu.data.tokenizer import setup_tokenizer as jtokenizer

from asr_model_tpu_torch.data.tokenizer import setup_tokenizer, split_words

ROOT = os.path.join(os.path.dirname(__file__), "..")
JASSET = os.path.join(ROOT, "asr_model_tpu", "assets", "tokenizer.json")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")

CORPUS = [
    "HELLO WORLD",
    "the quick brown fox jumps over the lazy dog",
    "MISTER QUILTER IS THE APOSTLE OF THE MIDDLE CLASSES",
    "he said: \"don't do that!\"  (twice)",
    "numbers 1234 and 56.78 mixed-in",
    "unicode caf\u00e9 na\u00efve \u2014 em\u2013dash \u00bd",
    "  leading and   multiple   spaces ",
    "",
    "a",
    "\u00c4mter \ufb01ne ligature \ufb01",
    "newline\nand\ttab",
    "it's they're we've I'm you'll he'd 'S 'x''s",
    "<BOS>hello<EOS> <PAD>",
    "\x1c\x1d\x1e\x1f sep\x85next\u3000ideo",
    "\u4e00\u4e8c\u4e09 \u56db\u4e94 \u216b\u2163 \u00b2\u00b3 \u02c6modifier a\u0301 \u0663\u0664",
    "   word\n\n\nword \t x",
]

# code points assigned in Python's tables (surrogates and private use
# aside), and hand-picked trouble: Lm, Mn, Nl, No, CJK numerals, the
# information separators, NEL, the ideographic space
_ASSIGNED = [cp for cp in range(0x110000)
             if unicodedata.category(chr(cp)) not in ("Cn", "Cs", "Co")]
_PICKED = ("\u02b0\u02c6\u0301\u0300\u2160\u216b\u00bd\u00b2\u4e00\u4e8c"
           "\u96f6\x1c\x1d\x1e\x1f\x85\u3000 '\n\t")
_PIECES = st.one_of(
    st.sampled_from(_ASSIGNED).map(chr),
    st.sampled_from(list(_PICKED)),
    st.integers(1, 5).map(lambda n: " " * n),
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'x",
                     "hello", "WORLD", "123", "4.5", "!?", "<BOS>", "<EOS>",
                     "caf\u00e9", " word", "  word"]))


@pytest.fixture(scope="module")
def toks():
    return jtokenizer(JASSET), setup_tokenizer(ASSET)


@pytest.mark.parametrize("text", CORPUS)
def test_encode_matches_jax_on_the_corpus(toks, text):
    jt, pt = toks
    assert pt.encode(text) == jt.encode(text)
    assert pt.encode(text, add_special_tokens=False) == \
        jt.encode(text, add_special_tokens=False)


@settings(max_examples=300, deadline=None)
@given(text=st.lists(_PIECES, max_size=24).map("".join))
def test_encode_matches_jax_on_assigned_text(toks, text):
    jt, pt = toks
    assert pt.encode(text) == jt.encode(text)


@settings(max_examples=150, deadline=None)
@given(ids=st.lists(st.one_of(st.integers(0, 39999), st.just(-100),
                              st.sampled_from([0, 1, 2])), max_size=40))
def test_decode_matches_jax(toks, ids):
    jt, pt = toks
    assert pt.decode(ids) == jt.decode(ids)
    assert pt.batch_decode([ids, ids[::-1]]) == \
        jt.batch_decode([ids, ids[::-1]])


def test_specials_pinned(toks):
    _, pt = toks
    assert (pt.pad_token_id, pt.bos_token_id, pt.eos_token_id) == (0, 1, 2)
    assert [pt.token_to_id(t) for t in ("<PAD>", "<BOS>", "<EOS>")] == \
        [0, 1, 2]
    assert pt.get_vocab_size() == 40000 and len(pt.ranks) == 39741


def test_split_keeps_the_lookahead_and_separators():
    assert split_words("a   b") == ["a", "  ", " b"]
    assert split_words("a  ") == ["a", "  "]
    assert split_words(" \nx") == [" ", "\n", "x"]
    assert split_words("\x1c x") == ["\x1c", " x"]       # not \s for regex
    assert split_words("\u4e00\u4e8c 12") == ["\u4e00\u4e8c", " 12"]
    assert split_words("x'sy") == ["x", "'s", "y"]


def test_divergence_from_newer_regex_tables_is_only_unassigned():
    """A post-15.0 letter (U+0C5C, unassigned in Python 3.12's tables):
    the port classes it by Python's tables, a ``regex`` build with newer
    tables may class it as a letter.  Over every code point, the two
    disagree only where Python's tables leave the point unassigned."""
    regex = pytest.importorskip("regex")
    c = "\u0c5c"
    assert unicodedata.category(c) == "Cn"
    assert split_words("a" + c + "b") == ["a", c, "b"]
    every = "".join(map(chr, range(sys.maxunicode + 1)))
    cats = [unicodedata.category(ch) for ch in every]
    ours = ({ch for ch, cat in zip(every, cats) if cat[0] == "L"},
            {ch for ch, cat in zip(every, cats) if cat[0] == "N"},
            {ch for ch in every if ch.isspace()
             and not "\x1c" <= ch <= "\x1f"})
    theirs = tuple(set(regex.findall(p, every))
                   for p in (r"\p{L}", r"\p{N}", r"\s"))
    bad = sorted(hex(ord(ch)) for o, t in zip(ours, theirs) for ch in o ^ t
                 if unicodedata.category(ch) != "Cn")
    assert bad == []


def test_asset_is_the_jax_asset():
    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert sha(ASSET) == sha(JASSET)

