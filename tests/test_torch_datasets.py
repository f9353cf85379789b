"""The port's datasets over files and grammar against the JAX package's,
on the CPU: ``PreparedDataset`` (its ``metadata.csv`` read with the
``csv`` module against ``pd.read_csv``), the LibriSpeech reader
(``iter_librispeech_split`` over an extracted tree of FLAC and WAV
files with malformed lines, ``LibriSpeechDataset``,
``download_and_extract`` on an extracted split) and ``GrammarDataset``
(``make_split``, ``render``, the items), item for item.  Tolerances:
metadata rows, walk results, sentences, rendered audio, labels and the
native DIO pitch exactly; the log-mel 2e-3 (rtol and atol) and the
frame-rate waveform rtol 1e-5 / atol 1e-6, as tests/test_torch_data.py
holds ``extract_features``."""

import importlib.util
import logging
import os
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from asr_model_tpu.data import dataset as jdataset
from asr_model_tpu.data import librispeech as jlibri
from asr_model_tpu.data.tokenizer import setup_tokenizer as jtokenizer

from asr_model_tpu_torch.data import dataset, librispeech
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")
JASSET = os.path.join(ROOT, "asr_model_tpu", "assets", "tokenizer.json")
ARGS = dict(spectrogram=True, pitch=True, waveform=True, mels=16,
            hop_length=160, sample_rate=16000, pitch_estimator="dio")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers oversubscribe the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks():
    return setup_tokenizer(ASSET), jtokenizer(JASSET)


def _same_item(got, want):
    assert got.keys() == want.keys()
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["spectrogram"], want["spectrogram"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["waveform"], want["waveform"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["pitch"], want["pitch"])


def _write_wav(path, audio):
    pcm = np.round(np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return pcm


def _flac_encoder():
    path = os.path.join(ROOT, "tools", "flac_encoder.py")
    spec = importlib.util.spec_from_file_location("flac_encoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grammar_dataset_matches_jax(toks):
    tok, jtok = toks
    for args in ((12, 4), (5, 3, (2, 3), 7)):
        assert (dataset.GrammarDataset.make_split(*args)
                == jdataset.GrammarDataset.make_split(*args))
    train, evals = dataset.GrammarDataset.make_split(6, 2)
    assert not set(train) & set(evals)
    assert dataset.GrammarDataset.LEXICON == jdataset.GrammarDataset.LEXICON
    ds = dataset.GrammarDataset(train, tokenizer=tok, extract_args=ARGS,
                                seed=3, device="cpu")
    jds = jdataset.GrammarDataset(train, tokenizer=jtok, extract_args=ARGS,
                                  seed=3)
    assert ds._freqs == jds._freqs and len(ds) == len(jds) == 6
    for text in train + evals:
        np.testing.assert_array_equal(ds.render(text, 5),
                                      jds.render(text, 5))
    for i in (0, 5):
        _same_item(ds[i], jds[i])


def test_prepared_dataset_matches_jax(toks, tmp_path):
    tok, jtok = toks
    g = dataset.GrammarDataset([])
    sentences = ["the quick fox", "hello, world", 'say "model"',
                 "lazy  dog\tover", "speech"]
    names = []
    for i, s in enumerate(sentences):
        name = f"u{i}.wav" if i != 3 else f"sub dir,{i}.wav"
        os.makedirs(tmp_path / os.path.dirname(name), exist_ok=True)
        _write_wav(tmp_path / name, g.render("the dog", seed=i))
        names.append(name)
    q = lambda v: '"' + v.replace('"', '""') + '"' if any(
        c in v for c in ',"\t') else v
    lines = ["id,audio,sentence,extra"] + [
        f"{i},{q(n)},{q(s)},x{i}" for i, (n, s) in enumerate(
            zip(names, sentences))]
    lines.insert(3, "")
    lines.insert(5, "   ")
    meta = tmp_path / "metadata.csv"
    meta.write_text("﻿" + "\r\n".join(lines) + "\r\n",
                    encoding="utf-8")
    ds = dataset.prepare_datasets(str(meta), str(tmp_path), tok,
                                  extract_args=ARGS, cache=True,
                                  device="cpu")
    jds = jdataset.prepare_datasets(str(meta), str(tmp_path), jtok,
                                    extract_args=ARGS)
    df = pd.read_csv(str(meta))
    assert len(ds) == len(jds) == len(df) == len(sentences)
    assert [(r["audio"], r["sentence"]) for r in ds.metadata] == [
        (df.iloc[i]["audio"], df.iloc[i]["sentence"])
        for i in range(len(df))]
    for i in (0, 3):
        item = ds[i]
        _same_item(item, jds[i])
        assert ds[i] is item                       # the cache
    bad = tmp_path / "bad.csv"
    bad.write_text("audio,sentence\nu0.wav,\n")
    with pytest.raises(ValueError, match="sentence"):
        dataset.PreparedDataset(str(bad), str(tmp_path))
    bad.write_text("audio,text\nu0.wav,hi\n")
    with pytest.raises(KeyError, match="sentence"):
        dataset.PreparedDataset(str(bad), str(tmp_path))


@pytest.fixture
def libri_tree(tmp_path):
    """An extracted ``LibriSpeech/dev-clean`` tree: FLAC and WAV
    utterances of GrammarDataset sentences in two chapters, a blank and
    a malformed transcript line, a malformed id and a missing file."""
    enc = _flac_encoder()
    g = dataset.GrammarDataset([])
    split = tmp_path / "LibriSpeech" / "dev-clean"
    sentences = dataset.GrammarDataset.make_split(4, 0, seed=2)[0]
    for spk, chap, ext, texts in ((84, 121123, "flac", sentences[:3]),
                                  (2, 7, "wav", sentences[3:])):
        d = split / str(spk) / str(chap)
        d.mkdir(parents=True)
        lines = []
        for k, text in enumerate(texts):
            uid = f"{spk}-{chap}-{k:04d}"
            audio = g.render(text, seed=k)
            if ext == "flac":
                pcm = np.round(audio * 32767).astype(np.int16)
                enc.write_flac(str(d / f"{uid}.flac"), pcm, 16000)
            else:
                _write_wav(d / f"{uid}.wav", audio)
            lines.append(f"{uid} {text.upper()}")
        lines += ["", "malformed-line", f"{spk}-{chap} NO UTTERANCE",
                  f"{spk}-{chap}-9999 NO AUDIO FILE"]
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return tmp_path, split


def test_librispeech_reader_matches_jax(toks, libri_tree, caplog):
    tok, jtok = toks
    cache_dir, split = libri_tree
    with caplog.at_level(logging.WARNING):
        got = list(librispeech.iter_librispeech_split(str(split)))
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("malformed transcript line" in m for m in msgs) == 2
    assert sum("malformed utterance id" in m for m in msgs) == 2
    assert sum("missing audio" in m for m in msgs) == 2
    want = list(jlibri.iter_librispeech_split(str(split)))
    assert got == want and len(got) == 4
    assert [e["speaker_id"] for e in got] == [2, 84, 84, 84]
    assert librispeech.LIBRISPEECH_URLS == jlibri.LIBRISPEECH_URLS
    # an extracted split: no fetch, the split directory back
    assert librispeech.download_and_extract(
        "dev-clean", str(cache_dir)) == str(split)
    ds = librispeech.load_dataset("dev-clean", str(cache_dir), tok,
                                  extract_args=ARGS, limit=3, device="cpu")
    jds = jlibri.LibriSpeechDataset(str(split), jtok, extract_args=ARGS,
                                    limit=3)
    assert len(ds) == len(jds) == 3
    for i in (0, 1):                                # a WAV, then a FLAC
        _same_item(ds[i], jds[i])
