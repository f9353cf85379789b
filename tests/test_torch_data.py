"""The port's training data pipeline against the JAX package's, on the
CPU: ``extract_features`` (log-mel spectrogram, frame-rate waveform,
pitch through YIN and through the native host DIO + StoneMask), the
synthetic dataset's audio and split, ``collate``, the loaders, the
Prefetcher, and the WER metrics.  Tolerances: the log-mel 2e-3 (rtol and
atol, the mel's own tolerance in tests/test_torch_ops.py), YIN's voicing
exactly and F0 rtol 1e-4 / atol 1e-3 (tests/test_torch_ops.py), the
native DIO exactly (the same C++ source), the waveform rtol 1e-5;
labels, collated ids and masks, splits and WER exactly."""

import os

import numpy as np
import pytest
import torch

from asr_model_tpu.data import collator as jcollator
from asr_model_tpu.data import dataset as jdataset
from asr_model_tpu.data.features import extract_features as jextract
from asr_model_tpu.data.tokenizer import setup_tokenizer as jtokenizer
from asr_model_tpu.train import metrics as jmetrics

from asr_model_tpu_torch.data import collator, dataset
from asr_model_tpu_torch.data.features import extract_features
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
from asr_model_tpu_torch.ops.cuda import mel as kmel
from asr_model_tpu_torch.train import metrics

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")
JASSET = os.path.join(ROOT, "asr_model_tpu", "assets", "tokenizer.json")
ARGS = dict(spectrogram=True, pitch=True, waveform=True, mels=32,
            hop_length=160, sample_rate=16000)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs files
    in parallel worker processes, and PyTorch's thread pools in each of
    them oversubscribe the cores (a test here ran 47x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks():
    return setup_tokenizer(ASSET), jtokenizer(JASSET)


@pytest.fixture(scope="module")
def synth(toks):
    """Two utterances of different lengths from each package's
    synthetic dataset (same seeds)."""
    tok, jtok = toks
    ex = dict(spectrogram=True, mels=32)
    return (dataset.SyntheticDataset(n=3, tokenizer=tok, device="cpu",
                                     dur_range=(0.4, 0.8), extract_args=ex),
            jdataset.SyntheticDataset(n=3, tokenizer=jtok,
                                      dur_range=(0.4, 0.8), extract_args=ex))


@pytest.mark.parametrize("estimator", ["dio", "dio_host", "yin"])
def test_extract_features_matches_jax(toks, synth, estimator):
    tok, jtok = toks
    ds, jds = synth
    for i in range(2):
        assert ds.specs[i] == jds.specs[i]
        audio = ds.audio(i)
        np.testing.assert_array_equal(audio, jds._audio(*(
            jds.specs[i][:2] + jds.specs[i][3:])))
        item = {"audio": {"array": audio, "sampling_rate": 16000},
                "transcription": ds.specs[i][2]}
        kmel.mel_spectrogram_plain.calls = 0
        got = extract_features(item, tokenizer=tok, device="cpu",
                               pitch_estimator=estimator, **ARGS)
        assert kmel.mel_spectrogram_plain.calls == 1  # one utterance a call
        want = jextract(item, tokenizer=jtok,
                        pitch_estimator="dio" if estimator == "dio_host"
                        else estimator, **ARGS)
        assert got["labels"] == want["labels"]
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["spectrogram"], want["spectrogram"],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got["waveform"], want["waveform"],
                                   rtol=1e-5, atol=1e-6)
        gp, wp = got["pitch"], want["pitch"]
        assert gp.shape == wp.shape and gp.dtype == wp.dtype == np.float32
        if estimator == "yin":
            np.testing.assert_array_equal(gp > 0, wp > 0)
            np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(gp, wp)


def test_unported_features_raise(toks):
    """The four features this test once saw refused (pitch tokens, WORLD
    harmonics and aperiodics, phase) are ported: each flag alone gives
    the JAX package's feature under its key, exactly (the same native
    WORLD source; tests/test_torch_features.py holds them in detail)."""
    tok, jtok = toks
    t = np.arange(3200) / 16000
    wav = (0.5 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    item = {"audio": {"array": wav, "sampling_rate": 16000},
            "transcription": "a tone"}
    for flag, key in (("pitch_tokens", "pitch_tokens"),
                      ("harmonics", "harmonic"), ("aperiodics", "aperiodic"),
                      ("phase", "phase")):
        got = extract_features(item, tokenizer=tok, device="cpu",
                               **{flag: True})
        want = jextract(item, tokenizer=jtok, **{flag: True})
        assert set(got) == set(want) == {"labels", key}
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("pad,tpad,masks", [(None, None, False),
                                            (16, 8, True), (32, None, True)])
def test_collate_matches_jax(pad, tpad, masks):
    rs = np.random.RandomState(0)
    feats = [{"labels": list(rs.randint(3, 99, n)),
              "spectrogram": rs.randn(8, t).astype(np.float32),
              "pitch": rs.rand(1, t).astype(np.float32)}
             for n, t in ((3, 20), (6, 17), (1, 25))]
    got = collator.collate(feats, pad_to_multiple=pad,
                           text_pad_to_multiple=tpad, with_masks=masks)
    want = jcollator.collate(feats, pad_to_multiple=pad,
                             text_pad_to_multiple=tpad, with_masks=masks)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dc = collator.DataCollator(pad_to_multiple=pad,
                               text_pad_to_multiple=tpad, with_masks=masks)
    for k, v in dc(feats).items():
        np.testing.assert_array_equal(v, want[k])


def test_loaders_split_and_prefetcher_match_jax(synth):
    ds, jds = synth
    a, b = dataset.random_split(ds, 0.67, seed=3)
    ja, jb = jdataset.random_split(jds, 0.67, seed=3)
    assert a.idx == ja.idx and b.idx == jb.idx
    kw = dict(batch_size=2, pad_to_multiple=16, text_pad_to_multiple=8)
    got = list(dataset.Prefetcher(dataset.Repeated(ds, **kw), depth=1))
    want = list(jdataset.Repeated(jds, **kw))
    assert len(got) == len(want) == 2 == len(dataset.Repeated(ds, **kw))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("text_ids", "labels"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["spectrogram"], w["spectrogram"],
                                   rtol=2e-3, atol=2e-3)
    shuffled = [b_["labels"] for b_ in dataset.data_loader(
        ds, batch_size=1, shuffle=True, seed=4)]
    jshuffled = [b_["labels"] for b_ in jdataset.data_loader(
        jds, batch_size=1, shuffle=True, seed=4)]
    for g, w in zip(shuffled, jshuffled):
        np.testing.assert_array_equal(g, w)

    def boom():
        yield 1
        raise RuntimeError("worker failed")

    with pytest.raises(RuntimeError, match="worker failed"):
        list(dataset.Prefetcher(boom(), depth=2))


def test_prefetcher_close_joins_its_worker():
    """A pass closed early stops its worker: once ``close`` returns, the
    worker has ended and begins no further item (the training loop
    closes its pass before a caller reads the kernel counts)."""
    import threading
    import time
    made = []

    def slow():
        for i in range(1000):
            time.sleep(0.01)
            made.append(i)
            yield i

    before = threading.active_count()
    it = iter(dataset.Prefetcher(slow(), depth=2))
    assert [next(it), next(it)] == [0, 1]
    it.close()
    assert threading.active_count() == before
    n = len(made)
    time.sleep(0.1)
    assert len(made) == n <= 5, made


def test_wer_and_metrics_match_jax(toks):
    tok, jtok = toks
    refs = ["the quick brown fox", "hello world", "", "a b c d e"]
    hyps = ["the quick fox jumps", "hello", "noise", "a x c d"]
    assert metrics.wer_batch(refs, hyps) == jmetrics.wer_batch(refs, hyps)
    for r, h in zip(refs, hyps):
        assert metrics.levenshtein(r.split(), h.split()) == \
            jmetrics.levenshtein(r.split(), h.split())
    rs = np.random.RandomState(1)
    labels = [[1] + list(tok.encode(s)) + [2, 0, 0] for s in refs[:2]]
    preds = [list(rs.randint(0, 500, len(l))) for l in labels]
    pred = {"predictions": preds, "label_ids": labels}
    assert metrics.compute_metrics(pred, tokenizer=tok, num_params_m=2.0) \
        == jmetrics.compute_metrics(pred, tokenizer=jtok, num_params_m=2.0)
    assert metrics.clean_batch(labels) == jmetrics.clean_batch(labels)
    g = rs.randn(3000).astype(np.float32)
    assert metrics.spectral_entropy(g) == pytest.approx(
        jmetrics.spectral_entropy(g), rel=1e-6)


@pytest.mark.parametrize("n", [4800, 21347, 160000, 1234567, 2 ** 24 + 5])
def test_frame_rate_waveform_bins_are_torch_adaptive_pool(n):
    """The frame-rate waveform's pooling bins in integer arithmetic,
    equal to ``F.adaptive_avg_pool1d`` at any length: the float bounds
    before this repair picked wrong bins at 1,234,567 samples and indexed
    past the array at 2**24 + 5 (and, on the card, where a division by a
    scalar multiplies by its reciprocal, already at 4,800: the device
    assert the training CLI hit)."""
    from asr_model_tpu_torch.ops.audio import (adaptive_avg_pool1d,
                                               frame_rate_waveform)
    target = max(int((n / 16000) * (16000 // 160)), 1)
    x = torch.from_numpy(np.random.RandomState(n % 1000).randn(1, 1, n))
    got = adaptive_avg_pool1d(x, target)
    want = torch.nn.functional.adaptive_avg_pool1d(x, target)
    assert float((got - want).abs().max()) < 1e-12
    wave = frame_rate_waveform(x[0, 0].float())
    assert wave.shape == (1, target) and torch.isfinite(wave).all()
