"""The port's serving surface against the JAX package: ``Transcriber``
(greedy, beam, a streaming model's routing, ragged batches, long-form,
``encode_only``, ``from_checkpoint``), ``greedy_decode_prompted``, the
beam search and the config reader.

The tiny model of tests/test_transcribe.py (40k vocab so the tokenizer's
ids fit, 8 mels, dims 16, 2 heads, 2 layers), its JAX weights through
``from_jax_params``, f32 (``bf16=False``), pitch on (DIO; YIN in the
long-form and prompted tests; the waveform in the single-utterance
tests), the port on the CPU.  Ids and text must
equal the JAX ``Transcriber``'s (the two DIO frontends agree to ~1e-4 Hz
here, tests/test_torch_dio.py, far from any near tie of these inputs);
beam scores and ``encode_only``: 1e-5.  Each JAX program (a frontend, a
decode) costs seconds to trace at this size, so the tests share them
where they can.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.config import Config as JConfig
from asr_model_tpu.config import DataConfig as JData
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JModelConfig
from asr_model_tpu.data.tokenizer import setup_tokenizer as jtokenizer
from asr_model_tpu.models.beam import beam_search as jbeam
from asr_model_tpu.models.generate import \
    greedy_decode_prompted as jprompted
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.train.checkpoint import save_checkpoint
from asr_model_tpu.train.loop import make_optimizer
from asr_model_tpu.transcribe import Transcriber as JTranscriber

from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
from asr_model_tpu_torch.models.beam import beam_search
from asr_model_tpu_torch.models.generate import (generate_predictions,
                                                 greedy_decode,
                                                 greedy_decode_prompted)
from asr_model_tpu_torch.models.longform import chunk_audio
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.transcribe import Transcriber
from asr_model_tpu_torch.weights import from_jax_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
JASSET = os.path.join(ROOT, "asr_model_tpu", "assets", "tokenizer.json")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")
KW = dict(tokens=40000, mels=8, dims=16, head=2, layer=2)
SR = 16000


def _tone(dur, f0=220.0, seed=0):
    t = np.arange(int(SR * dur)) / SR
    rng = np.random.RandomState(seed)
    return (0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(
        2 * np.pi * 2 * f0 * t) + 0.01 * rng.randn(len(t))).astype(
        np.float32)


def _jax_model(streaming=False):
    model = JModel(param=JDims(**KW),
                   cfg=JModelConfig(dims=JDims(**KW), streaming=streaming))
    mel = jnp.zeros((1, 8, 16), jnp.float32)
    mono = jnp.zeros((1, 1, 16), jnp.float32)
    # pitch and waveform share the mono stem: an init with pitch alone
    # makes the same tree, and traces faster
    variables = jax.jit(lambda r: model.init(
        {"params": r}, jnp.ones((1, 2), jnp.int32), spectrogram=mel,
        pitch=mono))(jax.random.key(0))
    return model, jax.device_get(variables)


def _port_model(variables, streaming=False):
    m = Model(Dimensions(**KW), ModelConfig(streaming=streaming),
              device="cpu")
    m.load_state_dict(from_jax_params(variables["params"],
                                      variables.get("batch_stats")),
                      strict=True)
    return m


TKW = dict(use_pitch=True, use_waveform=True, bf16=False, max_new_tokens=4,
           pitch_estimator="dio")


@pytest.fixture(scope="module")
def pair():
    jm, v = _jax_model()
    jt = JTranscriber(jm, v, jtokenizer(JASSET), **TKW)
    pt = Transcriber(_port_model(v), setup_tokenizer(ASSET), device="cpu",
                     **TKW)
    return jt, pt, v


def _variant(pair, **kw):
    """The pair's model and weights with other feature settings."""
    jt, pt, _ = pair
    kw = dict(TKW, **kw)
    return (JTranscriber(jt.model, jt.variables, jt.tokenizer, **kw),
            Transcriber(pt.model, pt.tokenizer, device="cpu", **kw))


@pytest.fixture(scope="module")
def batch_pair(pair):
    """DIO pitch, no waveform (the batched waveform against JAX's vmap:
    tests/test_torch_ops.py)."""
    return _variant(pair, use_waveform=False)


@pytest.fixture(scope="module")
def yin_pair(pair):
    return _variant(pair, pitch_estimator="yin", use_waveform=False)


def test_call_greedy_matches_jax(pair):
    jt, pt, _ = pair
    wav = _tone(0.5)
    kernels.reset_counts()
    got = pt(wav)
    c = kernels.counts()
    assert c["dio_contour"] == {"launches": 0, "plain_calls": 1}
    assert got == jt(wav)


def test_beam_matches_jax(pair):
    jt, pt, _ = pair
    wav = _tone(0.5, 180.0, seed=1)
    assert pt(wav, beam_size=3) == jt(wav, beam_size=3)


def test_beam_search_ids_and_scores_match_jax(pair):
    """The search itself on the Transcriber's features (the JAX program
    of the test above): ids equal, length-normalised scores within 1e-5
    (f32 log-softmax sums); K 1 equals the greedy decode."""
    jt, pt, _ = pair
    wav = _tone(0.5, 180.0, seed=1)
    jf = jt._frontend(jnp.asarray(wav))
    wi, ws = jbeam(jt.model, jt.variables, spectrogram=jf["spectrogram"],
                   pitch=jf["pitch"], waveform=jf["waveform"], beam_size=3,
                   max_new_tokens=4, length_penalty=1.0)
    feats = pt.features(torch.from_numpy(wav)[None])
    gi, gs = beam_search(pt.model, **feats, beam_size=3, max_new_tokens=4,
                         length_penalty=1.0)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5)
    g1, _ = beam_search(pt.model, **feats, beam_size=1, max_new_tokens=4,
                        length_penalty=0.0)
    np.testing.assert_array_equal(
        g1.numpy(), greedy_decode(pt.model, **feats, max_new_tokens=4).numpy())


def test_transcribe_batch_ragged_matches_jax(batch_pair):
    jt, pt = batch_pair
    wavs = [_tone(0.5), _tone(0.3, 150.0, 1), _tone(0.4, 300.0, 2)]
    got = pt.transcribe_batch(wavs)
    want = jt.transcribe_batch(wavs)
    assert len(got) == 3
    assert got == want


def test_transcribe_long_matches_jax(yin_pair):
    jt, pt = yin_pair
    wav = _tone(2.6, 170.0, seed=4)
    kw = dict(chunk_sec=1.0, overlap_sec=0.25, carry_tokens=4,
              max_new_tokens_per_chunk=4)
    # prompts of 0 and 4 tokens: the chunk decodes compile the JAX
    # programs the prompted test below runs
    assert len(chunk_audio(wav, SR, 1.0, 0.25)) == 4
    assert pt.transcribe_long(wav, **kw) == jt.transcribe_long(wav, **kw)


@pytest.mark.parametrize("prompt", [[], [7, 8, 9, 10]])
def test_prompted_decode_matches_jax(yin_pair, prompt):
    """At a long-form chunk's features (1 s, the programs the test above
    compiled); an empty prompt gives greedy_decode's tokens."""
    from asr_model_tpu.models.longform import _jit_frontend
    jt, pt = yin_pair
    wav = _tone(1.0, 170.0, seed=4)
    mel, f0, _ = _jit_frontend(SR, 160, 8, "float32", "yin")(
        jnp.asarray(wav))
    p = np.asarray([prompt], np.int32).reshape(1, len(prompt))
    want = np.asarray(jprompted(jt.model, jt.variables, jnp.asarray(p),
                                spectrogram=mel, pitch=f0, waveform=None,
                                max_new_tokens=4))
    feats = pt.features(torch.from_numpy(wav)[None])
    assert feats["waveform"] is None
    got = greedy_decode_prompted(pt.model, torch.from_numpy(p), **feats,
                                 max_new_tokens=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 1:1 + len(prompt)].tolist() == prompt
    if not prompt:
        np.testing.assert_array_equal(
            got, greedy_decode(pt.model, **feats, max_new_tokens=4).numpy())
        np.testing.assert_array_equal(
            generate_predictions(pt.model, **feats, max_new_tokens=4),
            greedy_decode(pt.model, **feats, max_new_tokens=4,
                          suppress_eos=True))


def test_encode_only_matches_jax(pair):
    jt, pt, _ = pair
    wav = _tone(0.5)
    want = jt.encode_only(wav)
    got = pt.encode_only(wav)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_streaming_model_routes_to_stream_decode(pair, batch_pair,
                                                monkeypatch):
    """The same weights as a streaming model (its parameters are the
    same) on the ragged batch: the port takes greedy_decode_stream and
    gives the JAX Transcriber's text."""
    jt0, pt0 = batch_pair
    v = pair[2]
    kw = dict(TKW, use_waveform=False)
    jm = JModel(param=JDims(**KW),
                cfg=JModelConfig(dims=JDims(**KW), streaming=True))
    jt = JTranscriber(jm, v, jt0.tokenizer, **kw)
    # the batch frontend depends on the feature settings only, which the
    # two Transcribers share: reuse the program the ragged-batch test
    # compiled
    jt._batch_frontend = jt0._batch_frontend
    pt = Transcriber(_port_model(v, streaming=True), pt0.tokenizer,
                     device="cpu", **kw)
    import asr_model_tpu_torch.transcribe as T
    called = {}
    orig = T.greedy_decode_stream

    def spy(*a, **k):
        called["stream"] = called.get("stream", 0) + 1
        return orig(*a, **k)

    monkeypatch.setattr(T, "greedy_decode_stream", spy)
    monkeypatch.setattr(T, "greedy_decode", None)   # must not be reached
    wavs = [_tone(0.5), _tone(0.3, 150.0, 1), _tone(0.4, 300.0, 2)]
    assert pt.transcribe_batch(wavs) == jt.transcribe_batch(wavs)
    assert called["stream"] == 1


def test_dio_host_matches_jax(pair):
    """"dio_host" serves the training features' pitch (the native host
    DIO + StoneMask, the port's own copy of world.cpp): the text equal to
    the JAX Transcriber's with the same estimator, single and batched,
    and the device DIO's contour kernel not run."""
    jt, pt = _variant(pair, pitch_estimator="dio_host", use_waveform=False)
    wav = _tone(0.5)
    kernels.reset_counts()
    assert pt(wav) == jt(wav)
    wavs = [_tone(0.5), _tone(0.4, f0=180.0, seed=1)]
    assert pt.transcribe_batch(wavs) == jt.transcribe_batch(wavs)
    assert kernels.counts()["dio_contour"] == {"launches": 0,
                                               "plain_calls": 0}


def test_config_from_json_reads_the_jax_config():
    cfg = JConfig(model=JModelConfig(dims=JDims(**KW), streaming=True),
                  data=JData(pitch=False, pitch_estimator="yin"))
    got = Config.from_json(cfg.to_json())
    assert got.dims == Dimensions(**KW)
    assert got.model.streaming and got.model.causal_all is False
    assert got.data.pitch is False and got.data.pitch_estimator == "yin"
    # the model variants are read since they were ported, and the WORLD
    # feature flags (read, written back, inert as in the JAX package);
    # the pitch-token model path is refused
    for ok in (JConfig(model=JModelConfig(moe_experts=2)),
               JConfig(model=JModelConfig(chained_blocks=True)),
               JConfig(model=JModelConfig(encoder_norm=True)),
               JConfig(model=JModelConfig(encoder_transformer=True)),
               JConfig(model=JModelConfig(msheath_mini_hc=True))):
        got = Config.from_json(ok.to_json())
        assert JConfig.from_json(got.to_json()).model == ok.model
    world = JConfig(data=JData(harmonics=True, aperiodics=True, phase=True))
    got = Config.from_json(world.to_json())
    assert got.data.harmonics and got.data.aperiodics and got.data.phase
    back = JConfig.from_json(got.to_json()).data
    assert (back.harmonics, back.aperiodics, back.phase) == (True,) * 3
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 9"):
        Config.from_json(JConfig(data=JData(pitch_tokens=True)).to_json())


def test_transcriber_needs_cuda_unless_cpu_is_asked(pair):
    _, pt, _ = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber(pt.model, pt.tokenizer, bf16=False)
    # "dio_host" (the native host DIO) is served since the training
    # slice; an unknown estimator is refused
    Transcriber(pt.model, pt.tokenizer, device="cpu", bf16=False,
                pitch_estimator="dio_host")
    with pytest.raises(ValueError, match="unknown pitch estimator"):
        Transcriber(pt.model, pt.tokenizer, device="cpu", bf16=False,
                    pitch_estimator="crepe")


@pytest.mark.parametrize("modalities", [False, True])
def test_from_checkpoint_matches_jax(pair, tmp_path, modalities):
    """A JAX checkpoint (``save_checkpoint``: params, MaxFactor state,
    batch_stats, step) and ``Config.to_json()`` beside it, restored by
    the port: every tensor equal to ``from_jax_params`` of the saved
    trees, the data flags read from the config, the text equal to the
    JAX Transcriber's on the same weights.  A model trained without
    pitch and waveform has no mono stem (``enc.conv2``) in its tree; the
    port keeps its own there, and refuses the file when pitch or
    waveform is asked for.  A subprocess checks the port reads the
    checkpoint with neither msgpack nor flax imported."""
    jt, _, v = pair
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    if not modalities:
        params["enc"] = {k: w for k, w in params["enc"].items()
                         if k != "conv2"}
    cfg = JConfig(model=JModelConfig(dims=JDims(**KW)),
                  data=JData(pitch=modalities, waveform=modalities))
    tx, _ = make_optimizer(cfg, params)
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, {"params": params, "opt_state": tx.init(params),
                           "batch_stats": v.get("batch_stats", {}),
                           "step": 7})
    (tmp_path / "config.json").write_text(cfg.to_json())
    pt = Transcriber.from_checkpoint(path, ASSET, device="cpu", bf16=False,
                                     max_new_tokens=4)
    assert pt.use_pitch is modalities and pt.use_waveform is modalities
    assert pt.pitch_estimator == "dio"
    want = from_jax_params(params, v.get("batch_stats"))
    got = pt.model.state_dict()
    assert set(got) - set(want) == (set() if modalities else
                                    {"enc.conv2.weight", "enc.conv2.bias"})
    for k, w in want.items():       # a (1,) leaf loads into a 0-d one
        assert torch.equal(got[k], w.reshape(got[k].shape)), k
    if not modalities:
        for flag in ("use_pitch", "use_waveform"):
            with pytest.raises(KeyError, match="enc.conv2"):
                Transcriber.from_checkpoint(path, ASSET, device="cpu",
                                            bf16=False, **{flag: True})
        return
    wav = _tone(0.5)
    assert pt(wav) == jt(wav)
    script = (
        "import sys, torch\n"
        "from asr_model_tpu_torch.transcribe import Transcriber\n"
        f"t = Transcriber.from_checkpoint({path!r}, {ASSET!r}, "
        "device='cpu', bf16=False)\n"
        "print(sorted(m for m in ('msgpack', 'flax', 'jax', 'regex', "
        "'tokenizers') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.stdout.strip() == "[]"
