"""The model variants against the JAX package on the CPU: a chained
model with the MoE MLP, the encoder's ``norm`` (``out_norm``,
``local_norm``) and its transformer layer (``enc``), at tiny dims (50
tokens, 8 mels, 16 dims, 2 heads, 2 layers, 4 experts top-2), weights
from a JAX init through ``weights.from_jax_params`` (for the decodes
the learned positions, ones at init, redrawn from N(0, 1), so they emit
varied tokens).

Held: the f32 forward logits (the init's positions) within rtol 1e-5
plus 1e-5 of the largest logit (measured 6e-7 of it: f32 sums in other
orders; each side sits ~3e-6 of the largest from a float64 forward with
the redrawn positions, ~4e-5 with positions 10 times larger), the greedy
buffer decode's tokens, the beam's ids (its length-normalised scores
within rtol 1e-5 plus 1e-5: f32 sums) and the ``Transcriber``'s ids and
text exactly; the checkpoints both ways (every tensor equal); ``Config``
round trips; every registry norm and activation within rtol 1e-5 / atol
1e-6 of the JAX module; the streaming refusal of a chained model; the
JAX package's pitch-token fault and the port's refusal naming it.
"""

import os

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
from asr_model_tpu.models import norms as jnorms
from asr_model_tpu.models import registry as jregistry
from asr_model_tpu.models.beam import beam_search as jbeam
from asr_model_tpu.models.conv import AudioEncoder as JEncoder
from asr_model_tpu.models.generate import greedy_decode as jgreedy
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.train import checkpoint as jckpt
from asr_model_tpu.train.loop import make_optimizer as jmake_optimizer
from asr_model_tpu.transcribe import Transcriber as JTranscriber

from asr_model_tpu_torch import cli
from asr_model_tpu_torch.config import Config, Dimensions, ModelConfig
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
from asr_model_tpu_torch.models import registry
from asr_model_tpu_torch.models.beam import beam_search
from asr_model_tpu_torch.models.conv import AudioEncoder
from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                 greedy_decode_stream)
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.train import checkpoint as ckpt
from asr_model_tpu_torch.train.loop import make_optimizer
from asr_model_tpu_torch.transcribe import Transcriber
from asr_model_tpu_torch.weights import from_jax_params, to_jax_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
JASSET = os.path.join(ROOT, "asr_model_tpu", "assets", "tokenizer.json")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")
KW = dict(tokens=50, mels=8, dims=16, head=2, layer=2)
VARIANT = dict(chained_blocks=True, moe_experts=4, moe_top_k=2,
               moe_capacity_factor=1.25, encoder_norm=True,
               encoder_transformer=True)
B, TA = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats():
    rs = np.random.RandomState(0)
    return dict(spectrogram=rs.randn(B, 8, TA).astype(np.float32),
                pitch=(rs.rand(B, 1, TA) * 2).astype(np.float32),
                waveform=(rs.randn(B, 1, TA) * 0.3).astype(np.float32))


def _t(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def _j(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


@pytest.fixture(scope="module")
def pair():
    jm = JModel(param=JDims(**KW), cfg=JModelConfig(dims=JDims(**KW),
                                                    **VARIANT))
    feats = _feats()
    v0 = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.ones((B, 4), jnp.int32), **_j(feats)))(
            jax.random.key(0)))
    v = jax.tree_util.tree_map(lambda a: a, v0)
    pos = v["params"]["processor"]["position"]
    v["params"]["processor"]["position"] = np.random.RandomState(
        2).randn(*pos.shape).astype(np.float32)
    m = Model(Dimensions(**KW), ModelConfig(**VARIANT), device="cpu")
    m.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                      strict=True)
    return jm, v, m, feats, v0


def test_variant_forward_logits(pair):
    jm, _, _, feats, v = pair
    m = Model(Dimensions(**KW), ModelConfig(**VARIANT), device="cpu")
    m.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                      strict=True)
    ids = np.random.RandomState(2).randint(3, 50, (B, 7))
    want = np.asarray(jax.jit(lambda v: jm.apply(
        v, jnp.asarray(ids), **_j(feats))["logits"])(v))
    got = m(torch.from_numpy(ids), **_t(feats))["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_variant_greedy_and_beam_match_jax(pair):
    """The MoE capacity of each step comes from the buffer's width (11),
    not the live prefix, as in the JAX decode."""
    jm, v, m, feats, _ = pair
    spec = {"spectrogram": feats["spectrogram"], "pitch": feats["pitch"]}
    want = np.asarray(jgreedy(jm, v, max_new_tokens=10, **_j(spec)))
    got = greedy_decode(m, max_new_tokens=10, **_t(spec)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 1:].ravel().tolist())) > 2
    jids, jscores = jbeam(jm, v, beam_size=3, max_new_tokens=6, **_j(spec))
    ids, scores = beam_search(m, beam_size=3, max_new_tokens=6, **_t(spec))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-5)


TKW = dict(use_pitch=False, use_waveform=False, bf16=False,
           max_new_tokens=6)


def _wave(seed=0):
    t = np.arange(8000) / 16000
    rng = np.random.RandomState(seed)
    return (0.5 * np.sin(2 * np.pi * 220.0 * t)
            + 0.01 * rng.randn(len(t))).astype(np.float32)


def test_variant_transcriber_and_checkpoints(pair, tmp_path):
    """The JAX checkpoint (and its config.json) read by the port's
    ``Transcriber.from_checkpoint``, its text equal to the JAX
    Transcriber's; the port's checkpoint read by the JAX package, every
    tensor equal."""
    jm, v, m, _, _ = pair
    cfg = JConfig(model=JModelConfig(dims=JDims(**KW), **VARIANT),
                  data=JData(pitch=False, waveform=False))
    tx, _ = jmake_optimizer(cfg, v["params"])
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(path, {"params": v["params"],
                                 "opt_state": tx.init(v["params"]),
                                 "batch_stats": v["batch_stats"],
                                 "step": 3})
    (tmp_path / "config.json").write_text(cfg.to_json())
    pt = Transcriber.from_checkpoint(path, ASSET, device="cpu", **TKW)
    assert pt.model.cfg.chained_blocks and pt.model.cfg.moe_experts == 4
    for (n, a), b in zip(pt.model.state_dict().items(),
                         m.state_dict().values()):
        assert torch.equal(a, b), n
    jt = JTranscriber(jm, v, jtokenizer(JASSET), **TKW)
    wav = _wave()
    assert pt.transcribe_batch([wav]) == jt.transcribe_batch([wav])
    assert pt(wav) == jt(wav)

    opt, _ = make_optimizer(Config(dims=Dimensions(**KW),
                                   model=ModelConfig(**VARIANT)), m)
    out = ckpt.save_checkpoint(str(tmp_path / "port.msgpack"),
                               ckpt.training_state(m, opt, 5))
    params, stats = to_jax_params(m)
    got = jckpt.restore_checkpoint(out, {
        "params": params, "opt_state": tx.init(params),
        "batch_stats": stats, "step": 0})
    assert int(got["step"]) == 5
    for tree, want in ((got["params"], v["params"]),
                       (got["batch_stats"], v["batch_stats"])):
        la = jax.tree_util.tree_leaves_with_path(tree)
        lb = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(la) == len(lb)
        for k, a in la:
            np.testing.assert_array_equal(np.asarray(a),
                                          np.asarray(lb[k]), err_msg=str(k))


def test_cli_trains_a_chained_moe_model(tmp_path):
    """``--chained-blocks --moe-experts 4 --moe-top-k 1`` through the
    port's CLI on synthetic utterances; the JAX package reads the
    config.json it writes, and its checkpoint restores in the port's
    ``Transcriber``."""
    out = cli.main(["--device", "cpu", "--synthetic", "4", "--max-steps",
                    "2", "--batch-size", "2", "--dims", "16", "--head", "2",
                    "--layer", "2", "--mels", "8", "--chained-blocks",
                    "--moe-experts", "4", "--moe-top-k", "1", "--no-pitch",
                    "--no-waveform", "--prefetch", "0", "--save-interval",
                    "1", "--eval-interval", "2",
                    "--log-dir", str(tmp_path)])
    assert out["step"] == 2 and np.isfinite(out["loss"])
    m = out["model"]
    assert m.processor.names == ["block0", "block1"]
    assert m.processor.block0.moe.top_k == 1
    jcfg = JConfig.from_json((tmp_path / "config.json").read_text())
    assert jcfg.model.chained_blocks and jcfg.model.moe_experts == 4
    assert jcfg.model.moe_top_k == 1
    t = Transcriber.from_checkpoint(str(tmp_path / "final_model.msgpack"),
                                    ASSET, device="cpu", **TKW)
    for (n, a), b in zip(t.model.state_dict().items(),
                         m.state_dict().values()):
        assert torch.equal(a, b), n


def test_config_round_trips_the_variant_fields():
    jcfg = JConfig(model=JModelConfig(
        dims=JDims(**KW), moe_aux_weight=0.5, pitch_token_bins=64,
        pitch_token_vocab=99, msheath_mini_hc=True,
        **dict(VARIANT, moe_top_k=1, moe_capacity_factor=2.0)))
    got = Config.from_json(jcfg.to_json())
    for f in ("chained_blocks", "moe_experts", "moe_top_k",
              "moe_capacity_factor", "moe_aux_weight", "pitch_token_bins",
              "pitch_token_vocab", "encoder_norm", "encoder_transformer",
              "msheath_mini_hc"):
        assert getattr(got.model, f) == getattr(jcfg.model, f), f
    back = JConfig.from_json(got.to_json())
    assert back.model == jcfg.model
    assert Config.from_json(got.to_json()) == got


def test_chained_streaming_model_takes_the_buffer_decode(pair,
                                                        monkeypatch):
    """The JAX package has no stream decode for a chained model; its
    ``Transcriber`` serves one with the buffer decode, and so does the
    port's."""
    _, v, _, feats, _ = pair
    m = Model(Dimensions(**KW), ModelConfig(streaming=True, **VARIANT),
              device="cpu")
    m.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                      strict=True)
    spec = _t({"spectrogram": feats["spectrogram"]})
    with pytest.raises(NotImplementedError, match="chained=False"):
        greedy_decode_stream(m, max_new_tokens=3, **spec)
    from asr_model_tpu_torch import transcribe
    calls = []
    monkeypatch.setattr(transcribe, "greedy_decode", lambda *a, **k: (
        calls.append(1), greedy_decode(*a, **k))[1])
    t = Transcriber(m, setup_tokenizer(ASSET), device="cpu", **TKW)
    assert isinstance(t(_wave(1)), str) and calls == [1]


# --------------------------------------------- the registry

NORMS = ("layernorm", "linearnorm", "adanorm", "instancenorm", "rmsnorm",
         "batchnorm", "instancenorm2d", "groupnorm", "localnorm",
         "globalnorm", "AbbyNormal", "unknown")
ACTS = ("gelu", "relu", "sigmoid", "tanh", "swish", "tanhshrink",
        "softplus", "softshrink", "leaky_relu", "elu", "unknown")


def _jnorm(name, x):
    kw = {"num_groups": 4} if name == "groupnorm" else {}
    mod = jregistry.get_norm(name, 16, **kw)
    call = {}
    if name == "batchnorm":
        call = {"use_running_average": False}
    v = mod.init(jax.random.key(3), x, **call)
    if name == "globalnorm":       # zero-initialised affine: redraw it
        rs = np.random.RandomState(4)
        v = {"params": {k: rs.randn(*a.shape).astype(np.float32)
                        for k, a in v["params"].items()}}
    if name == "batchnorm":
        y, _ = mod.apply(v, x, mutable=["batch_stats"], **call)
    else:
        y = mod.apply(v, x)
    return jax.device_get(v), np.asarray(y)


@pytest.mark.parametrize("kind,name", [("norm", n) for n in NORMS]
                         + [("act", a) for a in ACTS])
def test_registry_entry_matches_jax(kind, name):
    rs = np.random.RandomState(len(name))
    shape = (2, 3, 5, 16) if name == "globalnorm" else (2, 5, 16)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    if kind == "act":
        want = np.asarray(jregistry.get_activation(name)(jnp.asarray(x)))
        got = registry.get_activation(name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    if name == "unknown":
        with pytest.warns(UserWarning, match="not found"):
            v, want = _jnorm(name, jnp.asarray(x))
        with pytest.warns(UserWarning, match="not found"):
            tm = registry.get_norm(name, 16, device="cpu")
    else:
        v, want = _jnorm(name, jnp.asarray(x))
        tm = registry.get_norm(name, 16, num_groups=4, device="cpu")
    tm.load_state_dict(from_jax_params(v.get("params", {}),
                                       v.get("batch_stats")), strict=True)
    from asr_model_tpu_torch.models import stochastic
    with stochastic.mode(train=name == "batchnorm"):
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_registry_errors_and_conditioned_adaln():
    for name in ("batchnorm", "instancenorm"):
        with pytest.raises(ValueError, match="requires 'dims'"):
            registry.get_norm(name)
        with pytest.raises(ValueError, match="requires 'dims'"):
            jregistry.get_norm(name)
    with pytest.raises(ValueError, match="requires 'num_groups'"):
        registry.get_norm("groupnorm", 16)
    from asr_model_tpu_torch.models.norms import AdaLN
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 16).astype(np.float32)
    c = rs.randn(2, 16).astype(np.float32)
    jm = jnorms.AdaLN(dims=16)
    v = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(c)))
    v["params"]["Dense_1"] = {k: rs.randn(*a.shape).astype(np.float32)
                              for k, a in v["params"]["Dense_1"].items()}
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(c)))
    tm = AdaLN(16, conditioned=True, device="cpu")
    tm.load_state_dict(from_jax_params(v["params"]), strict=True)
    got = tm(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_encoder_options_match_jax():
    """``out_norm`` after the multi-channel stem and the stack,
    ``local_norm`` after the mono stem, the transformer layer last: one
    spectrogram and one mono track, each alone (eval)."""
    je = JEncoder(mels=8, dims=16, head=2, layer=2, act="gelu",
                  n_type="AbbyNormal", norm=True, enc=True)
    f = _feats()
    v = jax.device_get(je.init(jax.random.key(5), {
        "a": jnp.asarray(f["pitch"]), "b": jnp.asarray(f["spectrogram"])}))
    te = AudioEncoder(8, 16, 2, 2, "gelu", n_type="AbbyNormal", norm=True,
                      enc=True, device="cpu")
    te.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                       strict=True)
    for k in ("spectrogram", "pitch"):
        want = np.asarray(je.apply(v, jnp.asarray(f[k])))
        got = te({"a": torch.from_numpy(f[k])})["a"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# --------------------------------------------- pitch tokens

def test_reference_pitch_token_fault_and_the_refusal():
    """The JAX Model with pitch tokens raises where the text length (6)
    differs from the frame count (12): its encoder slots' rotary takes
    the pitch-token condition's length.  The port refuses the option,
    naming that fault."""
    kw = dict(tokens=50, mels=8, dims=16, head=2, layer=2)
    jm = JModel(param=JDims(**kw), cfg=JModelConfig(dims=JDims(**kw)))
    rs = np.random.RandomState(0)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.ones((2, 6), jnp.int32),
            spectrogram=jnp.asarray(rs.randn(2, 8, 12), jnp.float32),
            pitch_tokens=jnp.zeros((2, 6), jnp.float32)))
    bad = JConfig(data=JData(pitch_tokens=True)).to_json()
    with pytest.raises(ValueError, match="item 9.*text length differs"):
        Config.from_json(bad)
    with pytest.raises(SystemExit, match="item 9.*text length differs"):
        cli.main(["--device", "cpu", "--pitch-tokens"])
