"""The streaming-causal variant of the port against the JAX package:
MSheath's streaming branch and its one-position state, the attention
step pieces, the buffer forward with ``causal_all`` and ``streaming``,
``decode_stream_step``'s logits, and ``greedy_decode_stream``'s tokens
(against JAX's and against the port's own buffer decode).

Tiny dims as tests/test_stream_decode.py (128 tokens, 8 mels, dims 32,
2 heads, 2 layers); the MSheath pieces at 4 slots; the fused-field
cases at dims 128 with one head (so the fused gates admit the calls).
Weights JAX -> port through ``from_jax_params``; inputs from a numpy
seed; the port on the CPU (the plain versions of its kernels).  f32:
max |got - want| / max |want| <= 1e-5, jump actions and counters
exactly, tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import asr_model_tpu.models.attention as jam
import asr_model_tpu.models.decoder as jdm
import asr_model_tpu.models.gates as jgm
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JConfig
from asr_model_tpu.models.attention import Attention as JAttention
from asr_model_tpu.models.generate import greedy_decode as jgreedy
from asr_model_tpu.models.generate import greedy_decode_stream as jstream
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.models.model import modality_slots as jslots
from asr_model_tpu.models.sheath import MSheath as JMSheath
from asr_model_tpu.ops.audio import sinusoids as jsinusoids

from asr_model_tpu_torch.config import EOS_ID, Dimensions, ModelConfig
from asr_model_tpu_torch.models.attention import Attention
from asr_model_tpu_torch.models.generate import (greedy_decode,
                                                 greedy_decode_stream,
                                                 prepare_cross)
from asr_model_tpu_torch.models.model import Model, cast_variables
from asr_model_tpu_torch.models.model import modality_slots
from asr_model_tpu_torch.models.sheath import MSheath
from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.ops.audio import sinusoids
from asr_model_tpu_torch.weights import from_jax_params

TOL = 1e-5
KW = dict(tokens=128, mels=8, dims=32, head=2, layer=2)
FKW = dict(tokens=128, mels=8, dims=128, head=1, layer=2)
BATCH, T_AUDIO, NEW = 2, 24, 6


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _np(t):
    return t.detach().numpy()


# --------------------------------------------------------------- MSheath

SB, ST, SD, SL = 2, 6, 32, 4
VALID = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool)


@pytest.fixture(scope="module")
def sheath_pair():
    x = np.random.RandomState(0).randn(SB, ST, SD).astype(np.float32)
    jm = JMSheath(dims=SD, head=2, layer=SL)
    params = jax.device_get(jm.init({"params": jax.random.key(1)},
                                    jnp.asarray(x))["params"])
    tm = MSheath(SD, 2, SL, device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm, x


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_msheath_streaming_matches_jax(sheath_pair, use_valid, scale):
    """Buffer form: two input scales steer the jump policy down
    different paths; the scan is PyTorch ops (never the kernel's plain
    version, whose count stays the kernel oracle's)."""
    jm, v, tm, x = sheath_pair
    x = x * scale
    valid = VALID if use_valid else None
    want, aux_w = jax.jit(lambda v, x, m: jm.apply(
        v, x, m, streaming=True))(v, jnp.asarray(x),
                                  None if valid is None else
                                  jnp.asarray(valid))
    kernels.reset_counts()
    got, aux_g = tm(torch.from_numpy(x),
                    None if valid is None else torch.from_numpy(valid),
                    streaming=True)
    assert kernels.counts()["fused_sheath_scan"] == {"launches": 0,
                                                     "plain_calls": 0}
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(_np(aux_g["actions"]),
                                  np.asarray(aux_w["actions"]))
    np.testing.assert_array_equal(_np(aux_g["jstat"]),
                                  np.asarray(aux_w["jstat"]))


@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_msheath_stream_step_by_induction(sheath_pair, scale):
    """Position by position: the port's stream_step against its own
    buffer form's position t and against the JAX stream_step."""
    jm, v, tm, x = sheath_pair
    x = x * scale
    buf, _ = tm(torch.from_numpy(x), streaming=True)
    jstep = jax.jit(lambda v, x, st: jm.apply(v, x, st,
                                              method=JMSheath.stream_step))
    jst = jm.apply(v, SB, method=JMSheath.init_stream_state)
    st = tm.init_stream_state(SB)
    for t in range(ST):
        xt = x[:, t:t + 1]
        want, jst = jstep(v, jnp.asarray(xt), jst)
        got, st = tm.stream_step(torch.from_numpy(xt), st)
        assert _rel(got, buf[:, t:t + 1]) <= TOL, t
        assert _rel(got, want) <= TOL, t
        np.testing.assert_array_equal(_np(st["actions"]),
                                      np.asarray(jst["actions"]))
    assert st["count"] == ST == int(jst["count"])


# ------------------------------------------------------ attention steps

@pytest.fixture(scope="module")
def attn_pair():
    rng = np.random.RandomState(2)
    x = (rng.randn(BATCH, 8, 32) * 0.5).astype(np.float32)
    jm = JAttention(dims=32, head=2, layer=2, n_type="AbbyNormal")
    params = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.asarray(x)))(jax.random.key(3))["params"])
    tm = Attention(32, 2, "AbbyNormal", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, {"params": params}, tm, rng


@pytest.mark.parametrize("pos", [0, 5])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_steps_match_jax(attn_pair, pos, causal):
    jm, v, tm, rng = attn_pair
    xt = (rng.randn(BATCH, 1, 32) * 0.5).astype(np.float32)
    jx, tx = jnp.asarray(xt), torch.from_numpy(xt)
    wq = jm.apply(v, jx, pos, causal, method=JAttention.q_step)
    wk, wv = jm.apply(v, jx, pos, causal, method=JAttention.kv_step)
    gq = tm.q_step(tx, pos, causal)
    gk, gv = tm.kv_step(tx, pos, causal)
    for got, want in ((gq, wq), (gk, wk), (gv, wv)):
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL
    # a cache of 8 positions, the first pos + 1 live
    kn = (rng.randn(BATCH, 2, 8, 16)).astype(np.float32)
    vc = (rng.randn(BATCH, 2, 8, 16)).astype(np.float32)
    valid = np.broadcast_to(np.arange(8) <= pos, (BATCH, 8)).copy()
    want = jm.apply(v, wq, jnp.asarray(kn), jnp.asarray(vc),
                    jnp.asarray(valid), method=JAttention.attend_cached)
    got = tm.attend_cached(gq, torch.from_numpy(kn), torch.from_numpy(vc),
                           torch.from_numpy(valid))
    assert _rel(got, want) <= TOL


# --------------------------------------------------------------- models

def _feats(seed=0):
    rng = np.random.RandomState(seed)
    return dict(spectrogram=rng.randn(BATCH, 8, T_AUDIO).astype(np.float32),
                pitch=np.abs(rng.randn(BATCH, 1, T_AUDIO)).astype(
                    np.float32))


def _jax_model(kw, seed=0, eos_gain=1.0, **cfg):
    """A JAX model and its variables (numpy), the learned positions
    redrawn from N(0, 10^2) (their init is all ones, under which every
    position decodes alike) so a greedy decode emits varied tokens, and
    EOS's embedding row scaled by ``eos_gain`` (EOS then comes early
    unless it is suppressed)."""
    rng = np.random.RandomState(100 + seed)
    jm = JModel(param=JDims(**kw), cfg=JConfig(dims=JDims(**kw), **cfg))
    f = _feats(seed)
    variables = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jnp.ones((BATCH, 2), jnp.int32),
        **{k: jnp.asarray(x) for k, x in f.items()}))(jax.random.key(seed)))
    p = variables["params"]["processor"]
    p["position"] = 10.0 * rng.randn(*p["position"].shape).astype(np.float32)
    emb = np.array(p["token"]["embedding"])
    emb[EOS_ID] *= eos_gain
    p["token"]["embedding"] = emb
    return jm, variables


def _port(kw, variables, **cfg):
    m = Model(Dimensions(**kw), ModelConfig(**cfg), device="cpu")
    m.load_state_dict(from_jax_params(variables["params"],
                                      variables.get("batch_stats")),
                      strict=True)
    return m


def _jv(variables):
    return jax.tree.map(jnp.asarray, variables)


@pytest.fixture(scope="module")
def stream_pair():
    """A streaming model whose decode ends in EOS at its third token,
    and emits six distinct tokens with EOS suppressed."""
    jm, variables = _jax_model(KW, seed=2, eos_gain=1.5, streaming=True)
    return jm, variables, _port(KW, variables, streaming=True)


@pytest.mark.parametrize("cfg", [dict(causal_all=True),
                                 dict(streaming=True)])
def test_buffer_forward_matches_jax(cfg):
    jm, variables = _jax_model(KW, seed=1, **cfg)
    f = _feats(1)
    ids = np.random.RandomState(5).randint(3, 128, (BATCH, 7))
    valid = np.arange(7)[None, :] < np.array([[5], [7]])
    want = jax.jit(lambda v, m: jm.apply(
        v, jnp.asarray(ids, jnp.int32), text_valid=m,
        **{k: jnp.asarray(x) for k, x in f.items()})["logits"])(
            _jv(variables), jnp.asarray(valid))
    got = _port(KW, variables, **cfg)(
        torch.from_numpy(ids), text_valid=torch.from_numpy(valid),
        **{k: torch.from_numpy(x) for k, x in f.items()})["logits"]
    assert _rel(got, want) <= TOL


def test_decode_stream_step_logits_match_jax(stream_pair):
    """Every step's logits, the tokens fed teacher-forced from a seed."""
    jm, variables, pm = stream_pair
    f = _feats(2)
    T = 1 + NEW
    toks = np.random.RandomState(7).randint(3, 128, (T, BATCH))
    jf = {k: jnp.asarray(x) for k, x in f.items()}
    jv = _jv(variables)
    enc = jm.apply(jv, jslots(jf["pitch"], jf["spectrogram"]),
                   method=JModel.encode)

    def _pre(mdl, enc):
        blk = mdl.processor.block[-1]
        return mdl.processor._precompute_cross(
            blk, mdl.processor._encode_xa(blk, enc))

    jkv = jm.apply(jv, enc, method=_pre)
    jpe = jsinusoids(T, KW["dims"], 30000.0)

    def _step(mdl, st, tok, pos):
        return mdl.processor.decode_stream_step(tok, pos, st, jkv, jpe)

    jstep = jax.jit(lambda v, st, tok, pos: jm.apply(v, st, tok, pos,
                                                     method=_step))
    jst = jm.apply(jv, method=lambda mdl: mdl.processor.init_stream_state(
        BATCH, T, jnp.float32))
    tf = {k: torch.from_numpy(x) for k, x in f.items()}
    kv = prepare_cross(pm, modality_slots(tf["pitch"], tf["spectrogram"]))
    proc = pm.processor
    st = proc.init_stream_state(BATCH, T, torch.float32)
    pe = sinusoids(T, KW["dims"])
    for pos in range(T):
        want, jst = jstep(jv, jst, jnp.asarray(toks[pos], jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        got, st = proc.decode_stream_step(torch.from_numpy(toks[pos]), pos,
                                          st, kv, pe)
        assert got.dtype == torch.float32 and got.shape == (BATCH, 128)
        assert _rel(got, want) <= TOL, pos


@pytest.mark.parametrize("suppress_eos", [False, True])
def test_stream_decode_tokens_match_jax(stream_pair, suppress_eos):
    """The port of tests/test_stream_decode.py:36-43: the incremental
    decode equals JAX's and the port's own buffer decode."""
    jm, variables, pm = stream_pair
    f = _feats(2)
    kw = dict(max_new_tokens=NEW, suppress_eos=suppress_eos)
    want = np.asarray(jstream(jm, _jv(variables),
                              **{k: jnp.asarray(x) for k, x in f.items()},
                              **kw))
    tf = {k: torch.from_numpy(x) for k, x in f.items()}
    kernels.reset_counts()
    got = greedy_decode_stream(pm, **tf, **kw).numpy()
    assert kernels.counts()["fused_sheath_scan"]["plain_calls"] > 0
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(greedy_decode(pm, **tf, **kw).numpy(),
                                  want)


def test_buffer_decode_of_streaming_model_matches_jax(stream_pair):
    """The buffer decode of a streaming model reads the blended head
    (seq=False), as the JAX package's ``_decode_step`` does (the
    incremental decode's test holds it with EOS allowed too)."""
    jm, variables, pm = stream_pair
    f = _feats(2)
    kw = dict(max_new_tokens=NEW, suppress_eos=True)
    want = np.asarray(jgreedy(jm, _jv(variables),
                              **{k: jnp.asarray(x) for k, x in f.items()},
                              **kw))
    got = greedy_decode(pm, **{k: torch.from_numpy(x) for k, x in f.items()},
                        **kw).numpy()
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    np.testing.assert_array_equal(got, want)


def test_stream_decode_matches_buffer_decode_bf16(stream_pair):
    """As tests/test_stream_decode.py:45-56: bf16 running sums and
    cumulative sums may differ in the last ulp; token agreement is the
    contract."""
    _, variables, _ = stream_pair
    pm = cast_variables(_port(KW, variables, streaming=True))
    f = {k: torch.from_numpy(x).to(torch.bfloat16)
         for k, x in _feats(2).items()}
    kw = dict(max_new_tokens=NEW, suppress_eos=True)
    want = greedy_decode(pm, **f, **kw)
    got = greedy_decode_stream(pm, **f, **kw)
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    assert got.tolist() == want.tolist()


def test_stream_decode_rejects_non_streaming():
    m = Model(Dimensions(**KW), device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        greedy_decode_stream(m, spectrogram=torch.zeros(1, 8, 8),
                             max_new_tokens=2)


def test_streaming_weights_load_strict(stream_pair):
    """A streaming model has the parameter tree of the reference one."""
    _, variables, pm = stream_pair
    sd = from_jax_params(variables["params"], variables.get("batch_stats"))
    assert pm.state_dict().keys() == sd.keys() \
        == Model(Dimensions(**KW), device="cpu").state_dict().keys()


FUSED = dict(fused_attention=True, fused_mlp=True, fused_router=True)
SWITCHES = ((jam, "_PALLAS_XATTN"), (jdm, "_PALLAS_MLP"),
            (jgm, "_PALLAS_ROUTER"))


def test_fused_streaming_decode_matches_jax(monkeypatch):
    """The fused fields on a streaming model, against the JAX decode with
    PALLAS_XATTN / PALLAS_MLP / PALLAS_ROUTER "on" (interpret): the
    stream step takes the MLP and router kernels' plain versions, the
    buffer decode every fused one."""
    for mod, name in SWITCHES:
        monkeypatch.setattr(mod, name, "on")
    jm, variables = _jax_model(FKW, seed=3, streaming=True)
    f = _feats(3)
    kw = dict(max_new_tokens=NEW, suppress_eos=True)
    want = np.asarray(jstream(jm, _jv(variables),
                              **{k: jnp.asarray(x) for k, x in f.items()},
                              **kw))
    pm = _port(FKW, variables, streaming=True, **FUSED)
    tf = {k: torch.from_numpy(x) for k, x in f.items()}
    kernels.reset_counts()
    got = greedy_decode_stream(pm, **tf, **kw).numpy()
    c = kernels.counts()
    assert c["fused_mlp_residual"]["plain_calls"] > 0
    assert c["fused_router_same"]["plain_calls"] > 0
    assert len(set(want[:, 1:].ravel().tolist())) > 2, "degenerate decode"
    np.testing.assert_array_equal(got, want)
    kernels.reset_counts()
    np.testing.assert_array_equal(greedy_decode(pm, **tf, **kw).numpy(),
                                  want)
    c = kernels.counts()
    assert all(c[n]["plain_calls"] > 0 for n in kernels.FUSED_ONLY), c
