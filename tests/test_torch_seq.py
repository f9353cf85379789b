"""The port's sequence parallelism at ``seq`` 4 on gloo ranks on the CPU,
against the JAX package's functions on the same inits and inputs
(``tests/golden/seq.npz``, made by ``tests/_seq_golden.py``) and the
port's unsharded encoder and decode.

One spawn of 4 ranks serves every multi-rank case (``CASES``,
``tests/_torch_seq_cases.py``).  The encoder and the attention are held
at ``tests/test_parallel.py``'s bounds (atol 2e-5, rtol 2e-4); the token
ids exactly.
"""

import numpy as np
import pytest
import torch

import _torch_seq_cases as C
from _seq_golden import load
from _torch_dist import spawn
from _torch_train_step import one_thread  # noqa: F401

CASES = [("attn", "attention", {}),
         ("enc", "encode", dict(name="enc")),
         ("enc_norm", "encode", dict(name="enc_norm")),
         ("decode", "decode", {}),
         ("long", "long", {})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_seq_cases", CASES, 4,
                 tmp_path_factory.mktemp("ranks"))


def test_seq_sharded_attention(ranks):
    """Keys split over 4 ranks, one batch row with valid keys and one
    with none: the JAX package's merge, and the port's unsharded
    attention on the row that has keys."""
    from asr_model_tpu_torch.models.attention import sdpa
    g = load()
    got = ranks["attn"]["out"]
    np.testing.assert_allclose(got, g["attn/out"], atol=2e-5, rtol=2e-4)
    q, k, v = (torch.from_numpy(g[f"attn/{n}"]) for n in "qkv")
    valid = torch.from_numpy(g["attn/valid"])
    want = sdpa(q, k, v, kv_valid=valid).numpy()
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=2e-4)
    assert not valid[1].any() and np.all(got[1] == 0)


@pytest.mark.parametrize("name", ["enc", "enc_norm"])
def test_sp_encode_matches_unsharded_and_jax(ranks, name):
    m, spec = C.build(name)
    got = ranks[name]["out"]
    with torch.no_grad():
        want = m.enc.process_feature(spec).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got, load()[f"{name}/out"], atol=2e-5,
                               rtol=2e-4)


def test_sp_encode_refusals():
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.parallel.mesh import make_mesh
    from asr_model_tpu_torch.parallel.seq import sp_encode
    mesh = make_mesh()
    spec = torch.zeros(1, 8, 32)
    m, _ = C.build()
    with pytest.raises(ValueError, match="inference-only"):
        sp_encode(m, spec, mesh, train=True)
    for cfg, dims, match in (
            (dict(encoder_transformer=True), {}, "encoder_transformer"),
            (dict(encoder_norm=True), dict(n_type="instancenorm"),
             "position-wise")):
        bad = Model(Dimensions(**(C.KW | dims)), ModelConfig(**cfg),
                    device="cpu")
        with pytest.raises(ValueError, match=match):
            sp_encode(bad, spec, mesh)


def test_greedy_decode_sp_tokens(ranks):
    """The JAX package's ``greedy_decode_sp`` and the port's plain
    ``greedy_decode``, token for token."""
    from asr_model_tpu_torch.models.generate import greedy_decode
    m, spec = C.build()
    want = greedy_decode(m, spectrogram=spec, max_new_tokens=6,
                         suppress_eos=True).numpy()
    np.testing.assert_array_equal(ranks["decode"]["ids"], want)
    np.testing.assert_array_equal(ranks["decode"]["ids"],
                                  load()["decode/ids"])


def test_seq_sharding_context_routes_the_cached_cross_call(monkeypatch):
    """Under ``seq_sharding`` (a one-rank axis here) the cached cross
    call goes through ``seq_sharded_attention`` and keeps the plain
    decode's tokens."""
    from asr_model_tpu_torch.models.generate import greedy_decode
    from asr_model_tpu_torch.parallel import seq as SP
    from asr_model_tpu_torch.parallel.mesh import make_mesh
    m, spec = C.build()
    calls = []
    real = SP.seq_sharded_attention
    monkeypatch.setattr(SP, "seq_sharded_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = greedy_decode(m, spectrogram=spec, max_new_tokens=4)
    with SP.seq_sharding(make_mesh()):
        got = greedy_decode(m, spectrogram=spec, max_new_tokens=4)
    assert calls
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_transcribe_long_sp_ids(ranks):
    np.testing.assert_array_equal(ranks["long"]["ids"], load()["long/ids"])
