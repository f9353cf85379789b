"""The port's gradient diagnostics and reference importer against the
JAX package's, on the CPU.

``make_grad_diagnostics``: the gradient of the eval loss (running
BatchNorm statistics, no dropout, noise-free routing) for every
parameter, in the JAX layout under the flax names, against the JAX
package's ``make_grad_diagnostics`` on the tiny model of
``tests/_torch_train_step.py`` from the JAX init and from
``wide_margins``: the same names; per tensor the difference within 2%
of JAX's gradient norm plus 1e-4 of the largest tensor's (measured: the
router's tensors, whose gradients are 1e-9..1e-7 of the largest, differ
by their rounding noise; head_norm's router kernel by 1.7% from the JAX
init); the spectral entropies within 1e-4 (measured 7e-6); and no
eval-only kernel route taken.  ``train_and_evaluate(log_detail=True)``
writes the JAX loop's ``train/per_layer_norms_*`` and ``Entropy/*``
scalars, every one finite.

The importer: ``convert_state_dict`` on the golden reference state dict
(``tests/golden/reference_parity.npz``) equal leaf for leaf to the JAX
package's converter, the imported port model's logits and loss within
2e-4 and 1e-4 of the golden's (``tests/test_reference_parity.py``'s
bounds), the unneeded keys reported and a missing one a KeyError;
``import_reference_checkpoint`` on a ``.pt`` written from the golden
loads the same weights."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from _torch_train_step import (KW, batch, jax_variables,  # noqa: F401
                               letters_tokenizer, one_thread, port_model)

from asr_model_tpu.compat import convert_state_dict as jconvert
from asr_model_tpu.train.loop import make_grad_diagnostics as jdiag
from asr_model_tpu.train.metrics import spectral_entropy as jentropy
from asr_model_tpu.train.metrics import track_grad_norms as jnorms

from asr_model_tpu_torch.compat import (convert_state_dict,
                                        import_reference_checkpoint)
from asr_model_tpu_torch.config import (Config, Dimensions, ModelConfig,
                                        OptimConfig, RunConfig)
from asr_model_tpu_torch.data.dataset import (GrammarDataset, Repeated,
                                              random_split)
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.ops.cuda import abby, sheath
from asr_model_tpu_torch.train.loop import (device_batch,
                                            make_grad_diagnostics,
                                            train_and_evaluate)
from asr_model_tpu_torch.train.metrics import (spectral_entropy,
                                               track_grad_norms)
from asr_model_tpu_torch.weights import from_jax_params, to_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_parity.npz")


@pytest.fixture(scope="module")
def jgrads():
    """The JAX package's diagnostics of the tiny model, one program for
    both initialisations."""
    return jdiag(jax_variables()[0])


@pytest.mark.parametrize("margins", [False, True])
def test_grad_diagnostics_match_jax(jgrads, margins):
    _jm, v, jb = jax_variables(margins)
    theirs = jax.device_get(jgrads(v["params"], v["batch_stats"],
                                   jax.random.key(0), jb))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                theirs)[0]}
    m = port_model(v)
    calls = (sheath.sheath_scan_plain.calls, abby.abby_plain.calls)
    ours = make_grad_diagnostics(m)(device_batch(batch(), "cpu"))
    assert (sheath.sheath_scan_plain.calls, abby.abby_plain.calls) == calls
    norms, jn = track_grad_norms(ours.items()), jnorms(theirs)
    assert set(ours) == set(flat) == set(norms) == set(jn)
    top = max(jn.values())
    for k, want in flat.items():
        got = ours[k].numpy()
        assert got.shape == want.shape, k
        diff = float(np.linalg.norm(got - want))
        assert diff <= 2e-2 * jn[k] + 1e-4 * top, (k, diff, jn[k], top)
        if want.size > 1024:
            assert abs(spectral_entropy(ours[k]) - jentropy(want)) <= 1e-4


class Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, name, value, step):
        self.scalars[name] = float(value)

    def close(self):
        pass


def test_log_detail_writes_the_jax_scalars(tmp_path):
    tok = setup_tokenizer(letters_tokenizer(tmp_path / "tok.json"))
    train, _ = GrammarDataset.make_split(4, 0)
    ds = GrammarDataset(train, tokenizer=tok, device="cpu", extract_args=dict(
        spectrogram=True, pitch=True, waveform=True, mels=8,
        pitch_estimator="dio"))
    tr, ev = random_split(ds, 0.75)
    dims = Dimensions(**KW)
    cfg = Config(dims=dims, model=ModelConfig(),
                 optim=OptimConfig(total_steps=2),
                 run=RunConfig(max_steps=1, batch_size=3, prefetch_depth=0,
                               checkpoint_dir=str(tmp_path),
                               log_dir=str(tmp_path)))
    model = Model(dims, cfg.model, device="cpu")
    rec = Recorder()
    train_and_evaluate(model, tok, Repeated(tr, batch_size=3),
                       Repeated(ev, batch_size=3), cfg, writer=rec,
                       log_detail=True)
    names = dict(to_jax_params(model)[0])
    flat = {}

    def walk(tree, pre):
        for k, val in tree.items():
            if isinstance(val, dict):
                walk(val, pre + (k,))
            else:
                flat[".".join(pre + (k,))] = val

    walk(names, ())
    norms = {k[len("train/per_layer_norms_"):] for k in rec.scalars
             if k.startswith("train/per_layer_norms_")}
    ent = {k[len("Entropy/"):] for k in rec.scalars
           if k.startswith("Entropy/")}
    assert norms == set(flat)
    assert ent == {k for k, a in flat.items() if a.size > 1024} and ent
    assert all(np.isfinite(v) for v in rec.scalars.values())


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    dims = Dimensions(tokens=int(g["cfg_tokens"]), mels=int(g["cfg_mels"]),
                      dims=int(g["cfg_dims"]), head=int(g["cfg_head"]),
                      layer=int(g["cfg_layer"]))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd:")}
    return g, dims, sd


def _logits(model, g):
    t = lambda k: torch.from_numpy(g[k])
    out = model(t("in_text_ids").long(), labels=t("in_labels").long(),
                spectrogram=t("in_spectrogram"), pitch=t("in_pitch"),
                waveform=t("in_waveform"))
    return out["logits"].numpy(), float(out["loss"])


def test_reference_import_matches_golden(golden, tmp_path, caplog):
    g, dims, sd = golden
    model = Model(dims, device="cpu")
    params, stats = to_jax_params(model)
    with caplog.at_level(logging.WARNING):
        v = convert_state_dict(sd, params, stats)
    assert any("not imported" in r.getMessage() for r in caplog.records)
    assert "processor.pitch_tokens.weight" in v["unknown"]
    want = jconvert(sd, params, stats)
    for coll in ("params", "batch_stats"):
        a, b = dict(_leaves(v[coll])), dict(_leaves(want[coll]))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    model.load_state_dict(from_jax_params(v["params"], v["batch_stats"]),
                          strict=True)
    logits, loss = _logits(model, g)
    ref = g["out_logits"]
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(logits - ref).max()) / scale < 2e-4
    assert abs(loss - float(g["out_loss"])) / max(
        1.0, abs(float(g["out_loss"]))) < 1e-4

    path = tmp_path / "reference_model.pt"
    torch.save({k: torch.tensor(a) for k, a in sd.items()}, str(path))
    other = Model(dims, device="cpu", seed=1)
    unknown = import_reference_checkpoint(str(path), other)
    assert unknown == v["unknown"]
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                other.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka

    partial = dict(sd)
    partial.pop("processor.position")
    with pytest.raises(KeyError):
        convert_state_dict(partial, params, stats)


def _leaves(tree, pre=()):
    for k, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, pre + (k,))
        else:
            yield pre + (k,), np.asarray(val)
