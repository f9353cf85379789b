"""Checkpoints, resume, the training loop and the CLI of the port, on the
CPU at a tiny size: a port checkpoint read by the JAX package's
``restore_checkpoint`` into its own tree (MaxFactor state included), a
JAX checkpoint read by the port and stepped on by both optimizers from
there, a resumed run equal to an uninterrupted one (the generator's state
travels in the checkpoint), the TensorBoard scalar names of the JAX
loop, and ``python -m asr_model_tpu_torch.cli`` on ``--device cpu``.
Arrays compare exactly where they are copied, and to the MaxFactor
golden's bound (atol 2e-6, rtol 1e-5) where both optimizers step."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.config import Config as JConfig
from asr_model_tpu.optim.maxfactor import MaxFactorState
from asr_model_tpu.train import checkpoint as jckpt
from asr_model_tpu.train.loop import make_optimizer as jmake_optimizer

from asr_model_tpu_torch import cli
from asr_model_tpu_torch.config import (Config, DataConfig, Dimensions,
                                        ModelConfig, OptimConfig, RunConfig)
from asr_model_tpu_torch.data.dataset import Repeated, SyntheticDataset
from asr_model_tpu_torch.data.tokenizer import setup_tokenizer
from asr_model_tpu_torch.models.model import Model
from asr_model_tpu_torch.train import checkpoint as ckpt
from asr_model_tpu_torch.train.loop import (device_batch, make_optimizer,
                                            make_train_step,
                                            restore_training,
                                            train_and_evaluate)
from asr_model_tpu_torch.weights import to_jax_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
ASSET = os.path.join(ROOT, "asr_model_tpu_torch", "assets",
                     "tokenizer.json")
KW = dict(tokens=64, mels=8, dims=16, head=2, layer=2)
JAX_SCALARS = {"Loss/train", "LearningRate", "SamplesPerSec", "GradNorm",
               "OneShot/scale", "Jumps/Layer_Maintained_0",
               "Jumps/Skipped_1_Layer", "Jumps/Skipped_2_Layers",
               "Loss/eval", "WER", "EvalSamples", "EvalTimeSeconds"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs files
    in parallel worker processes, and PyTorch's thread pools in each of
    them oversubscribe the cores (a test here ran 47x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, pre + (k,))
    else:
        yield "/".join(pre), np.asarray(tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {"spectrogram": rs.randn(2, 8, 16).astype(np.float32),
            "text_ids": rs.randint(3, 64, (2, 5)),
            "labels": rs.randint(3, 64, (2, 5))}


def _trained_model(steps=2):
    m = Model(Dimensions(**KW), ModelConfig(dropout=0.0), device="cpu")
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m)
    step = make_train_step(m, opt)
    for i in range(steps):
        step(device_batch(_batch(i), "cpu"), None)
    return m, opt


def test_port_checkpoint_restored_by_jax(tmp_path):
    m, opt = _trained_model()
    gen = torch.Generator().manual_seed(5)
    path = ckpt.save_checkpoint(str(tmp_path / "ck.msgpack"),
                                ckpt.training_state(m, opt, 2, gen))
    params, stats = to_jax_params(Model(Dimensions(**KW), device="cpu",
                                        seed=1))
    tx, _ = jmake_optimizer(JConfig(), params)
    target = {"params": params, "opt_state": tx.init(params),
              "batch_stats": stats, "step": 0}
    got = jckpt.restore_checkpoint(path, target)
    assert isinstance(got["opt_state"], MaxFactorState)
    assert int(got["step"]) == 2 and int(got["opt_state"].step) == 2
    want_p, want_s = to_jax_params(m)
    ours = ckpt.opt_state_tree(opt, m)
    pairs = [(got["params"], want_p), (got["batch_stats"], want_s)] + [
        (getattr(got["opt_state"], k), ours[k])
        for k in ("row_var", "col_var", "v")]
    for a, b in pairs:
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].shape == lb[k].shape and la[k].dtype == lb[k].dtype
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    # the JAX loop's target has no rng; the port's restore takes it
    m2, opt2 = _trained_model(0)
    gen2 = torch.Generator()
    assert restore_training(m2, opt2, path, gen2) == 2
    assert torch.equal(gen2.get_state(), gen.get_state())


def test_multisteps_checkpoint_restored_by_jax(tmp_path):
    """With gradient accumulation the optimizer state is optax's
    ``MultiStepsState`` (``mini_step``, ``gradient_step``, the inner
    MaxFactor state, ``acc_grads`` in the JAX layout): the JAX restore
    reads a port checkpoint taken between two accumulated calls, and the
    port reads it back."""
    import optax
    m = Model(Dimensions(**KW), ModelConfig(dropout=0.0), device="cpu")
    cfg = Config(dims=Dimensions(**KW), run=RunConfig(acc_steps=2))
    opt, _ = make_optimizer(cfg, m)
    step = make_train_step(m, opt)
    for i in range(3):
        step(device_batch(_batch(i), "cpu"), None)
    assert (opt.mini_step, opt.gradient_step) == (1, 1)
    path = ckpt.save_checkpoint(str(tmp_path / "acc.msgpack"),
                                ckpt.training_state(m, opt, 3))
    params, stats = to_jax_params(m)
    tx, _ = jmake_optimizer(JConfig(), params)
    tx = optax.MultiSteps(tx, every_k_schedule=2)
    got = jckpt.restore_checkpoint(path, {"params": params,
                                          "opt_state": tx.init(params),
                                          "batch_stats": stats, "step": 0})
    ost = got["opt_state"]
    assert int(ost.mini_step) == 1 and int(ost.gradient_step) == 1
    assert int(ost.inner_opt_state.step) == 1
    ours = ckpt.opt_state_tree(opt, m)
    for name, a in _leaves(ours["acc_grads"]):
        b = dict(_leaves(ost.acc_grads))[name]
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=name)
    m2 = Model(Dimensions(**KW), ModelConfig(dropout=0.0), device="cpu",
               seed=4)
    opt2, _ = make_optimizer(cfg, m2)
    assert restore_training(m2, opt2, path) == 3
    assert (opt2.mini_step, opt2.gradient_step) == (1, 1)
    for (n, p), p2 in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(opt.acc[p], opt2.acc[p2]), n


def test_jax_checkpoint_restored_by_port_and_stepped(tmp_path):
    """A JAX MaxFactor state (two updates on the port's tree) saved by
    the JAX package, read by the port; one more update on each side
    from there with the same gradients gives the same parameters."""
    m = Model(Dimensions(**KW), ModelConfig(dropout=0.0), device="cpu")
    params, stats = to_jax_params(m)
    tx, _ = jmake_optimizer(JConfig(), params)
    st = tx.init(params)
    rs = np.random.RandomState(3)
    jp = jax.tree.map(jnp.asarray, params)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        np.asarray(rs.randn(*a.shape), np.float32)), params)
        for _ in range(3)]
    update = jax.jit(lambda g, s, p: tx.update(g, s, params=p))
    for g in grads[:2]:
        upd, st = update(g, st, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    path = str(tmp_path / "jax.msgpack")
    jckpt.save_checkpoint(path, {"params": jp, "opt_state": st,
                                 "batch_stats": stats, "step": 2})
    m2 = Model(Dimensions(**KW), ModelConfig(dropout=0.0), device="cpu",
               seed=9)
    opt, _ = make_optimizer(Config(dims=Dimensions(**KW)), m2)
    assert restore_training(m2, opt, path) == 2
    got = ckpt.opt_state_tree(opt, m2)
    for k in ("row_var", "col_var", "v"):
        la, lb = dict(_leaves(got[k])), dict(_leaves(
            jax.device_get(getattr(st, k))))
        for name in la:
            np.testing.assert_array_equal(la[name], lb[name], err_msg=name)
    upd, st = update(grads[2], st, jp)
    jp = jax.device_get(jax.tree.map(lambda p, u: p + u, jp, upd))
    layout = {n: v for n, v in _leaves(grads[2])}
    from asr_model_tpu_torch.weights import jax_layout
    for name, p in m2.named_parameters():
        _c, path_, perm = jax_layout(m2)[name]
        g = torch.from_numpy(np.asarray(layout["/".join(path_)]))
        inv = None if perm is None else tuple(np.argsort(perm))
        p.grad = (g if inv is None else g.permute(*inv)).reshape(p.shape)
    opt.step()
    ours = dict(_leaves(to_jax_params(m2)[0]))
    for name, want in _leaves(jp):
        np.testing.assert_allclose(ours[name], want, atol=2e-6, rtol=1e-5,
                                   err_msg=name)


def _cfg(tmp, steps, **run):
    return Config(dims=Dimensions(**KW), model=ModelConfig(),
                  data=DataConfig(pitch=False, waveform=False, mels=8),
                  optim=OptimConfig(warmup_steps=2, total_steps=6),
                  run=RunConfig(max_steps=steps, batch_size=2,
                                checkpoint_dir=str(tmp), log_dir=str(tmp),
                                prefetch_depth=0, log_interval=1, **run))


def _loaders():
    tok = setup_tokenizer(ASSET)
    ds = SyntheticDataset(n=2, tokenizer=tok, device="cpu",
                          dur_range=(0.3, 0.4),
                          extract_args=dict(spectrogram=True, mels=8))
    kw = dict(batch_size=2, pad_to_multiple=16, text_pad_to_multiple=16)
    return tok, Repeated(ds, **kw), Repeated(ds, **kw)


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, name, value, step):
        self.scalars.append((name, float(value), step))

    def close(self):
        pass


def test_resume_equals_uninterrupted_run(tmp_path):
    """Dropout and gumbel noise on: four steps straight, and two steps
    then a resume from the saved checkpoint for two more, end at the same
    parameters (the generator continues from the saved state)."""
    tok, train, evl = _loaders()
    tokens = dict(KW, tokens=40000)

    def model():
        return Model(Dimensions(**tokens), ModelConfig(), device="cpu")

    straight = model()
    rec = Recorder()
    train_and_evaluate(straight, tok, train, evl, _cfg(
        tmp_path / "a", 4, save_interval=0, eval_interval=0), writer=rec)
    first = model()
    train_and_evaluate(first, tok, train, evl, _cfg(
        tmp_path / "b", 2, save_interval=1, eval_interval=0),
        writer=Recorder())
    final = tmp_path / "b" / "final_model.msgpack"
    assert ckpt.latest_checkpoint(str(tmp_path / "b")).endswith(
        "checkpoint_step_1.msgpack")
    resumed = model()
    rec2 = Recorder()
    out = train_and_evaluate(resumed, tok, train, evl, _cfg(
        tmp_path / "c", 4, save_interval=0, eval_interval=0), writer=rec2,
        resume_from=str(final))
    assert out["step"] == 4
    assert [s for _n, _v, s in rec2.scalars] and \
        min(s for _n, _v, s in rec2.scalars) == 2
    for (k, a), b in zip(straight.state_dict().items(),
                         resumed.state_dict().values()):
        assert torch.equal(a, b), k
    names = {n for n, _v, _s in rec.scalars}
    assert names == JAX_SCALARS     # the last step evaluates
    cfg = JConfig.from_json((tmp_path / "a" / "config.json").read_text())
    assert cfg.model.dims.dims == KW["dims"] and cfg.run.max_steps == 4


def test_cli_trains_on_cpu(tmp_path):
    args = ["--device", "cpu", "--synthetic", "4", "--max-steps", "3",
            "--batch-size", "2", "--dims", "16", "--head", "2", "--layer",
            "2", "--mels", "8", "--eval-interval", "2", "--save-interval",
            "2", "--log-dir", str(tmp_path), "--pad-multiple", "16",
            "--pitch-estimator", "dio"]
    out = cli.main(args)
    assert out["step"] == 3 and np.isfinite(out["loss"])
    assert "eval_wer" in out
    cfg = JConfig.from_json((tmp_path / "config.json").read_text())
    assert cfg.data.pitch and cfg.data.pitch_estimator == "dio"
    assert cfg.model.dims == cfg.model.dims.__class__(
        tokens=40000, mels=8, dims=16, head=2, layer=2)
    assert os.path.exists(tmp_path / "checkpoint_step_2.msgpack")
    state = ckpt.restore_checkpoint(str(tmp_path / "final_model.msgpack"))
    assert int(state["step"]) == 3 and int(state["opt_state"]["step"]) == 3
    events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    try:
        import torch.utils.tensorboard  # noqa: F401
        assert events
    except ImportError:
        assert not events


# --remat, --metadata, --import-reference, --mesh-* and the model
# variants' flags are ported: without a data source they exit as the JAX
# CLI does
@pytest.mark.parametrize("flag,item", [
    (["--mesh-data", "2"], "--metadata/--data-dir or --synthetic"),
    (["--remat"], "--metadata/--data-dir or --synthetic"),
    (["--moe-experts", "2"], "--metadata/--data-dir or --synthetic"),
    (["--metadata", "m.csv"], "--metadata/--data-dir or --synthetic"),
    (["--import-reference", "x.pt"], "--metadata/--data-dir or --synthetic"),
    ([], "--synthetic"),
    (["--chained-blocks", "--moe-top-k", "1"],
     "--metadata/--data-dir or --synthetic"),
    (["--pitch-tokens"], "item 9")])
def test_cli_refuses_what_is_not_ported(flag, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(["--device", "cpu"] + flag)


def test_cli_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    script = ("from asr_model_tpu_torch import cli\n"
              "cli.main(['--synthetic', '2', '--max-steps', '1', "
              f"'--log-dir', {str(tmp_path)!r}])\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_evaluation_and_grad_norm_controller(tmp_path):
    """``evaluate_model`` (free-running greedy WER), the loop's
    free-running eval (``RunConfig.generate``), and the grad-norm
    controller against the JAX loop's on one history."""
    from asr_model_tpu.train.loop import \
        grad_norm_controller as jcontroller

    from asr_model_tpu_torch.train.loop import (evaluate_model,
                                                grad_norm_controller)
    from asr_model_tpu_torch.train.metrics import compute_metrics
    tok, train, evl = _loaders()
    m = Model(Dimensions(**dict(KW, tokens=40000)), ModelConfig(),
              device="cpu")
    got = evaluate_model(m, tok, evl, max_new_tokens=4)
    assert set(got) == {"loss", "wer", "preds", "labels", "eval_time"}
    assert len(got["preds"]) == 2 and np.isfinite(got["loss"])
    out = train_and_evaluate(m, tok, train, evl, _cfg(
        tmp_path, 1, generate=True), writer=Recorder())
    assert np.isfinite(out["eval_wer"]) and out["step"] == 1
    assert compute_metrics({"predictions": [[1, 5, 2]],
                            "label_ids": [[1, 5, 2]]},
                           tokenizer=tok)["wer"] == 0.0
    hist = [1.0, 1.2, 0.9, 1.1, 1.0, 2.0, 2.2, 2.1, 2.5, 2.4, 2.6, 2.8]
    for h in (hist, [h / 10 for h in hist], hist[:9]):
        assert grad_norm_controller(h, {"oneshot": 0.3}) == \
            jcontroller(h, {"oneshot": 0.3})
