"""The port's mesh, sharding rules and DP / TP / EP train step, on gloo
ranks on the CPU, against the JAX package's rules and the port's
one-device step (which ``test_torch_train_step.py`` holds to the JAX
package's step).

One spawn of 4 ranks serves every multi-rank case (``CASES``,
``tests/_torch_parallel_cases.py``).  The mesh step is held to the
one-device step at ``tests/test_parallel.py``'s bounds: the updated
parameters (and BatchNorm's running statistics) within atol 2e-5 /
rtol 2e-4, the loss within 1e-5 and the grad norm within 1e-3,
relative.  The step is the train forward with its noise (a seeded
generator, dropout 0.1): the sharded draws are the whole batch's.
"""

import os

import numpy as np
import pytest
import torch

import _torch_parallel_cases as C
from _torch_dist import spawn
from _torch_train_step import letters_tokenizer, one_thread  # noqa: F401

CASES = [("layout", "mesh_layout", {}),
         ("dp_tp", "mesh_step", dict(data=2, model=2)),
         ("dp_tp_remat", "mesh_step", dict(data=2, model=2, remat=True)),
         ("dp_jumps", "mesh_step", dict(data=4, jumps=True)),
         ("ep", "mesh_step", dict(model=2, expert=2, moe=True)),
         ("ep_fwd", "mesh_forward", dict(model=2, expert=2))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("_torch_parallel_cases", CASES, 4,
                 tmp_path_factory.mktemp("ranks"))


def check_step(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-3)
    np.testing.assert_array_equal(got["jstat"], want["jstat"])
    names = [k for k in want if k.startswith("p/")]
    assert names and set(names) == {k for k in got if k.startswith("p/")}
    for k in names:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=2e-4,
                                   err_msg=k)


def test_mesh_layout_and_refusal(ranks):
    got = ranks["layout"]
    np.testing.assert_array_equal(got["coords"], [0, 0, 0, 0])
    np.testing.assert_array_equal(got["sizes"], [2, 2, 4, 1])
    assert bool(got["refused"])


def test_indivisible_heads_fall_back_to_replication(ranks):
    """A 4-way model axis over 2 heads: the attention stays whole, the
    MLPs, MSheath's tail MLP and the vocabulary still split."""
    sharded = set(ranks["layout"]["sharded"].tolist())
    assert not any("attn" in n for n in sharded)
    assert {"processor.block1.mlp_in.weight", "processor.block1.mlp_out.weight",
            "processor.block1.jump.mlp1.weight",
            "processor.token.weight"} <= sharded


def test_rules_are_the_jax_rules_transposed():
    """Every parameter's port rule, in the flax layout, is the JAX
    package's ``param_pspec`` of its flax path."""
    from asr_model_tpu.parallel.sharding import param_pspec as jax_pspec
    from asr_model_tpu_torch.parallel.sharding import param_pspec
    from asr_model_tpu_torch.weights import jax_layout, to_jax_params
    m = C.build(moe=True)
    jspecs = jax_pspec(to_jax_params(m)[0])
    layout = jax_layout(m)
    n_sharded = 0
    for name, spec in param_pspec(m).items():
        _coll, path, perm = layout[name]
        node = jspecs
        for k in path:
            node = node[k]
        if spec and perm is not None:
            spec = tuple(spec[d] for d in perm)
        assert tuple(spec) == tuple(node), (name, spec, node)
        n_sharded += bool(spec)
    assert n_sharded >= 12


def test_mesh_train_step_matches_single_device(ranks):
    """data 2 x model 2: DP rows and the Megatron split of every block,
    MSheath's tail MLP and the vocabulary."""
    check_step(ranks["dp_tp"], C.single_step())


def test_mesh_train_step_with_remat(ranks):
    """The same step with remat: the recompute inside the backward sees
    the forward's sharding and draws."""
    check_step(ranks["dp_tp_remat"], C.single_step())


def test_mesh_train_step_held_across_jumps(ranks):
    """data 4 with every MSheath policy biased to skip: the jump choices
    (the control scalars' means over the sharded batch) and BatchNorm's
    train statistics (whole-batch) match the one-device step."""
    want = C.single_step(jumps=True)
    assert want["jstat"][1] + want["jstat"][2] > 0
    check_step(ranks["dp_jumps"], want)


def test_expert_parallel_matches_unsharded(ranks):
    """expert 2 x model 2 on the chained MoE model: each rank's experts,
    each expert's pair split over model; the forward and the step."""
    check_step(ranks["ep"], C.single_step(moe=True))
    want = C.single_forward()["logits"]
    np.testing.assert_allclose(ranks["ep_fwd"]["logits"], want, rtol=1e-5,
                               atol=1e-4 * np.abs(want).max())


def test_batch_rows_replicate_a_ragged_batch():
    from asr_model_tpu_torch.parallel.mesh import make_mesh
    from asr_model_tpu_torch.parallel.sharding import (batch_rows,
                                                       batch_shardings)
    mesh = make_mesh()
    b = C.batch(3)
    assert set(batch_shardings(b, mesh).values()) == {("data",)}
    rows, split = batch_rows(b, mesh)
    assert not split and rows is b


@pytest.mark.parametrize("flags,message", [
    (["--mesh-expert", "2", "--device", "cpu"],
     "--mesh-expert needs --moe-experts > 0"),
    (["--mesh-pipe", "2", "--device", "cpu"],
     "--mesh-pipe needs --chained-blocks"),
    (["--mesh-data", "2", "--batch-size", "3", "--device", "cpu"],
     "--batch-size 3 must be a multiple of --mesh-data 2"),
    (["--mesh-model", "2", "--device", "cuda"], "needs 2 devices, have")])
def test_cli_mesh_checks(flags, message):
    from asr_model_tpu_torch import cli
    if "cuda" in flags and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has the cards")
    with pytest.raises(SystemExit, match=message):
        cli.main(["--synthetic", "4"] + flags)


def test_cli_mesh_trains_and_jax_restores(tmp_path):
    """``--mesh-data 2 --mesh-model 2 --device cpu``: the CLI starts its
    4 ranks, trains 2 synthetic steps and writes checkpoints in the
    unsharded layout, which the JAX package restores."""
    import jax
    from asr_model_tpu.config import Config as JConfig
    from asr_model_tpu.train import checkpoint as jckpt
    from asr_model_tpu.train.loop import make_optimizer as jmake_optimizer
    from asr_model_tpu_torch import cli
    from asr_model_tpu_torch.config import Dimensions
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.weights import to_jax_params
    tok = letters_tokenizer(tmp_path / "tok.json")
    summary = cli.main([
        "--synthetic", "8", "--max-steps", "2", "--batch-size", "4",
        "--tokenizer", tok, "--tokens", "32", "--dims", "16", "--head", "2",
        "--layer", "2", "--mels", "8", "--no-pitch", "--no-waveform",
        "--pad-multiple", "64", "--eval-interval", "0", "--save-interval",
        "1", "--prefetch", "0", "--mesh-data", "2", "--mesh-model", "2",
        "--device", "cpu", "--log-dir", str(tmp_path)])
    assert summary["ranks"] == 4 and summary["step"] == 2
    assert np.isfinite(summary["loss"])
    params, stats = to_jax_params(Model(Dimensions(
        tokens=32, mels=8, dims=16, head=2, layer=2), device="cpu"))
    tx, _ = jmake_optimizer(JConfig(), params)
    got = jckpt.restore_checkpoint(
        os.path.join(tmp_path, "final_model.msgpack"),
        {"params": params, "opt_state": tx.init(params),
         "batch_stats": stats, "step": 0})
    assert int(got["step"]) == 2 and int(got["opt_state"].step) == 2
    token = np.asarray(got["params"]["processor"]["token"]["embedding"])
    assert token.shape == (32, 16) and np.isfinite(token).all()
    for leaf in jax.tree.leaves(got["params"]):
        assert np.isfinite(np.asarray(leaf)).all()
