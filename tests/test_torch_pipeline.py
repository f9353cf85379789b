"""The port's GPipe pipeline on gloo ranks on the CPU, against the JAX
package's ``pipeline_forward`` and ``make_pp_train_step`` on the same
init and batch (``tests/golden/pipeline.npz``, made by
``tests/_pipeline_golden.py``) and the port's unsharded gradients.

One spawn of 4 ranks serves every multi-rank case (the fixture,
``tests/_torch_pipeline_cases.py``).  The bounds, and why:

* The forward: within rtol 5e-3 (``tests/test_pipeline.py``'s) and
  5e-5 of the largest logit of the port's own unsharded forward applied
  per microbatch (the function the pipeline computes; 0.006 read at one
  element where the data shards sum MSheath's means in another order),
  and within 5e-4 of the largest logit of JAX's ``pipeline_forward``.
  Element by element the port's unsharded forward itself sits up to
  0.045 from JAX's PP logits (2 of 1,200 beyond 5e-3 at (2, 2, 2),
  logits up to ~240): the f32 floor of this chained model, not the
  pipeline (at pipe 1 the two are equal).
* The float64 gradients through (data 2, pipe 2): rtol 1e-8, and atol
  1e-10 per unit of each tensor's largest gradient (one element of
  ``tgate.cs.weight``, value 3.5e-3 in a tensor reaching ~70, sits
  4.3e-10 off: the data shards sum in another order).
* Three noise-free steps (data 2, pipe 2, 2 microbatches) against JAX's
  ``make_pp_train_step``: the loss within 1e-5 at every step, the grad
  norm within 1e-3 at step 1 (``tests/test_parallel.py``'s mesh bound;
  3.4e-4 read) and 1e-2 after (7.1e-3 read at step 3), BatchNorm's
  statistics at ``check_step``'s bounds, and step 1's updates
  (``update_agreement``) on 99% of the elements, the difference within
  5% of JAX's update (0.994 and 0.039 read).  Past step 1 the updates
  are not compared element by element: MaxFactor's signed steps turn
  the chained model's f32 rounding into whole steps (the port's own
  pipeline at (1, 1) against (2, 2): 99.1% of step 3's updates equal
  with 8 intra-op threads, 58% with one), while the loss, a function of
  every weight, stays within 1e-5 of JAX's.  JAX's PP step counts no
  jumps; that check is left out.
"""

import os

import numpy as np
import pytest

import _torch_pipeline_cases as C
from _pipeline_golden import STEPS, load, sub
from _torch_dist import spawn
from _torch_train_step import (live_names, one_thread,  # noqa: F401
                               update_agreement)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    cases = [("f141", "forward", dict(data=1, pipe=4, micro=1)),
             ("f222", "forward", dict(data=2, pipe=2, micro=2)),
             ("grads64", "grads64", {}),
             ("steps", "steps", dict(ckpt_path=str(tmp / "pp.msgpack"))),
             ("remat", "remat_step", {})]
    out = spawn("_torch_pipeline_cases", cases, 4, tmp)
    out["ckpt"] = str(tmp / "pp.msgpack")
    return out


@pytest.mark.parametrize("mesh", ["1x4x1", "2x2x2"])
def test_pp_forward_matches_jax(ranks, mesh):
    got = ranks["f" + mesh.replace("x", "")]["logits"]
    own = C.single_forward(int(mesh[-1]))
    np.testing.assert_allclose(got, own, rtol=5e-3,
                               atol=5e-5 * np.abs(own).max())
    want = load()[f"fwd/{mesh}"]
    assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max()


def test_pp_gradients_f64_match_unsharded(ranks):
    want = C.single_grads64()
    got = ranks["grads64"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-8, atol=1e-10 * max(
            1.0, float(np.abs(v).max())), err_msg=k)


def _side(src, n):
    """``check_step``'s per-step tuple of a flat step record."""
    def tree_of(prefix):
        return {k[len(prefix) + 1:]: v for k, v in src.items()
                if k.startswith(prefix + "/")}
    return (float(src[f"step{n}/loss"]), float(src[f"step{n}/gnorm"]),
            np.zeros(3, np.int32), tree_of(f"step{n}/params"),
            {key: tree_of(f"step{n}/{key}")
             for key in ("row_var", "col_var", "v")},
            tree_of(f"step{n}/batch_stats"))


@pytest.mark.parametrize("n", range(1, STEPS + 1))
def test_pp_steps_match_jax(ranks, n):
    g = load()
    theirs, mine = _side(g, n), _side(ranks["steps"], n)
    init = {k[len("params/"):]: v for k, v in g.items()
            if k.startswith("params/")}
    names = live_names(theirs[4])
    assert len(names) > 50
    assert abs(mine[0] - theirs[0]) <= 1e-5 * abs(theirs[0])
    assert abs(mine[1] - theirs[1]) <= (1e-3 if n == 1 else 1e-2) * \
        abs(theirs[1])
    bs_tol = 1e-5 if n == 1 else 1e-3
    for k in theirs[5]:
        scale = max(float(np.abs(theirs[5][k]).max()), 1.0)
        assert float(np.abs(mine[5][k] - theirs[5][k]).max()) <= \
            bs_tol * scale, k
    if n == 1:
        share, rel = update_agreement(mine[3], theirs[3], init, names)
        assert share >= 0.99 and rel <= 0.05, (share, rel)


def test_pp_step_with_remat(ranks):
    """Remat changes no value: the first step with it equals the step
    without (the recompute inside the backward sees the forward's
    sharding and draws)."""
    got, want = ranks["remat"], ranks["steps"]
    np.testing.assert_allclose(got["loss"], want["step1/loss"], rtol=1e-6)
    np.testing.assert_allclose(got["gnorm"], want["step1/gnorm"], rtol=1e-6)
    for k in (k for k in got if k.startswith("params/")):
        np.testing.assert_allclose(got[k], want[f"step1/{k}"], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_pp_checkpoint_restored_by_jax(ranks):
    """The port's pipeline-layout checkpoint in the JAX package's PP
    target (stacked blocks, ``{base, blocks}`` MaxFactor state), and its
    unsharded layout equal to the port's."""
    import jax
    from asr_model_tpu.config import Config as JConfig
    from asr_model_tpu.parallel import pipeline as jpp
    from asr_model_tpu.train import checkpoint as jckpt
    from asr_model_tpu_torch.parallel import pipeline as PP
    g = load()
    params = jpp.to_pipeline_params(sub(g, "params"))
    tx, _ = jpp.make_pp_optimizer(JConfig(), params)
    got = jckpt.restore_checkpoint(
        ranks["ckpt"], {"params": params, "opt_state": tx.init(params),
                        "batch_stats": sub(g, "batch_stats"), "step": 0})
    assert int(got["step"]) == STEPS
    un = jpp.from_pipeline_params(jax.device_get(got["params"]))
    st = jpp.from_pipeline_opt_state(jax.device_get(got["opt_state"]))
    assert int(st.step) == STEPS
    ours = ranks["steps"]
    for k, v in C.flat(un):
        np.testing.assert_array_equal(v, ours[f"step{STEPS}/params/{k}"], k)
    for key in ("row_var", "col_var", "v"):
        for k, v in C.flat(getattr(st, key)):
            np.testing.assert_array_equal(
                v, ours[f"step{STEPS}/{key}/{k}"], k)
    # the port's own layout functions invert each other
    state = {"step": np.asarray(3, np.int32),
             **{key: jax.tree.map(np.asarray, getattr(st, key))
                for key in ("row_var", "col_var", "v")}}
    back = PP.from_pipeline_opt_state(PP.to_pipeline_opt_state(state))
    for key in ("row_var", "col_var", "v"):
        a, b = dict(C.flat(back[key])), dict(C.flat(state[key]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)
    assert os.path.getsize(ranks["ckpt"]) > 0


def test_pp_refusals():
    from asr_model_tpu_torch.config import Dimensions, ModelConfig
    from asr_model_tpu_torch.models.model import Model
    from asr_model_tpu_torch.parallel.mesh import make_pipe_mesh
    from asr_model_tpu_torch.parallel.pipeline import check_pipeline
    mesh = make_pipe_mesh(pipe=1)
    dims = Dimensions(**C.KW)
    with pytest.raises(ValueError, match="chained"):
        check_pipeline(Model(dims, ModelConfig(), device="cpu"), mesh, 1)
    with pytest.raises(ValueError, match="MoE"):
        check_pipeline(Model(dims, ModelConfig(
            chained_blocks=True, moe_experts=2), device="cpu"), mesh, 1)
    m = Model(dims, ModelConfig(chained_blocks=True), device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        check_pipeline(m, mesh, 3, rows=4)


def test_cli_pipe_trains_and_writes_both_layouts(tmp_path):
    """``--mesh-pipe 2 --mesh-data 2 --microbatches 2 --chained-blocks
    --device cpu``: the CLI's 4 ranks train 2 synthetic steps; the step
    checkpoint is in the pipeline layout, the final model unsharded
    with a fresh optimizer state, as the JAX loop writes them."""
    from _torch_train_step import letters_tokenizer
    from asr_model_tpu_torch import cli
    from asr_model_tpu_torch.train.checkpoint import restore_checkpoint
    tok = letters_tokenizer(tmp_path / "tok.json")
    summary = cli.main([
        "--synthetic", "8", "--max-steps", "2", "--batch-size", "4",
        "--tokenizer", tok, "--tokens", "32", "--dims", "16", "--head", "2",
        "--layer", "2", "--mels", "8", "--no-pitch", "--no-waveform",
        "--pad-multiple", "64", "--eval-interval", "0", "--save-interval",
        "1", "--prefetch", "0", "--chained-blocks", "--mesh-pipe", "2",
        "--mesh-data", "2", "--microbatches", "2", "--device", "cpu",
        "--log-dir", str(tmp_path)])
    assert summary["ranks"] == 4 and summary["step"] == 2
    assert np.isfinite(summary["loss"]) and np.isfinite(summary["gnorm"])
    mid = restore_checkpoint(os.path.join(tmp_path,
                                          "checkpoint_step_1.msgpack"))
    proc = mid["params"]["processor"]
    assert "blocks" in proc and "block0" not in proc
    # saved after global step 1's update: the optimizer's second
    np.testing.assert_array_equal(mid["opt_state"]["blocks"]["step"],
                                  [2, 2])
    assert int(mid["opt_state"]["base"]["step"]) == 2
    final = restore_checkpoint(os.path.join(tmp_path, "final_model.msgpack"))
    proc = final["params"]["processor"]
    assert "block0" in proc and "block1" in proc and "blocks" not in proc
    assert int(final["step"]) == 2 and int(final["opt_state"]["step"]) == 0
