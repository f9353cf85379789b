"""The JAX package's GPipe pipeline on a tiny chained model, stored as
``tests/golden/pipeline.npz`` for ``tests/test_torch_pipeline.py``: the
JAX pipeline programs take minutes to trace and compile on a CPU at the
suite's ``-O0``, so the test reads their outputs from here; rebuild with
``python tests/_pipeline_golden.py`` (from the repo's root; ~10 min).

* ``fwd/<data>x<pipe>x<micro>``: ``pipeline_forward``'s eval logits on
  a (data, pipe) mesh with that many microbatches, for (1, 4, 1) and
  (2, 2, 2).
* ``step<n>/...`` for n = 1..3: ``make_pp_train_step`` on the (2, 2)
  mesh with 2 microbatches, in the noise-free limit (the gumbel draws
  replaced by zeros, dropout 0), from the JAX init of key 0 with
  ``make_pp_optimizer``: ``loss``, ``gnorm``, ``params/<flax path>`` in
  the unsharded layout (``from_pipeline_params``), the optimizer state
  ``row_var``/``col_var``/``v`` likewise (``from_pipeline_opt_state``)
  and ``batch_stats``.

Stored besides: ``params/<flax path>`` and ``batch_stats/<flax path>``,
the init (float32), and the batch under ``batch/<key>``.
"""

import os

import numpy as np

KW = dict(tokens=50, mels=8, dims=16, head=2, layer=4)
CFG = dict(chained_blocks=True, dropout=0.0)
FWD_MESHES = ((1, 4, 1), (2, 2, 2))
STEP_MESH = (2, 2, 2)           # data, pipe, microbatches
STEPS = 3
PATH = os.path.join(os.path.dirname(__file__), "golden", "pipeline.npz")


def batch():
    """The batch (numpy, seed 0): 4 rows, 6 text positions, 12 frames of
    spectrogram and pitch, the last row's last label padding."""
    rs = np.random.RandomState(0)
    b, tt, ta = 4, 6, 12
    labels = rs.randint(3, 50, (b, tt))
    labels[3, -1] = 0
    return {"text_ids": rs.randint(3, 50, (b, tt)), "labels": labels,
            "spectrogram": rs.randn(b, 8, ta).astype(np.float32),
            "pitch": (rs.rand(b, 1, ta) * 200).astype(np.float32)}


def flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def tree(flat_items):
    out = {}
    for name, a in flat_items:
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


def load():
    """The golden as {key: array}."""
    g = np.load(PATH)
    return {k: g[k] for k in g.files}


def sub(g, prefix):
    """The nested tree stored under ``prefix/``."""
    n = len(prefix) + 1
    return tree((k[n:], a) for k, a in g.items() if k.startswith(prefix + "/"))


def main():
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    # the persistent compilation cache of the suite (tests/conftest.py)
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(__file__), "..", ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    from asr_model_tpu.config import Config
    from asr_model_tpu.config import Dimensions as JDims
    from asr_model_tpu.config import ModelConfig as JModelConfig
    from asr_model_tpu.models.model import Model as JModel
    from asr_model_tpu.parallel import pipeline as pp

    jm = JModel(param=JDims(**KW), cfg=JModelConfig(dims=JDims(**KW), **CFG))
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    v = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r, "gumbel": r}, jb["text_ids"], labels=jb["labels"],
        spectrogram=jb["spectrogram"], pitch=jb["pitch"]))(
            jax.random.key(0)))
    out = {f"params/{k}": a for k, a in flat(v["params"])}
    out.update({f"batch_stats/{k}": a for k, a in flat(v["batch_stats"])})
    out.update({f"batch/{k}": a for k, a in b.items()})

    for data, pipe, micro in FWD_MESHES:
        mesh = pp.make_pipe_mesh(pipe=pipe, data=data)
        ppp = pp.shard_pipeline_params(pp.to_pipeline_params(v["params"]),
                                       mesh)
        logits, _ = jax.jit(lambda p, bb, mesh=mesh, micro=micro:
                            pp.pipeline_forward(
                                jm, p, bb, mesh, micro,
                                batch_stats=v["batch_stats"]))(ppp, jb)
        out[f"fwd/{data}x{pipe}x{micro}"] = np.asarray(
            jax.device_get(logits))
        print("forward", data, pipe, micro, flush=True)

    gumbel = jax.random.gumbel
    jax.random.gumbel = lambda key, shape, dtype=jnp.float32: \
        jnp.zeros(shape, dtype)
    try:
        data, pipe, micro = STEP_MESH
        mesh = pp.make_pipe_mesh(pipe=pipe, data=data)
        params = pp.to_pipeline_params(v["params"])
        tx, _ = pp.make_pp_optimizer(Config(), params)
        opt = pp.shard_pp_opt_state(tx.init(params), mesh)
        params = pp.shard_pipeline_params(params, mesh)
        bs = v["batch_stats"]
        step = pp.make_pp_train_step(jm, tx, mesh, micro)
        rng = jax.random.key(1)
        for n in range(1, STEPS + 1):
            params, opt, bs, rng, loss, gnorm, _ = step(params, opt, bs,
                                                        rng, jb)
            got = jax.device_get((params, opt, bs, loss, gnorm))
            un = pp.from_pipeline_params(got[0])
            st = pp.from_pipeline_opt_state(got[1])
            out[f"step{n}/loss"] = np.asarray(got[3])
            out[f"step{n}/gnorm"] = np.asarray(got[4])
            out.update({f"step{n}/params/{k}": a for k, a in flat(un)})
            for key in ("row_var", "col_var", "v"):
                out.update({f"step{n}/{key}/{k}": a
                            for k, a in flat(getattr(st, key))})
            out.update({f"step{n}/batch_stats/{k}": a
                        for k, a in flat(got[2])})
            print("step", n, float(got[3]), float(got[4]), flush=True)
    finally:
        jax.random.gumbel = gumbel
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **out)
    print("wrote", PATH, len(out), "arrays")


if __name__ == "__main__":
    main()
