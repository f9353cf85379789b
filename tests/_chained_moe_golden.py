"""The JAX package's train-step loss and gradients of a tiny chained MoE
model (with the encoder's ``norm`` and ``enc`` options), in float32 and
in float64, stored as ``tests/golden/chained_moe_step.npz`` for
``tests/test_torch_moe.py``.  Its two programs take ~3 and ~4 minutes to
trace and compile on a CPU at the suite's ``-O0``, so the test reads
them from here; rebuild with ``python tests/_chained_moe_golden.py``
(from the repo's root; ~7 min).

The step is JAX's noise-free train loss (its gumbel draws replaced by
zeros, dropout 0): cross entropy + ``moe_aux_weight`` times the summed
MoE aux, at the JAX init from key 0.  The float64 program is the same
jitted loss under ``jax.enable_x64`` on the float64 casts of the
weights, batch statistics and features; the modules' own float32 casts
(the router softmax, the logits) stay where the JAX package puts them.

Stored: ``params/<flax path>`` and ``batch_stats/<flax path>`` (the
init, float32), and for ``f32`` and ``f64``: ``loss``, ``aux`` (the
summed aux), ``jstat`` (the jump counter summed over every MSheath call)
and ``grad/<flax path>``.
"""

import os

import numpy as np

KW = dict(tokens=50, mels=8, dims=16, head=2, layer=2)
MOE = dict(chained_blocks=True, moe_experts=4, moe_top_k=2,
           moe_capacity_factor=1.25, moe_aux_weight=0.05,
           encoder_norm=True, encoder_transformer=True, dropout=0.0)
B = 2
PATH = os.path.join(os.path.dirname(__file__), "golden",
                    "chained_moe_step.npz")


def batch():
    """The step's batch (numpy, seed 0): 12 frames, 6 text positions,
    the second example's last two labels padding."""
    rs = np.random.RandomState(0)
    ta, tt = 12, 6
    labels = rs.randint(3, 50, (B, tt))
    labels[1, -2:] = 0
    return {"spectrogram": rs.randn(B, 8, ta).astype(np.float32),
            "pitch": (rs.rand(B, 1, ta) * 200).astype(np.float32),
            "waveform": (rs.randn(B, 1, ta) * 0.3).astype(np.float32),
            "text_ids": rs.randint(3, 50, (B, tt)), "labels": labels}


def flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def load():
    """(params, batch_stats, {"f32": ..., "f64": ...}) from the golden:
    nested flax trees, and per dtype the loss, aux, jstat and a flat
    {flax path: gradient}."""
    g = np.load(PATH)

    def tree(prefix):
        out = {}
        for k in g.files:
            if k.startswith(prefix + "/"):
                *path, leaf = k[len(prefix) + 1:].split("/")
                d = out
                for p in path:
                    d = d.setdefault(p, {})
                d[leaf] = g[k]
        return out

    steps = {}
    for dt in ("f32", "f64"):
        steps[dt] = dict(loss=float(g[f"{dt}/loss"]),
                         aux=float(g[f"{dt}/aux"]),
                         jstat=g[f"{dt}/jstat"],
                         grads={k[len(dt) + 6:]: g[k] for k in g.files
                                if k.startswith(f"{dt}/grad/")})
    return tree("params"), tree("batch_stats"), steps


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from asr_model_tpu.config import Dimensions as JDims
    from asr_model_tpu.config import ModelConfig as JModelConfig
    from asr_model_tpu.models.model import Model as JModel
    from asr_model_tpu.train.loop import _collect_sown

    jm = JModel(param=JDims(**KW), cfg=JModelConfig(dims=JDims(**KW),
                                                    **MOE))
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    feats = ("spectrogram", "pitch", "waveform")
    v = jax.device_get(jax.jit(lambda r: jm.init(
        {"params": r}, jb["text_ids"], **{k: jb[k] for k in feats}))(
            jax.random.key(0)))

    def step(params, stats, jb):
        def loss_fn(p):
            out, mut = jm.apply(
                {"params": p, "batch_stats": stats}, jb["text_ids"],
                labels=jb["labels"], **{k: jb[k] for k in feats},
                train=True, rngs={"gumbel": jax.random.key(2),
                                  "dropout": jax.random.key(3)},
                mutable=["batch_stats", "intermediates"])
            inter = mut["intermediates"]
            aux = sum(jnp.sum(a) for a in _collect_sown(inter, "moe_aux"))
            jstat = sum(jnp.sum(s, axis=0)
                        for s in _collect_sown(inter, "jstat"))
            return out["loss"] + MOE["moe_aux_weight"] * aux, (aux, jstat)
        (loss, (aux, jstat)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        return jax.device_get((loss, aux, jstat, grads))

    out = {f"params/{k}": a for k, a in flat(v["params"])}
    out.update({f"batch_stats/{k}": a for k, a in flat(v["batch_stats"])})
    gumbel = jax.random.gumbel
    jax.random.gumbel = lambda key, shape, dtype=jnp.float32: \
        jnp.zeros(shape, dtype)
    try:
        runs = {"f32": step(v["params"], v["batch_stats"], jb)}
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), t)
            jb64 = {k: jnp.asarray(np.asarray(a, np.float64)
                                   if k in feats else a)
                    for k, a in b.items()}
            runs["f64"] = step(f64(v["params"]), f64(v["batch_stats"]),
                               jb64)
    finally:
        jax.random.gumbel = gumbel
    for dt, (loss, aux, jstat, grads) in runs.items():
        out[f"{dt}/loss"], out[f"{dt}/aux"] = np.asarray(loss), np.asarray(aux)
        out[f"{dt}/jstat"] = np.asarray(jstat)
        out.update({f"{dt}/grad/{k}": a for k, a in flat(grads)})
    assert out["f64/grad/processor/block0/moe/router/kernel"].dtype \
        == np.float64
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: {len(out)} arrays")


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    main()
