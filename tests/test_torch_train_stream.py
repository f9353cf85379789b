"""The port's train step on the streaming-causal model against the JAX
package's, and the port's remat step against the JAX package's
``make_train_step(remat=True)``, on the CPU: one step of the tiny model
of ``tests/_torch_train_step.py`` with ``ModelConfig(streaming=True)``
(causal MSheath pooling, the causal d||e cross) on the same batch from
the JAX init and from ``wide_margins``, in the noise-free limit (JAX's
gumbel draws replaced by zeros, dropout 0; the port's generator None),
f32.  One JAX program, the remat step ("dots"), is the reference for
the port's step without remat and with each policy (the port's three
are equal to the bit: ``tests/test_torch_remat.py``).  Bounds, those of
``tests/test_torch_train_step.py`` after one step: the loss within
1e-5 and the grad norm within 1e-4 relative, the jump counter exactly,
BatchNorm's running statistics within 1e-5 of their scale; from
``wide_margins`` also MaxFactor's statistics within 1e-3 of each live
tensor's scale, at least 99.5% of the updated elements equal within
1e-3 of their tensor's largest update and the update difference within
1% of its norm.  From the JAX init one statistic misses that 1e-3:
``block1/attn/head_norm/router_out/kernel``'s row variance, where JAX's
f32 step reads 1.5e-3 of the scale from the port's step run in float64
and the port's f32 step 4.9e-5 (measured), so there the statistics are
JAX's rounding, and that init holds the first four bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_train_step import (KW, batch, check_step, flat,  # noqa: F401
                               one_thread, port_steps, wide_margins)

from asr_model_tpu.config import Config as JConfig
from asr_model_tpu.config import Dimensions as JDims
from asr_model_tpu.config import ModelConfig as JModelConfig
from asr_model_tpu.models.model import Model as JModel
from asr_model_tpu.train.loop import make_optimizer as jmake_optimizer
from asr_model_tpu.train.loop import make_train_step as jmake_train_step


@pytest.fixture(scope="module")
def jax_step():
    """{margins: (JAX's per-step tuple, the initial params, the
    variables)} of one noise-free remat step of the streaming model from
    the JAX init and from ``wide_margins``, through one program."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32:
               jnp.zeros(shape, dtype))
    try:
        jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
              for k, v in batch().items()}
        jm = JModel(param=JDims(**KW), cfg=JModelConfig(
            dims=JDims(**KW), dropout=0.0, streaming=True))
        v = jax.device_get(jax.jit(lambda r: jm.init(
            {"params": r}, jb["text_ids"], spectrogram=jb["spectrogram"],
            pitch=jb["pitch"], waveform=jb["waveform"]))(jax.random.key(0)))
        tx, _ = jmake_optimizer(JConfig(), v["params"])
        step = jmake_train_step(jm, tx, 0.0, remat=True)
        out = {}
        for margins in (False, True):
            vm = dict(v, params=wide_margins(v["params"])) if margins else v
            p, o, bs, _r, loss, gn, js = step(
                vm["params"], tx.init(vm["params"]), vm["batch_stats"],
                jax.random.key(1), jb)
            o = jax.device_get(o)
            theirs = (float(loss), float(gn), np.asarray(js),
                      dict(flat(jax.device_get(p))),
                      {k: dict(flat(getattr(o, k)))
                       for k in ("row_var", "col_var", "v")},
                      dict(flat(jax.device_get(bs))))
            out[margins] = (theirs, dict(flat(vm["params"])), vm)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("margins", [False, True])
@pytest.mark.parametrize("remat,policy", [(False, "dots"), (True, "dots"),
                                          (True, "full")])
def test_streaming_train_step_matches_jax(jax_step, remat, policy, margins):
    theirs, init, v = jax_step[margins]
    ours = port_steps(v, "f32", steps=1, streaming=True, remat=remat,
                      remat_policy=policy)
    print(f"loss {ours[0][0]} / {theirs[0]}, grad norm {ours[0][1]} / "
          f"{theirs[1]}, jstat {ours[0][2]} / {theirs[2]}")
    check_step([theirs], ours, init, 1, 0.01, 0.995, updates=margins)
