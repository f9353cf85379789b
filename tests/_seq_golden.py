"""The JAX package's sequence-parallel functions on tiny models, stored as
``tests/golden/seq.npz`` for ``tests/test_torch_seq.py``: their programs
(shard_map'd encoders, the SP decode loop, the long-form frontend) take
minutes to trace and compile on a CPU at the suite's ``-O0``, so the
test reads their outputs from here; rebuild with
``python tests/_seq_golden.py`` (from the repo's root; ~5 min).

All on a ``seq`` 4 mesh of virtual CPU devices, from the JAX init of
key 0 (spectrogram, pitch and waveform at init, so every stem exists):

* ``attn/{q,k,v,valid,out}``: ``seq_sharded_attention`` with a key mask
  that leaves one row no valid key;
* ``enc/...`` and ``enc_norm/...`` (``encoder_norm=True``):
  ``params/<flax path>``, ``batch_stats/<flax path>``, the feature
  ``spec`` (1, 8, 128) and ``sp_encode``'s output ``out``;
* ``decode/ids``: ``greedy_decode_sp`` on ``enc``'s model and feature
  (6 tokens, EOS suppressed);
* ``long/audio`` (3 s) and ``long/ids``: ``transcribe_long_sp`` on
  ``enc``'s model without the pitch track, 8 tokens.
"""

import os

import numpy as np

KW = dict(tokens=32, mels=8, dims=16, head=2, layer=2)
SEQ = 4
T = SEQ * 32
PATH = os.path.join(os.path.dirname(__file__), "golden", "seq.npz")


def feature(seed: int):
    return np.random.RandomState(seed).randn(1, 8, T).astype(np.float32)


def long_audio():
    """3 s at 16 kHz: two tones and a little noise (seed 2)."""
    rs = np.random.RandomState(2)
    t = np.arange(48000) / 16000.0
    a = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 560 * t)
    return (a + 0.01 * rs.randn(t.size)).astype(np.float32)


def flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), np.asarray(v)


def load():
    g = np.load(PATH)
    return {k: g[k] for k in g.files}


def sub(g, prefix):
    """The nested tree stored under ``prefix/``."""
    n = len(prefix) + 1
    out = {}
    for k, a in g.items():
        if k.startswith(prefix + "/"):
            *path, leaf = k[n:].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return out


def main():
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from asr_model_tpu.config import Dimensions as JDims
    from asr_model_tpu.config import ModelConfig as JModelConfig
    from asr_model_tpu.models.generate import greedy_decode_sp
    from asr_model_tpu.models.longform import transcribe_long_sp
    from asr_model_tpu.models.model import Model as JModel
    from asr_model_tpu.parallel.mesh import make_mesh
    from asr_model_tpu.parallel.seq import seq_sharded_attention, sp_encode

    mesh = make_mesh(data=1, model=1, seq=SEQ)
    out = {}
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 2, 4, d).astype(np.float32)
               for d in (16, 16, 16))
    k = rs.randn(2, 2, 64, 16).astype(np.float32)
    v = rs.randn(2, 2, 64, 16).astype(np.float32)
    valid = np.arange(64)[None].repeat(2, 0) < np.array([[40], [0]])
    out.update({"attn/q": q, "attn/k": k, "attn/v": v, "attn/valid": valid})
    out["attn/out"] = np.asarray(seq_sharded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
        kv_valid=jnp.asarray(valid)))

    for name, norm, seed in (("enc", False, 0), ("enc_norm", True, 1)):
        jm = JModel(param=JDims(**KW),
                    cfg=JModelConfig(dims=JDims(**KW), encoder_norm=norm))
        spec = feature(seed)
        mono = np.zeros((1, 1, T), np.float32)
        variables = jax.device_get(jax.jit(lambda r: jm.init(
            {"params": r}, jnp.ones((1, 2), jnp.int32),
            spectrogram=jnp.asarray(spec), pitch=jnp.asarray(mono),
            waveform=jnp.asarray(mono)))(jax.random.key(0)))
        out.update({f"{name}/params/{k_}": a
                    for k_, a in flat(variables["params"])})
        out.update({f"{name}/batch_stats/{k_}": a
                    for k_, a in flat(variables["batch_stats"])})
        out[f"{name}/spec"] = spec
        out[f"{name}/out"] = np.asarray(sp_encode(
            jm, variables, jnp.asarray(spec), mesh))
        print(name, flush=True)
        if name == "enc":
            out["decode/ids"] = np.asarray(greedy_decode_sp(
                jm, variables, mesh, spectrogram=jnp.asarray(spec),
                max_new_tokens=6, suppress_eos=True))
            print("decode", out["decode/ids"], flush=True)
            audio = long_audio()
            out["long/audio"] = audio
            ids, _ = transcribe_long_sp(jm, variables, audio, mesh,
                                        max_new_tokens=8, use_pitch=False)
            out["long/ids"] = np.asarray(ids, np.int64)
            print("long", ids, flush=True)
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **out)
    print("wrote", PATH, len(out), "arrays")


if __name__ == "__main__":
    main()
