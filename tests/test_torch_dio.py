"""The port's DIO + StoneMask (``ops/dio.py``) against the JAX package's
(``asr_model_tpu/ops/dio.py``) on the CPU, and the contour fix's plain
version (``ops/cuda/dio.py:dio_contour_plain``, the CUDA kernel's oracle)
against the JAX ``_fix_contour``.

Signals: the tones, chirp, weak fundamental, silence and noise of
tests/test_pitch.py, 1 s each.  Tolerance: voicing equal on at least
99% of frames; on frames voiced in both, median |df0| < 0.01 Hz and mean
|df0| < 0.5 Hz (the two FFT libraries differ in the last bits of f32,
which can move a zero crossing and so one frame's candidate).  The
contour fix only compares and selects, so it must be exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_model_tpu.ops import dio as jdio

from asr_model_tpu_torch.ops import cuda as kernels
from asr_model_tpu_torch.ops import dio
from asr_model_tpu_torch.ops.cuda.dio import dio_contour_plain

SR = 16000


def _signal(kind: str, dur: float) -> np.ndarray:
    t = np.arange(int(SR * dur)) / SR
    if kind == "tone":
        x = sum((0.6 ** k) * np.sin(2 * np.pi * 220.0 * (k + 1) * t)
                for k in range(3))
    elif kind == "low_tone":
        x = sum((0.6 ** k) * np.sin(2 * np.pi * 100.0 * (k + 1) * t)
                for k in range(3))
    elif kind == "chirp":
        x = np.sin(2 * np.pi * (150 * t + 50 * t ** 2))
    elif kind == "weak_fundamental":
        x = (0.1 * np.sin(2 * np.pi * 150 * t)
             + 0.8 * np.sin(2 * np.pi * 300 * t)
             + 0.5 * np.sin(2 * np.pi * 450 * t)
             + 0.4 * np.sin(2 * np.pi * 600 * t))
    elif kind == "silence":
        x = np.zeros_like(t)
    else:
        x = np.random.RandomState(0).randn(len(t))
    return x.astype(np.float32)


# one length, so the JAX side traces one program a function (seconds
# each at -O0)
SIGNALS = [("tone", 1.0), ("low_tone", 1.0), ("chirp", 1.0),
           ("weak_fundamental", 1.0), ("silence", 1.0), ("noise", 1.0)]


def _agree(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    vg, vw = got > 0, want > 0
    share = float((vg == vw).mean())
    both = vg & vw
    d = np.abs(got[both] - want[both])
    if both.any():      # the observed agreement, shown with pytest -rP
        print(f"{what}: voicing equal on {share:.2%}; median |df0| "
              f"{np.median(d):.2e} Hz, mean {d.mean():.2e}, max "
              f"{d.max():.2e}")
    assert share >= 0.99, (what, share)
    if both.any():
        assert float(np.median(d)) < 0.01 and float(d.mean()) < 0.5, \
            (what, float(np.median(d)), float(d.mean()))


@pytest.mark.parametrize("kind,dur", SIGNALS)
def test_dio_pitch_track_matches_jax(kind, dur):
    x = _signal(kind, dur)
    want_f0, want_t = jax.jit(jdio.dio_f0)(jnp.asarray(x))
    want = jax.jit(jdio.stonemask_f0)(jnp.asarray(x), want_f0, want_t)
    kernels.reset_counts()
    got_f0, got_t = dio.dio_f0(torch.from_numpy(x))
    got = dio.stonemask_f0(torch.from_numpy(x), got_f0, got_t)
    assert kernels.counts()["dio_contour"] == {"launches": 0,
                                               "plain_calls": 1}
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    _agree(got_f0.numpy(), want_f0, f"dio_f0 {kind}")
    _agree(got.numpy(), want, f"stonemask {kind}")
    both_pass, _ = dio.dio_pitch_track(torch.from_numpy(x))
    np.testing.assert_array_equal(both_pass.numpy(), got.numpy())
    if kind in ("tone", "low_tone", "chirp", "weak_fundamental"):
        assert (got.numpy() > 0).mean() > 0.8
    if kind == "silence":
        assert not (got.numpy() > 0).any()


def test_dio_batch_rows_equal_single_rows():
    """The (B, n) batch is the rows' tracks, each with its own mean."""
    xs = np.stack([_signal("tone", 0.5), 0.3 + _signal("low_tone", 0.5),
                   _signal("silence", 0.5)])
    got, _ = dio.dio_pitch_track(torch.from_numpy(xs))
    for i, x in enumerate(xs):
        one, _ = dio.dio_pitch_track(torch.from_numpy(x))
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=1e-5,
                                   atol=1e-3)


def _contour_case(seed: int, batch: int = 3, nb: int = 7, nf: int = 160):
    """Candidates around a slow contour with holes; the best-candidate
    track with gaps, runs of 1-2 frames and jumps of 1.5x."""
    rng = np.random.RandomState(seed)
    base = 120 + 60 * np.sin(np.arange(nf) / 17.0)
    cand = (base[None, None] * (1 + 0.08 * rng.randn(batch, nb, nf))
            ).astype(np.float32)
    cand[rng.rand(batch, nb, nf) < 0.4] = 0.0
    f0 = cand[:, 0].copy()
    f0[rng.rand(batch, nf) < 0.3] = 0.0
    f0[rng.rand(batch, nf) < 0.05] *= 1.5
    f0[:, 40:43] = [0.0, base[41], 0.0]          # a run of one frame
    f0[:, 60:64] = [0.0, base[61], base[62], 0.0]   # a run of two
    return cand, f0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_contour_fix_equals_jax_exactly(seed):
    cand, f0 = _contour_case(seed)
    fix = jax.jit(jdio._fix_contour, static_argnums=(3, 4, 5))
    want = np.stack([np.asarray(fix(jnp.asarray(cand[b]),
                                    jnp.zeros(cand.shape[1:]),
                                    jnp.asarray(f0[b]), 10.0, 71.0, 0.1))
                     for b in range(cand.shape[0])])
    kernels.reset_counts()
    got = kernels.dio.dio_contour(torch.from_numpy(cand),
                                  torch.from_numpy(f0), 3, 0.1).numpy()
    assert kernels.counts()["dio_contour"] == {"launches": 0,
                                               "plain_calls": 1}
    np.testing.assert_array_equal(got, want)
    assert (got != f0).any()            # the fix did something


def test_contour_plain_is_the_wrapper_route_on_cpu():
    cand, f0 = _contour_case(5, batch=2, nb=3, nf=80)
    a = dio_contour_plain(torch.from_numpy(cand), torch.from_numpy(f0), 5,
                          0.2)
    b = kernels.dio.dio_contour(torch.from_numpy(cand),
                                torch.from_numpy(f0), 5, 0.2)
    assert torch.equal(a, b)


def test_contour_wrapper_refuses_other_devices():
    meta = torch.empty(1, 7, 10, device="meta")
    with pytest.raises(ValueError):
        kernels.dio.dio_contour(meta, meta[:, 0], 3, 0.1)
