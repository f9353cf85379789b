"""The port's ``make_train_step`` against the JAX package's, float32:
one and three steps from the same weights on the same batch, noise-free
(``tests/_torch_train_step.py``), from the JAX init and from
``wide_margins`` (its hard choices decided far above a bf16 ulp).
Loss within 1e-5 and the global grad norm within 1e-4, relative
(float32 sums in other orders); the jump counter exactly; BatchNorm's
running statistics within 1e-5 of their scale after one step (1e-3
after three: the depthwise biases, whose gradient cancels in
BatchNorm, take MaxFactor's noise steps on each side, and they shift
the batch means); on the live tensors MaxFactor's row/column/v
statistics within 1e-3 of each tensor's scale after one step (squared
gradients), 1e-2 after three (the gradients of steps 2 and 3 are taken
at parameters the earlier sign flips moved apart); over the live
tensors, at least 99.5% of the updated elements equal within 1e-3 of
their tensor's largest update after one step (99% after three) and the
update difference within 1% of the update's norm (3% after three).
Measured from the JAX init: 99.98% and 0.15% after one step, 99.7% and
0.67% after three; the rest are sign flips of near-zero update elements
(MaxFactor moves every element by its row's full step, so a
rounding-level gradient difference flips its direction).  From
``wide_margins`` the update difference may reach 3% after one step too
(measured 1.9%: 0.06% of the elements, in q_proj's and the first
depthwise kernel, flip; 99.94% equal; 0.45% after three), and 98% of
the elements equal after three (measured 98.99-99.05%, with the order
of the float32 sums depending on the thread count).

The port's bf16 step (bf16 compute over f32 masters) is held here to
JAX's float32 step at ``wide_margins``, where no hard choice differs
between bf16 and f32 (``test_torch_train_step_bf16.py`` checks that):
JAX's own bf16 step cannot be the tight reference, because its backward
sums broadcast cotangents in bf16 (a bias gradient over N rows carries
~sqrt(N) bf16 roundings; the port sums them in f32), so its bf16
gradient sits ~20% from its f32 one where the port's sits ~2%
(``python tests/bf16_witness.py``).  Bounds of the step-1 check: the
loss within 1e-2 relative and the grad norm within 5e-2 (measured
3.4e-3 and 1.4e-2); each tensor's bf16 gradient within 5% of its norm
plus 0.5% of the largest tensor's gradient norm of its f32 gradient,
the port's f32 gradient being held to JAX's by the grad norm and the
MaxFactor statistics here (measured: 1.8% over all tensors), but the
query projection's within 30%: the q path amplifies bf16 rounding in
both frameworks (measured here 23% for its kernel, 18% for its bias,
whose gradient is 1.6% of the largest; JAX's bf16 q_proj gradient is
off by several times its norm, and after two bf16 steps both
frameworks' are 7-9 times their f32 one: the witness); the same bounds
on MaxFactor's statistics after the step, in gradient units (their
square roots), against JAX f32's; and at least 85% of the
updated elements equal to JAX f32's within 1e-3 of the tensor's
largest update (measured 90%: a bf16-level gradient difference flips
the sign of an element's full-size MaxFactor step)."""

import numpy as np
import pytest

from _torch_train_step import (check_step, live_names,  # noqa: F401
                               one_thread, port_grads, port_steps, run,
                               update_agreement)


@pytest.fixture(scope="module")
def steps():
    mp = pytest.MonkeyPatch()
    try:
        yield run(mp, "f32", inits=(False, True))
    finally:
        mp.undo()


@pytest.mark.parametrize("n", [1, 3])
def test_train_step_matches_jax_f32(steps, n):
    theirs, ours, init, _v = steps[False]
    check_step(theirs, ours, init, n, 0.01 if n == 1 else 0.03,
           0.995 if n == 1 else 0.99)


@pytest.mark.parametrize("n", [1, 3])
def test_train_step_matches_jax_f32_wide_margins(steps, n):
    theirs, ours, init, _v = steps[True]
    check_step(theirs, ours, init, n, 0.03, 0.995 if n == 1 else 0.98)


def _rtol(name):
    """The relative part of the bf16 bound of a tensor (module doc)."""
    return 0.3 if "/attn/q_proj/" in name else 0.05


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64)))


def test_bf16_step_held_to_jax_f32(steps):
    theirs, _ours, init, v = steps[True]
    tl, tg, _tj, tp, ts, _tb = theirs[0]
    ol, og, _oj, op, os_, _ob = port_steps(v, "bf16", steps=1)[0]
    print(f"loss {ol} / {tl}, grad norm {og} / {tg}")
    assert abs(ol - tl) <= 1e-2 * tl, (ol, tl)
    assert abs(og - tg) <= 5e-2 * tg, (og, tg)

    _l16, g16 = port_grads(v, "bf16")
    _l32, g32 = port_grads(v, "f32")
    top = max(_norm(g) for g in g32.values())
    diff = [_norm(g16[k] - g32[k]) for k in g32]
    total = np.sqrt(sum(d * d for d in diff)) / np.sqrt(
        sum(_norm(g) ** 2 for g in g32.values()))
    print(f"bf16 gradient {100 * total:.2f}% from f32 over all tensors")
    assert total <= 5e-2, total
    for k, d in zip(g32, diff):
        assert d <= _rtol(k) * _norm(g32[k]) + 5e-3 * top, (k, d)

    names = live_names(ts)
    for key in ("row_var", "col_var", "v"):
        mine = {k: np.sqrt(os_[key][k]) for k in names}
        ref = {k: np.sqrt(ts[key][k]) for k in names}
        big = max(float(np.abs(a).max()) for a in ref.values())
        for k in names:
            err = float(np.abs(mine[k] - ref[k]).max())
            scale = float(np.abs(ref[k]).max())
            assert err <= _rtol(k) * scale + 5e-3 * big, (key, k, err)
    share, _rel = update_agreement(op, tp, init, names)
    print(f"{100 * share:.1f}% of the updated elements equal")
    assert share >= 0.85, share
