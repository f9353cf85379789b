"""Host-side pieces of the cluster kernels, on the CPU: the tile and
cluster each wrapper launches (``launch_plan``, whose shared-memory
formulas the card test ``test_launch_plans_match_kernels`` holds against
the kernels' own) and the sheath kernel's cached weight layout."""

import numpy as np
import pytest
import torch

from asr_model_tpu_torch.ops.cuda import abby, sheath

SMEM_MAX = 232448            # dynamic shared memory a block may use (H100)
SMEM_SM = 233472             # shared memory of a multiprocessor
RESERVED = 1024              # the runtime's share of each resident block


def _two_per_sm(smem: int) -> bool:
    return 2 * (smem + RESERVED) <= SMEM_SM


def _covers(n: int, tiles: int, rows: int) -> bool:
    """Every row in exactly one tile: tiles of ``rows`` from row 0."""
    owner = np.repeat(np.arange(tiles), rows)[:n]
    return len(owner) == n and (tiles - 1) * rows < n


# (rows, channels) of every fused_abby call on the decode paths
ABBY_SHAPES = [(8 * w, 512) for w in range(9, 66, 8)] + \
    [(8 * 4 * w, 128) for w in range(9, 66, 8)] + [(8 * 1001, 512),
                                                   (8 * 4 * 1001, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", ABBY_SHAPES + [(33, 100), (5, 1024)])
def test_abby_launch_plan(n, d, dtype):
    p = abby.launch_plan(n, d, dtype)
    assert _covers(n, p["tiles"], p["rows"])
    assert p["cluster"] <= 8
    assert (p["cluster"] - 1) * p["cols"] < d <= p["cluster"] * p["cols"]
    assert p["smem"] <= SMEM_MAX
    if d <= 512:
        assert _two_per_sm(p["smem"])


def test_abby_decode_tiles_fill_the_card():
    """At the width-65 shapes the clusters put a CTA on (nearly) each of
    132 multiprocessors, two at most (one wave): 136 and 130 CTAs."""
    for n, d in ((520, 512), (2080, 128)):
        p = abby.launch_plan(n, d, torch.bfloat16)
        assert 0.95 * 132 <= p["tiles"] * p["cluster"] <= 2 * 132


SHEATH_ROWS = [8 * w for w in range(9, 66, 8)] + [8 * 1001]
# clusters of 8 an H100 SXM holds at once by tile rows (two CTAs an SM at
# 16 rows, one at 64), as asr_sheath_max_clusters read them there
H100_CLUSTERS = {16: 30, 64: 15}


@pytest.mark.parametrize("n", SHEATH_ROWS)
def test_sheath_launch_plan(n):
    p = sheath.launch_plan(n, 512, 256, 64, H100_CLUSTERS)
    assert _covers(n, p["tiles"], p["rows"])
    assert p["scp"] == 320 and p["dp"] == 512 and p["cluster"] == 8
    assert p["passes"] == 1
    assert p["smem"] <= SMEM_MAX
    if p["rows"] == 16:
        assert _two_per_sm(p["smem"])
    if n < 8 * 1001:
        # decode widths: every cluster runs at once (one wave)
        assert p["tiles"] <= H100_CLUSTERS[p["rows"]]
    else:
        assert p["rows"] == 64


def test_sheath_launch_plan_picks_the_smallest_tile_that_fits():
    assert sheath.launch_plan(72, 512, 256, 64, H100_CLUSTERS)["rows"] == 16
    assert sheath.launch_plan(520, 512, 256, 64, H100_CLUSTERS)["rows"] == 64
    assert sheath.launch_plan(520, 512, 256, 64)["rows"] == 64


@pytest.mark.parametrize("d,d2,m", [(256, 128, 64), (128, 64, 8),
                                    (100, 50, 30)])
def test_sheath_launch_plan_other_widths(d, d2, m):
    p = sheath.launch_plan(1000, d, d2, m)
    assert p["scp"] % 64 == 0 and m + d2 <= p["scp"] < m + d2 + 64
    assert p["dp"] % 64 == 0 and d <= p["dp"] < d + 64
    assert p["cluster"] <= 8 and p["passes"] == 1
    for rows in sheath.ROW_TILES:
        assert sheath.smem_bytes(rows, d, 1) <= SMEM_MAX


def _slices_once(p) -> bool:
    """Every 64-column slice on exactly one (CTA, pass): CTA q takes the
    slices q, q + cluster, ... (sheath.cu's sheath_rows)."""
    slices = max(p["scp"], p["dp"]) // 64
    owners = sorted(q + k * p["cluster"] for q in range(p["cluster"])
                    for k in range(p["passes"]) if q + k * p["cluster"]
                    < slices)
    return owners == list(range(slices))


# (D, D2, M) past 8 slices: D 768 and 1024 (the largest width the
# kernel takes), and 15 score slices at D 512
@pytest.mark.parametrize("d,d2,m", [(768, 384, 64), (1024, 512, 64),
                                    (512, 256, 680)])
@pytest.mark.parametrize("n", [72, 520, 8 * 1001])
def test_sheath_launch_plan_wide(d, d2, m, n):
    p = sheath.launch_plan(n, d, d2, m, H100_CLUSTERS)
    assert p["cluster"] == 8 and p["passes"] == 2
    assert _slices_once(p)
    assert _covers(n, p["tiles"], p["rows"])
    assert p["rows"] == 16       # the pass loop is built for 16 rows
    assert p["smem"] == sheath.smem_bytes(16, d, 2) <= SMEM_MAX


@pytest.mark.parametrize("d,d2,m", [(512, 256, 64), (100, 50, 30),
                                    (256, 128, 160), (90, 45, 64)])
def test_sheath_launch_plan_slices(d, d2, m):
    p = sheath.launch_plan(1000, d, d2, m)
    assert p["passes"] == 1 and _slices_once(p)


def _weights(L, d, d2, m, bf16_exact: bool, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    w = {"mkey": t(L, m, d), "vmlp1_w": t(L, d, d2),
         "adapt_w": t((L + 1) // 2, d, d)}
    if bf16_exact:
        w = {k: v.bfloat16().float() for k, v in w.items()}
    return w


def test_sheath_kernel_weights_layout():
    L, d, d2, m = 3, 96, 48, 20
    w = _weights(L, d, d2, m, False)
    kw = sheath.kernel_weights(w, L)
    scp, dp = 128, 128
    assert kw["wsc"].shape == (L, d, scp) and kw["wad"].shape == (2, d, dp)
    assert torch.equal(kw["wsc"][:, :, :m], w["mkey"].transpose(1, 2))
    assert torch.equal(kw["wsc"][:, :, m:m + d2], w["vmlp1_w"])
    assert not kw["wsc"][:, :, m + d2:].any()
    assert torch.equal(kw["wad"][:, :, :d], w["adapt_w"])
    assert not kw["wad"][:, :, d:].any()
    want = 1.0 / w["mkey"].norm(dim=-1)
    torch.testing.assert_close(kw["mkinv"], want, rtol=1e-6, atol=0)
    assert kw["split"] and kw["wsc"].dtype == torch.float32  # three products


def test_sheath_kernel_weights_cache_and_exactness():
    w = _weights(4, 64, 32, 16, True, seed=1)
    kw = sheath.kernel_weights(w, 4)
    assert not kw["split"]                   # bf16 values: two products
    assert kw["wsc"].dtype == kw["wad"].dtype == torch.bfloat16
    assert torch.equal(kw["wad"][:, :, :64].float(), w["adapt_w"])
    assert sheath.kernel_weights(w, 4) is kw
    with torch.no_grad():
        w["adapt_w"].add_(1e-3)              # an in-place update
    kw2 = sheath.kernel_weights(w, 4)
    assert kw2 is not kw and kw2["split"]
    assert torch.equal(kw2["wad"][:, :, :64], w["adapt_w"])
