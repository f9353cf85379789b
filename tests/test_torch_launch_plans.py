"""Host-side pieces of the cluster kernels, on the CPU: the tile and
cluster each wrapper launches (``launch_plan``, ``launch_plan_full``,
whose shared-memory formulas the card test
``test_launch_plans_match_kernels`` holds against the kernels' own) and
the sheath kernel's cached weight layout."""

import numpy as np
import pytest
import torch

from asr_model_tpu_torch.ops.cuda import (abby, attention, mel, mlp, router,
                                          sheath, xattn)

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


DECODE_WIDTHS = list(range(9, 66, 8))


def _tiles_once(n: int, tiles: int, rows: int) -> bool:
    """Tiles of ``rows`` from row 0 hold every one of n rows once."""
    owner = np.arange(n) // rows
    return owner.max() == tiles - 1 and \
        np.bincount(owner, minlength=tiles).sum() == n


# (B, T, Ta, D) of the full calls: the decode widths' self calls and the
# g block's cross call, the gate's longest key sets at D 512 (256) and at
# D 128 (1024), and D 1024
FULL_SHAPES = ([(8, w, w, 512) for w in DECODE_WIDTHS]
               + [(8, 65, 256, 512), (2, 33, 1024, 128), (3, 33, 47, 512),
                  (4, 20, 128, 1024)])


@pytest.mark.parametrize("b,t,ta,d", FULL_SHAPES)
def test_attn_full_launch_plan(b, t, ta, d):
    p = xattn.launch_plan_full(b, t, ta, d, torch.bfloat16)
    head = d // 128
    assert p["route"] == "tc" and p["launches"] == 2
    # launch 1: every row of x and of xa in one cluster's tile, every
    # head unit (q; k and v) on one CTA of its cluster
    assert _tiles_once(b * t, p["tiles_q"], p["rows"])
    assert _tiles_once(b * ta, p["tiles_kv"], p["rows"])
    assert p["cluster"] <= 8 and p["attend_cluster"] == head <= 8
    for units in (p["units_q"], p["units_kv"]):
        owners = sorted(u for r in range(p["cluster"])
                        for u in range(r, units, p["cluster"]))
        assert owners == list(range(units))
    # launch 2: every query row of every batch row in one tile
    assert _tiles_once(t, p["q_tiles"], p["q_rows"])
    assert p["rows_smem"] <= SMEM_MAX and p["attend_smem"] <= SMEM_MAX
    if d <= 512:
        assert _two_per_sm(p["rows_smem"])


def test_attn_full_launch_plan_routes():
    """f32, key sets past the one-pass limit and unaligned operands take
    the four CUDA-core launches."""
    tc = xattn.launch_plan_full(8, 65, 65, 512, torch.bfloat16)
    assert tc["route"] == "tc" and tc["launches"] == xattn.LAUNCHES_FULL
    for args in [(8, 65, 65, 512, torch.float32),
                 (2, 9, xattn.TC_MAX_KEYS + 1, 128, torch.bfloat16)]:
        p = xattn.launch_plan_full(*args)
        assert p["route"] == "cc" and p["launches"] == 4
    assert xattn.launch_plan_full(8, 65, 65, 512, torch.bfloat16,
                                  False)["route"] == "cc"
    # more row tiles than a grid dimension takes
    assert xattn.launch_plan_full(4096, 300, 256, 512,
                                  torch.bfloat16)["route"] == "cc"
    # the shared memory of the second launch grows with the keys, and the
    # longest key set it takes still fits
    assert xattn.attend_smem(128, 1024) <= SMEM_MAX
    assert xattn.attend_smem(512, 65) < xattn.attend_smem(512, 256)


@pytest.mark.parametrize("n", [8 * w for w in DECODE_WIDTHS] + [12, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_launch_plan(n, dtype):
    d, hid = 512, 1536
    p = mlp.launch_plan(n, d, hid, dtype)
    assert p["launches"] == 5 < 6
    assert p["tc"] == (dtype == torch.bfloat16)
    assert _tiles_once(n, p["norm"]["tiles"], p["norm"]["rows"])
    assert p["norm"]["cluster"] <= 8
    assert _tiles_once(n, p["tiles"], p["rows"])
    assert p["slices_d"] * mlp.COLS >= d and p["slices_hid"] * mlp.COLS >= hid
    # every column of every gate on one CTA, gates and cs rows in 128
    assert (p["slices_gates"] - 1) * p["gate_cols"] < d \
        <= p["slices_gates"] * p["gate_cols"]
    if p["tc"]:
        assert 3 * p["gate_cols"] + 3 <= 128
    for smem in (p["norm"]["smem"], p["gates_smem"], p["linear_smem"]):
        assert smem <= SMEM_MAX
    if p["tc"]:
        assert _two_per_sm(p["gates_smem"])
        assert _two_per_sm(p["linear_smem"])


@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_mlp_gate_columns_fill_one_tile(nt):
    sw = mlp.gate_cols(nt)
    assert sw % 8 == 0 and nt * sw + nt <= 128 < nt * (sw + 8) + nt


def test_mlp_launch_plan_ragged_widths_take_the_cuda_cores():
    assert not mlp.launch_plan(72, 100, 300, torch.bfloat16)["tc"]
    assert not mlp.launch_plan(72, 512, 1540, torch.bfloat16)["tc"]
    assert mlp.launch_plan(72, 1024, 3072, torch.bfloat16)["gates_smem"] \
        <= SMEM_MAX
    assert mlp.launch_plan(72, 512, 1536, torch.bfloat16, 4)["gate_cols"] \
        == 24


# wider rows: D 1280 and 2048 (the model's D2 = D / 2, M 64)
@pytest.mark.parametrize("d", [1280, 2048])
def test_sheath_launch_plan_d_passes(d):
    """Past 8 slices the 16-row tiles take one pass a slice group: 3 and
    4 passes, within the shared memory a block may use."""
    p = sheath.launch_plan(8 * 65, d, d // 2, 64)
    assert p["passes"] == -(-d // 64 // 8) and p["rows"] == 16
    assert p["cluster"] == 8 and p["smem"] <= SMEM_MAX
    # every 64-column slice on one (CTA, pass)
    owners = {(q, s) for s in range(p["passes"]) for q in range(8)
              if 64 * (q + 8 * s) < max(p["scp"], p["dp"])}
    assert len(owners) == max(p["scp"], p["dp"]) // 64


@pytest.mark.parametrize("batch", [8, 64, 65, 128, 1000])
def test_sheath_memory_batch_groups(batch):
    """Any batch: the memory EMA takes 64 batch rows a pass, a block per
    (batch row, 32 channels) before it."""
    p = sheath.launch_plan(batch * 9, 512, 256, 64, batch=batch)
    assert p["mem_groups"] == -(-batch // sheath.MEM_GROUP)
    assert (p["mem_groups"] - 1) * sheath.MEM_GROUP < batch \
        <= p["mem_groups"] * sheath.MEM_GROUP
    assert p["mem_blocks"] == batch * 16
    assert _covers(batch * 9, p["tiles"], p["rows"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1280, 2048])
def test_abby_launch_plan_wide(d, dtype):
    """Past D 1024: 64-column multiples of D / 8 a CTA (at most 8), W1's
    chunks through a ring of 8 (bf16), f32 rows half a tile at a time."""
    p = abby.launch_plan(520, d, dtype)
    assert p["cluster"] <= 8
    assert (p["cluster"] - 1) * p["cols"] < d <= p["cluster"] * p["cols"]
    assert p["cols"] % 64 == 0
    assert p["smem"] <= SMEM_MAX
    assert p["w_slots"] == abby.W_RING and p["f32_rows"] == 16
    assert abby.window_size(d) <= abby.MAX_TAPS


# (B, T, Tk, D, head width): the flagship's decode widths against its
# 1001 frames, the longest cache the gate admits at D 512 (4096 keys), a
# single key, D 2048, head width 256, and B = 128
CACHED_PLANS = [(8, 65, 1001, 512, 128), (8, 9, 1001, 512, 128),
                (8, 65, 4096, 512, 128), (8, 9, 1, 512, 128),
                (8, 65, 1025, 512, 128), (2, 33, 1024, 2048, 128),
                (8, 65, 1001, 512, 256), (8, 65, 4096, 512, 256),
                (128, 9, 1001, 512, 128), (128, 65, 1001, 512, 128)]


@pytest.mark.parametrize("b,t,tk,d,hd", CACHED_PLANS)
def test_attn_cached_launch_plan(b, t, tk, d, hd):
    """The key-split clusters: every key in one CTA's range, no CTA
    without keys, a cluster of at most 8, every query row in one tile,
    shared memory within a block's; the grid in one wave on 132
    multiprocessors whenever a split whose scores fit gives one (B 8),
    else the fewest CTAs a cluster whose scores fit (B 128)."""
    heads = d // hd
    p = xattn.launch_plan_cached(b, t, tk, d, torch.bfloat16, True, 132,
                                 heads)
    assert p["route"] == "tc" and p["launches"] == 2
    ns, kpc, qr = p["ns"], p["kpc"], p["qr"]
    assert 1 <= ns <= 8 and kpc % 128 == 0 and qr % 16 == 0 and qr <= 80
    assert ns * kpc >= tk and (ns - 1) * kpc < tk
    assert _covers(t, p["q_tiles"], qr)
    assert p["smem"] <= SMEM_MAX
    assert p["grid"] == (ns, p["q_tiles"], b * heads)
    assert p["part_bytes"] == 4 * b * p["q_tiles"] * heads * qr * d
    clusters = p["q_tiles"] * b * heads
    per_sm = lambda n: 2 if _two_per_sm(xattn.cached_smem(qr, tk, n, hd)) \
        else 1
    fit = [n for n in (1, 2, 4, 8) if n <= -(-tk // 128)
           and xattn.cached_smem(qr, tk, n, hd) <= SMEM_MAX]
    one_wave = [n for n in fit if clusters * n <= 132 * per_sm(n)]
    if one_wave:
        assert clusters * ns <= 132 * per_sm(ns)
    else:
        assert ns <= min(fit)
    assert _covers(b * t, p["tiles_rows"], p["rows"])


def test_attn_cached_launch_plan_routes():
    """f32 and misaligned operands take the three CUDA-core launches."""
    assert xattn.launch_plan_cached(8, 65, 1001, 512, torch.float32) == {
        "route": "cc", "launches": 3}
    assert xattn.launch_plan_cached(8, 65, 1001, 512, torch.bfloat16,
                                    False)["route"] == "cc"
    assert xattn.cached_kpc(1001, 8) == 128 and xattn.cached_kpc(1, 1) == 128


# ------------------------------------- the widths past the earlier limits

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2304, 3072, 4096, 8192, 16384])
def test_abby_launch_plan_past_2048(d, dtype):
    """Past D 2048 the rows stay in device memory (``wide``): the ring
    (bf16, x's chunks beside W1's) or x 512 columns at a time (f32), a
    cluster of at most 8, shared memory within a block's."""
    p = abby.launch_plan(8 * 9, d, dtype)
    assert p["wide"] and p["f32_rows"] == 0
    assert p["cluster"] <= 8
    assert (p["cluster"] - 1) * p["cols"] < d <= p["cluster"] * p["cols"]
    assert p["smem"] <= SMEM_MAX
    assert not abby.launch_plan(8 * 9, 2048, dtype)["wide"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 72, 264, 265, 520, 1056, 1057, 8008])
@pytest.mark.parametrize("d,nt", [(512, 3), (512, 12), (4096, 8),
                                  (100, 5), (16384, 12)])
def test_router_launch_plan(n, d, nt, dtype):
    """One CTA a row up to 264 rows, two rows up to 1056, then four; 4 or
    8 types a pass; the fold in a CTA's shared memory up to 200 KB, else
    a fold launch first; every row in one CTA, shared memory within a
    block's."""
    p = router.launch_plan(n, d, nt, dtype)
    assert p["rows_per_cta"] == (1 if n <= 264 else 2 if n <= 1056 else 4)
    assert _covers(n, p["ctas"], p["rows_per_cta"])
    assert p["ntc"] == (4 if nt <= 4 else 8)
    es = torch.empty((), dtype=dtype).element_size()
    assert p["fold_in_smem"] == (2 * nt * d * es <= router.FOLD_SMEM_MAX)
    assert p["launches"] == (1 if p["fold_in_smem"] else 2)
    assert p["smem"] <= SMEM_MAX
    per = -(-d // (16 // es)) / (32 * 4 // p["rows_per_cta"])
    assert p["vpl"] == 0 or per <= p["vpl"]
    assert router.supports(d, nt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4, 72, 132, 133, 520, 8008, 20000])
@pytest.mark.parametrize("d", [100, 512, 4608, 8192, 65536])
def test_abby_tail_launch_plan(n, d, dtype):
    """About one CTA an SM (at most 32 rows a CTA), every row in one CTA,
    the rows in shared memory up to 96 KB a CTA, else read from L2."""
    p = abby.tail_launch_plan(n, d, dtype)
    rpc = p["rows_per_cta"]
    assert 1 <= rpc <= abby.TAIL_MAX_RPC
    assert _covers(n, p["ctas"], rpc)
    assert p["ctas"] <= 132 or rpc == abby.TAIL_MAX_RPC
    es = torch.empty((), dtype=dtype).element_size()
    assert p["rows_in_smem"] == (rpc * d * es <= abby.TAIL_SMEM_MAX)
    assert p["smem"] <= SMEM_MAX and p["launches"] == 1


# (D, heads): head widths 384 and 512, and D 4096 with 32 heads of 128,
# take the wide route; the flagship and head width 256 do not
@pytest.mark.parametrize("d,heads,route", [(1536, 4, "wide"),
                                           (2048, 4, "wide"),
                                           (4096, 32, "wide"),
                                           (1024, 1, "wide"),
                                           (512, 4, "tc"), (512, 2, "tc"),
                                           (2048, 16, "tc")])
def test_attn_launch_plans_wide_route(d, heads, route):
    """The whole calls past the two-launch routes' widths: five launches
    a cached call, eight a full one, two more with a key split, in
    either dtype."""
    for dtype in (torch.bfloat16, torch.float32):
        c = xattn.launch_plan_cached(8, 9, 512, d, dtype, True, 132, heads)
        f = xattn.launch_plan_full(8, 9, 9, d, dtype, True, heads)
        if route == "wide":
            for p, base in ((c, xattn.LAUNCHES_WIDE_CACHED),
                            (f, xattn.LAUNCHES_WIDE_FULL)):
                assert p["route"] == "wide"
                assert p["launches"] == base + (2 if p["splits"] > 1 else 0)
        else:
            assert c["route"] != "wide" and f["route"] != "wide"
        assert xattn.supports(d, heads)


@pytest.mark.parametrize("hd", [128, 256, 384, 512, 768, 1024])
def test_flash_routes_and_wide_smem(hd):
    """Past head width 256 both dtypes take flash_wide_kernel, whose
    shared memory stays within a block's up to 1024."""
    for dtype in (torch.bfloat16, torch.float32):
        want = "wide" if hd > 256 else "tc" if dtype == torch.bfloat16 \
            else "f32"
        assert attention.route(hd, dtype) == want
    assert attention.wide_smem(hd) <= SMEM_MAX
    assert attention.wide_smem(1040) > SMEM_MAX or attention.MAX_HD == 1024


@pytest.mark.parametrize("n_fft,n_mels,route", [
    (16, 8, "dft"), (48, 20, "dft"), (64, 40, "fft"), (400, 80, "bluestein"),
    (1024, 256, "fft"), (2048, 512, "dft"), (4095, 256, "bluestein"),
    (4096, 128, "fft"), (4097, 128, "dft"), (8192, 128, "dft")])
def test_mel_routes(n_fft, n_mels, route):
    """The mel's kernel by size: the FFT and Bluestein kernels inside 64..
    4096 and 256 mels, the direct DFT outside, 8 frames a DFT block while
    they fit in shared memory."""
    assert mel.route(n_fft, n_mels) == route
    assert mel.dft_frames(n_fft, 160) == 8
    assert mel.dft_frames(20000, 160) == 1
    assert mel.dft_frames(40000, 160) == 0


@pytest.mark.parametrize("d,hid,nt", [(2304, 6912, 3), (4096, 12288, 3),
                                      (512, 1536, 12)])
def test_mlp_launch_plan_past_2048_and_12_gates(d, hid, nt):
    """The MLP past D 2048 (the norms' rows in device memory, the
    CUDA-core gates 2048 columns of h0 at a time) and at 12 gates (8
    columns of each a tensor-core CTA)."""
    assert mlp.supports(d, nt)
    for dtype in (torch.bfloat16, torch.float32):
        p = mlp.launch_plan(8 * 9, d, hid, dtype, nt)
        assert p["norm"]["wide"] == (d > abby.STREAM_D)
        assert p["norm"]["smem"] <= SMEM_MAX
        assert p["gates_smem"] <= SMEM_MAX and p["linear_smem"] <= SMEM_MAX
        assert p["gate_cols"] >= 8
        assert nt * p["gate_cols"] + nt <= 128 or not p["tc"]


@pytest.mark.parametrize("d", [2304, 4096, 8192])
def test_sheath_launch_plan_past_2048(d):
    """Past D 2048 the row kernel holds no x tile (the rows stay in the
    f32 state): 16-row tiles, clusters of 8, every pass's adapter output
    and the slot vectors within a block's shared memory."""
    p = sheath.launch_plan(8 * 17, d, d // 2, 64)
    assert p["wide"] and p["rows"] == 16 and p["cluster"] == 8
    assert p["passes"] == -(-d // 64 // 8)
    assert p["smem"] <= SMEM_MAX
    assert p["smem"] == sheath.smem_bytes(16, d, p["passes"])
    assert not sheath.launch_plan(8 * 17, 2048, 1024, 64)["wide"]


@pytest.mark.parametrize("b,t,tk,heads,want", [
    (8, 9, 1001, 4, 8),       # 32 blocks: 8 splits of 128 keys
    (8, 9, 40, 4, 3),         # no split without keys: 3 of 16
    (8, 65, 1001, 32, 1),     # 1280 blocks fill the card
    (1, 1, 1, 1, 1), (2, 9, 1001, 4, 8)])
def test_attn_wide_key_splits(b, t, tk, heads, want):
    """The wide route's attention splits the keys where its blocks would
    not fill 132 SMs: at most 8 splits, every split with keys."""
    ns = xattn.wide_splits(b, t, tk, heads, 132)
    assert ns == want
    kps = -(-(-(-tk // ns)) // 16) * 16
    assert (ns - 1) * kps < tk <= ns * kps


# -------------------------- the routes past the shared-memory plans

def test_flash_plan_past_head_width_1024():
    """Past hd 1024 the global route's three launches and its score
    matrix; at 1024 the wide kernel's one launch, as before."""
    for dtype in (torch.float32, torch.bfloat16):
        p = attention.launch_plan(8, 4, 1001, 1001, 1024, dtype)
        assert p == {"route": "wide", "launches": 1, "splits": 1}
        p = attention.launch_plan(8, 1, 1001, 1001, 1026, dtype)
        assert p["route"] == "global" and p["launches"] == 3
        assert p["splits"] == 1 and p["scores_bytes"] == 4 * 8 * 1001 * 1001
    assert attention.launch_plan(8, 4, 65, 1001, 128, torch.bfloat16)[
        "splits"] == attention.splits(32, 65, 1001, 132, 128)


@pytest.mark.parametrize("dtype,limit", [(torch.bfloat16, 59392),
                                         (torch.float32, 92160)])
def test_abby_plan_past_the_cluster_plan(dtype, limit):
    """The last multiple of 128 whose staged slices fit keeps the cluster
    plan; the next takes the global route's three launches."""
    below = abby.launch_plan(6, limit, dtype)
    assert "route" not in below and below["smem"] <= SMEM_MAX
    assert below["cluster"] <= 8 and not abby.is_global(limit, dtype)
    p = abby.launch_plan(6, limit + 128, dtype)
    assert p["route"] == "global" and p["launches"] == 3
    assert p["cluster_smem"] > SMEM_MAX and abby.is_global(limit + 128, dtype)
    es = torch.empty((), dtype=dtype).element_size()
    assert p["hidden_bytes"] == 6 * (limit + 128) * es
    assert p["route_bytes"] == 4 * 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_plan_past_12_types_and_the_norms(dtype):
    """13 types and more: one launch more (the types), the gates on the
    CUDA cores; 12 keep the five launches.  Past the norms' cluster plan
    each norm is three launches."""
    p12 = mlp.launch_plan(72, 512, 512 * 12, dtype, 12)
    assert p12["launches"] == 5 and p12["types"] != "many"
    for nt in (13, 16, 40):
        p = mlp.launch_plan(72, 512, 512 * nt, dtype, nt)
        assert p["launches"] == 6 and p["types"] == "many"
        assert p["gate_cols"] == mlp.COLS and p["gates_smem"] <= SMEM_MAX
        assert mlp.supports(512, nt)
    assert mlp.launch_plan(6, 59392, 3 * 59392, torch.bfloat16)[
        "launches"] == 5
    p = mlp.launch_plan(6, 59520, 3 * 59520, torch.bfloat16)
    assert p["launches"] == 9 and p["norm"]["route"] == "global"
    assert mlp.launch_plan(6, 59520, 3 * 59520, torch.bfloat16, 13)[
        "launches"] == 10


def test_sheath_plan_past_the_row_kernels_shared_memory():
    """D 8320 (the model's D2 = D / 2, M 64) keeps the row kernel's
    plan; D 8448, the next multiple of 128, takes the global route: the
    ring alone in shared memory, each CTA's earlier passes' adapter
    outputs in device memory."""
    below = sheath.launch_plan(118, 8320, 4160, 64)
    assert "route" not in below
    assert below["smem"] == sheath.smem_bytes(16, 8320, below["passes"]) \
        <= SMEM_MAX
    p = sheath.launch_plan(118, 8448, 4224, 64)
    assert p["route"] == "global" and p["rows"] == 16 and p["cluster"] == 8
    assert sheath.smem_bytes(16, 8448, p["passes"]) > SMEM_MAX
    assert p["smem"] == sheath.smem_bytes_global(16) <= SMEM_MAX
    assert p["aog_bytes"] == 4 * p["tiles"] * 8 * (p["passes"] - 1) * 16 * 72
    assert _covers(118, p["tiles"], p["rows"])


def test_attn_calls_plan_past_the_wide_route():
    """Head widths past 1024 take the global attention (two launches
    more, no key split); a D or head width past AbbyNormal's cluster
    plan two more a norm call; at 1024 the wide route as before."""
    for dtype in (torch.float32, torch.bfloat16):
        c = xattn.launch_plan_cached(8, 9, 512, 1024, dtype, True, 132, 1)
        f = xattn.launch_plan_full(8, 9, 9, 1024, dtype, True, 1)
        assert c["route"] == f["route"] == "wide"
        c = xattn.launch_plan_cached(8, 9, 512, 2048, dtype, True, 132, 1)
        f = xattn.launch_plan_full(8, 9, 9, 2048, dtype, True, 1)
        assert c["route"] == f["route"] == "global"
        assert c["attention"] == f["attention"] == "global"
        assert (c["launches"], f["launches"]) == (7, 10)
        assert c["splits"] == f["splits"] == 1
        assert c["scores_bytes"] == 4 * 8 * 9 * 512
        assert xattn.supports(2048, 1) and xattn.supports(2176, 2)
    c = xattn.launch_plan_cached(1, 6, 35, 59520, torch.bfloat16, True, 132,
                                 93)
    f = xattn.launch_plan_full(1, 2, 2, 59520, torch.bfloat16, True, 93)
    assert c["route"] == f["route"] == "global"
    assert c["attention"] == f["attention"] == "wide"
    assert (c["launches"], f["launches"]) == (7, 12)
    assert xattn.launch_plan_cached(1, 6, 35, 59392, torch.bfloat16, True,
                                    132, 58)["route"] == "wide"


def test_mel_plan_past_one_frame_in_shared_memory():
    """n_fft 38,740 keeps the direct DFT's one launch (one frame a
    block); 38,742 takes the global route's two."""
    p = mel.launch_plan(1, 48000, 38740, 160, 128)
    assert p == {"route": "dft", "launches": 1, "frames": 301}
    assert mel.dft_frames(38740, 160) == 1
    p = mel.launch_plan(1, 48000, 38742, 160, 128)
    assert p["route"] == "global" and p["launches"] == 2
    assert p["frames"] == 301 and p["power_bytes"] == 4 * 301 * 19372
    assert mel.launch_plan(8, 160000, 1024, 160, 128) == {
        "route": "fft", "launches": 1, "frames": 1001}
