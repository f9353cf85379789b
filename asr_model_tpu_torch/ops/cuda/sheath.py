"""MSheath eval layer-slot recurrence: the CUDA kernels
``csrc/sheath.cu`` and their plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/sheath_kernel.py:fused_sheath_scan``.
At encoder length the per-slot row products are bound by operations;
every slot also needs two reductions over all rows (the per-batch
masked mean for the working memory, the global masked mean of ion for
the forced skip) before the next slot can start.  The card runs it as
two launches per scan step and one at the end, which read the slot
index and the step's action from device memory, so the host never
waits.  The row kernel runs a thread-block cluster per row tile, one CTA
per 64-column slice of the slot's products, at most 8
(``launch_plan``), on the tensor cores at f32 accuracy (split TF32);
its weights come in the layout ``kernel_weights`` builds once per
weight set.  The reductions
read the validity mask directly instead of the TPU program's pooling
matrices.  All arithmetic is f32; x comes back in its own dtype.

Past the width where a 16-row tile's slot vectors and adapter outputs
fit beside the weight ring (D 8,320 at the model's D2 = D / 2) the row
kernel takes its global route (``launch_plan`` route "global", the same
2 L + 1 launches): the slot's LayerNorm and gate vectors are read from
device memory where they are used and each CTA's earlier passes' adapter
outputs go to a scratch in device memory (``fused_sheath_scan.routes``).
"""

from __future__ import annotations

import math

import torch

from asr_model_tpu_torch.models.stochastic import ste_threshold
from asr_model_tpu_torch.ops.cuda import build as B
from asr_model_tpu_torch.utils import l2norm

# the per-slot stacks, trailing singleton axes squeezed, as f32
WEIGHT_NAMES = ("ln_scale", "ln_bias", "gate_w", "gate_b", "mkey", "mval",
                "vmlp1_w", "vmlp1_b", "vmlp2_w", "vmlp2_b", "vcat_w",
                "vcat_b", "adapt_w", "adapt_b", "memgate_w", "memgate_b")


def ranvier(x, w: dict, i):
    """The r_node paths of slot ``i`` (int or 0-d int64 tensor) on rows
    x (..., D): relu(sum_e softmax(x rnet_w + rnet_b)_e (x par_w[e] +
    par_b[e]))."""
    if isinstance(i, int):
        pick = lambda t: t[i]
    else:
        pick = lambda t: t.index_select(0, i.reshape(1))[0]
    feats = torch.einsum("...d,edf->...ef", x, pick(w["par_w"])) \
        + pick(w["par_b"])
    wts = torch.softmax(x @ pick(w["rnet_w"]) + pick(w["rnet_b"]), dim=-1)
    return torch.relu(torch.einsum("...ef,...e->...f", feats, wts))


def slot_rows(x, w: dict, i, thresh: float):
    """One executed slot of the scan on rows x (..., D) in f32 (or f64):
    v_gate's ion (the memory-key and MLP scores through ``vcat``, then
    the threshold), the slot's layer norm, the adapter on even slots and
    the skip gate.  ``i`` is the slot, a Python int or a 0-d int64
    tensor on x's device (the streaming scan keeps its slot index there:
    its weights are gathered with ``index_select``, which reads no index
    back to the host).  Returns (x + gate * (adapted * ion), ion (...,
    1)).  ``w["mkey_n"]``, where given, holds the memory keys already
    normalised; ``w["par_w"]``, where given (a mini-HC MSheath), sends
    the adapted rows through ``ranvier``.  Uncounted: the plain scan and
    the model's streaming scan share it."""
    if isinstance(i, int):
        pick = lambda t, j=i: t[j]
    else:
        pick = lambda t, j=i: t.index_select(0, j.reshape(1))[0]
    d = x.shape[-1]
    keys = pick(w["mkey_n"]) if "mkey_n" in w else l2norm(pick(w["mkey"]))
    logits = l2norm(x) @ keys.t() / math.sqrt(d)
    mem_score = torch.softmax(logits, dim=-1) @ pick(w["mval"])
    h = torch.nn.functional.silu(x @ pick(w["vmlp1_w"]) + pick(w["vmlp1_b"]))
    mlp_score = h @ pick(w["vmlp2_w"]) + pick(w["vmlp2_b"])
    vcat = pick(w["vcat_w"])
    x_val = mem_score * vcat[0] + mlp_score * vcat[1] + pick(w["vcat_b"])
    ion = ste_threshold(x_val, thresh)[..., None]
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    px = (x - mu) * torch.rsqrt(var + 1e-5) * pick(w["ln_scale"]) \
        + pick(w["ln_bias"])
    if isinstance(i, int):
        apx = (px @ w["adapt_w"][i // 2] + w["adapt_b"][i // 2]
               if i % 2 == 0 else px)
    else:
        a = i // 2
        apx = torch.where(i % 2 == 0, px @ pick(w["adapt_w"], a)
                          + pick(w["adapt_b"], a), px)
    if "par_w" in w:
        apx = ranvier(apx, w, i)
    g = torch.sigmoid(px @ pick(w["gate_w"]) + pick(w["gate_b"]))[..., None]
    return x + g * (apx * ion), ion


def sheath_scan_plain(x2, batch: int, valid, mem0, sampled, jump_s,
                      weights: dict, L: int, thresh: float):
    """x2 (N, D) with N = batch * C rows; valid (batch, C) bool or None;
    mem0 (D,); sampled: the caller's argmax action; jump_s (3,);
    weights: ``WEIGHT_NAMES`` in f32.  Returns (x (N, D) in x2's dtype,
    actions (L,) int32, jstat (3,) int32)."""
    sheath_scan_plain.calls += 1
    w = weights
    n, d = x2.shape
    c = n // batch
    ct = torch.promote_types(x2.dtype, torch.float32)
    x0 = x2.to(ct)
    x = x0
    m = (torch.ones(batch, c, device=x2.device, dtype=ct) if valid is None
         else valid.to(ct))
    n_b = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    n_all = max(float(m.sum()), 1.0)
    mem_w = mem0.to(ct).reshape(1, d).expand(batch, d)
    sampled = int(sampled)
    i, actions, jstat = 0, [], [0, 0, 0]
    for _step in range(L):
        if i >= L:
            actions.append(0)
            continue
        x_new, ion = slot_rows(x, w, i, thresh)
        mem = (x_new.reshape(batch, c, d) * m[..., None]).sum(dim=1) / n_b
        mem_v = torch.sigmoid(mem @ w["memgate_w"] + w["memgate_b"])[:, None]
        mem_w = mem_v * mem_w + (1.0 - mem_v) * mem
        potential = float((ion.reshape(batch, c) * m).sum()) / n_all
        last = i >= L - 1
        action = 0 if last else (1 if potential < 0.1 else sampled)
        if action > 0:
            jw = float(jump_s[min(max(action - 1, 0), 2)])
            rows = mem_w.repeat_interleave(c, dim=0)
            x_new = x_new + (jw * x0 + (1.0 - jw) * rows)
            i = min(i + action + 1, L)
        else:
            i += 1
        x = x_new
        actions.append(action)
        jstat[action] += batch
    return (x.to(x2.dtype),
            torch.tensor(actions, dtype=torch.int32, device=x2.device),
            torch.tensor(jstat, dtype=torch.int32, device=x2.device))


sheath_scan_plain.calls = 0


MAX_CLUSTER = 8          # CTAs of a cluster (portable size)
MEM_GROUP = 64           # batch rows a pass of the memory EMA (SH_MEM_GROUP)
WIDE_D = 2048            # past it the rows stay in the f32 state (SH_WIDE_D)
ROW_TILES = (16, 64)
SMEM_MAX = 232448        # dynamic shared memory a block may use (H100)
_MAX_CLUSTERS: dict = {}  # (device, rows, d, cluster) -> at once


def smem_bytes(rows: int, d: int, passes: int) -> int:
    """Dynamic shared memory of a row-kernel CTA (``sh_smem_bytes``): the
    x tile (none past WIDE_D: the rows stay in the f32 state), three slot
    vectors, a 3-stage ring of two (32, 72) weight chunks, 5 + 4 * 8
    values a row, two a score column, and the adapter outputs of the
    passes before the last."""
    lda = -(-d // 32) * 32 + 4
    held = 0 if d > WIDE_D else rows
    return 4 * ((held + 3) * lda + 3 * 2 * 32 * 72 + 37 * rows + 128
                + (passes - 1) * rows * 72)


def smem_bytes_global(rows: int) -> int:
    """The global route's shared memory (``sh_smem_bytes_gl``): the ring
    and the per-row values alone."""
    return 4 * (3 * 2 * 32 * 72 + 37 * rows + 128)


def launch_plan(n: int, d: int, d2: int, m_keys: int,
                max_clusters: dict | None = None, batch: int = 1) -> dict:
    """The row kernel's launch for n rows: score columns (M + D2) and
    adapter columns (D) padded to 64-column slices, a cluster of one CTA
    a slice (at most 8) per row tile of 16 rows when the clusters all run
    at once (``max_clusters``: rows -> clusters the card holds together;
    none given: 64 rows), else 64 (each CTA streams its slices of the
    weights once per tile, so fewer, taller tiles stream less).  Past 8
    slices each CTA takes every 8th slice, one pass each, on 16-row
    tiles.  The memory kernel runs a block per (batch row, 32 channels)
    and takes the EMA in the last block MEM_GROUP batch rows a pass.
    Where the 16-row tile's shared memory passes a block's (wide rows
    only), the global route: ``route`` "global", the ring alone in shared
    memory and ``aog_bytes`` of adapter outputs in device memory."""
    scp = 64 * -(-(m_keys + d2) // 64)
    dp = 64 * -(-d // 64)
    slices = max(scp, dp) // 64
    cluster = min(slices, MAX_CLUSTER)
    passes = -(-slices // MAX_CLUSTER)
    rows = ROW_TILES[0] if passes > 1 else ROW_TILES[-1]
    for r in ROW_TILES:
        if (passes == 1 and max_clusters is not None
                and -(-n // r) <= max_clusters[r]):
            rows = r
            break
    plan = dict(scp=scp, dp=dp, cluster=cluster, passes=passes, rows=rows,
                wide=d > WIDE_D, tiles=-(-n // rows),
                smem=smem_bytes(rows, d, passes),
                mem_blocks=batch * -(-d // 32),
                mem_groups=-(-batch // MEM_GROUP))
    if d > WIDE_D and plan["smem"] > SMEM_MAX:
        plan.update(route="global", smem=smem_bytes_global(rows),
                    aog_bytes=4 * plan["tiles"] * cluster * (passes - 1)
                    * rows * 72)
    return plan


def max_clusters_on(dev, d: int, cluster: int) -> dict:
    """Clusters of the one-pass row kernel the card runs at once, by tile
    rows."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = {}
    for r in ROW_TILES:
        key = (idx, r, d, cluster)
        if key not in _MAX_CLUSTERS:
            with torch.cuda.device(idx):
                got = B.function("asr_sheath_max_clusters",
                                 [B.I, B.I, B.I])(r, d, cluster)
            if got < 0:
                B.check(-got, "asr_sheath_max_clusters")
            _MAX_CLUSTERS[key] = got
        out[r] = _MAX_CLUSTERS[key]
    return out


_PREP: dict = {}         # the kernel's weight layouts, by weight set
_PREP_KEEP = 8


def _bf16_exact(t) -> bool:
    """Every value keeps its low 16 bits zero (exact in bf16)."""
    return bool(((t.contiguous().view(torch.int32) & 0xFFFF) == 0).all())


def kernel_weights(weights: dict, L: int) -> dict:
    """The layout the row kernel streams, built once per weight set and
    cached (keyed by the source tensors and their versions): ``wsc`` (L,
    D, SCP) = [mkey^T | vmlp1_w | 0], ``wad`` ((L + 1) / 2, D, DP) =
    [adapt_w | 0], ``mkinv`` (L, M) = 1 / max(||mkey[m]||, 1e-12), and
    ``split``.  When every product weight is exact in bf16 (as the bf16
    model's upcast weights are) wsc and wad are bf16, half the bytes to
    stream, exact TF32 values: two TF32 products give f32 accuracy
    (``split`` False); else they stay f32 and are split too: three."""
    src = (weights["mkey"], weights["vmlp1_w"], weights["adapt_w"])
    key = tuple((id(t), t._version) for t in src)
    hit = _PREP.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], src)):
        return hit[1]
    mkey, w1, aw = src
    _, m_keys, d = mkey.shape
    d2 = w1.shape[-1]
    plan = launch_plan(0, d, d2, m_keys)
    split = not all(_bf16_exact(t) for t in src)
    wt = torch.float32 if split else torch.bfloat16
    wsc = torch.zeros(L, d, plan["scp"], device=mkey.device, dtype=wt)
    wsc[:, :, :m_keys] = mkey.transpose(1, 2)
    wsc[:, :, m_keys:m_keys + d2] = w1
    wad = torch.zeros(aw.shape[0], d, plan["dp"], device=aw.device, dtype=wt)
    wad[:, :, :d] = aw
    norm = torch.sqrt(torch.sum(mkey * mkey, dim=-1))
    out = {"wsc": wsc, "wad": wad,
           "mkinv": (1.0 / torch.clamp(norm, min=1e-12)).contiguous(),
           "split": split}
    if len(_PREP) >= _PREP_KEEP:
        _PREP.pop(next(iter(_PREP)))
    _PREP[key] = (src, out)
    return out


def _launch():
    return B.function("asr_fused_sheath_scan",
                      [B.I] + [B.P] * 32 + [B.I] * 11 + [B.F, B.P])


def fused_sheath_scan(x2, batch: int, valid, mem0, sampled, jump_s,
                      weights: dict, L: int, thresh: float):
    """The MSheath eval scan over x2 (N = batch * C rows, D): the kernel
    sequence on CUDA tensors (x2 f32 or bf16; ``sampled`` a device int32
    scalar; mem0, jump_s and the weights f32; any batch; any D: past D
    2048 the rows stay in the f32 state, past about 8,300 the global
    route, ``launch_plan``), the plain version on CPU tensors.  Returns
    (x, actions (L,) int32, jstat (3,) int32)."""
    if x2.device.type == "cpu":
        return sheath_scan_plain(x2, batch, valid, mem0, sampled, jump_s,
                                 weights, L, thresh)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_sheath_scan: unsupported device {x2.device}")
    B.eval_only("fused_sheath_scan", "models/sheath.py MSheath: "
                "stochastic.eval_route()",
                lambda: (x2, mem0, jump_s, *weights.values()))
    n, d = x2.shape
    w = weights
    m_keys = w["mkey"].shape[1]
    d2 = w["vmlp1_w"].shape[-1]
    c = n // batch if batch else 0
    shapes = {"ln_scale": (L, d), "ln_bias": (L, d), "gate_w": (L, d),
              "gate_b": (L,), "mkey": (L, m_keys, d), "mval": (L, m_keys),
              "vmlp1_w": (L, d, d2), "vmlp1_b": (L, d2), "vmlp2_w": (L, d2),
              "vmlp2_b": (L,), "vcat_w": (L, 2), "vcat_b": (L,),
              "adapt_w": ((L + 1) // 2, d, d), "adapt_b": ((L + 1) // 2, d),
              "memgate_w": (d,), "memgate_b": (1,)}
    f32 = [mem0, jump_s] + [w[k] for k in WEIGHT_NAMES]
    plan = launch_plan(n, d, d2, m_keys)
    ok = (x2.dim() == 2 and 1 <= batch and c * batch == n
          and d >= 1 and x2.is_contiguous() and L >= 1
          and m_keys >= 1 and plan["smem"] <= SMEM_MAX
          and -(-n // ROW_TILES[0]) <= 65535
          and all(tuple(w[k].shape) == s for k, s in shapes.items())
          and mem0.shape == (d,) and jump_s.shape == (3,)
          and all(t.dtype == torch.float32 and t.is_contiguous()
                  and t.device == x2.device for t in f32)
          and sampled.dtype == torch.int32 and sampled.numel() == 1
          and sampled.device == x2.device)
    if valid is not None:
        ok = ok and (valid.shape == (batch, c) and valid.dtype == torch.bool
                     and valid.is_contiguous()
                     and valid.device == x2.device)
    if not ok:
        raise ValueError(
            "fused_sheath_scan kernel takes contiguous (batch * C, D) x "
            "(a D whose row kernel fits a block), a (batch, C) bool mask, "
            "an int32 device "
            "scalar action and the f32 per-slot "
            f"stacks of WEIGHT_NAMES; got x {tuple(x2.shape)} {x2.dtype}, "
            f"batch {batch}, M {m_keys}, D2 {d2}")
    if plan["passes"] == 1:
        plan = launch_plan(n, d, d2, m_keys,
                           max_clusters_on(x2.device, d, plan["cluster"]))
    kw = kernel_weights(w, L)
    code = B.dtype_code(x2.dtype)
    dev = x2.device
    out = torch.empty_like(x2)
    xs = torch.empty(n, d, device=dev, dtype=torch.float32)
    actions = torch.empty(L, device=dev, dtype=torch.int32)
    jstat = torch.empty(3, device=dev, dtype=torch.int32)
    gl = plan.get("route") == "global"
    _buf, (ion, mem, mem_w, ctl, counter, jump_w, aog) = B.workspace(
        dev, [4 * n, 4 * batch * d, 4 * batch * d, 8, 4, 4,
              plan.get("aog_bytes", 0)])
    args = {k: w[k].data_ptr() for k in WEIGHT_NAMES}
    args.update(mkinv=kw["mkinv"].data_ptr(), wsc=kw["wsc"].data_ptr(),
                wad=kw["wad"].data_ptr())
    order = ("ln_scale", "ln_bias", "gate_w", "gate_b", "mkinv", "mval",
             "wsc", "vmlp1_b", "vmlp2_w", "vmlp2_b", "vcat_w", "vcat_b",
             "wad", "adapt_b", "memgate_w", "memgate_b")
    rc = _launch()(
        code, x2.data_ptr(), out.data_ptr(), B.ptr(valid), mem0.data_ptr(),
        sampled.data_ptr(), jump_s.data_ptr(), *[args[k] for k in order],
        xs.data_ptr(), ion, mem, mem_w, ctl, counter, jump_w,
        actions.data_ptr(), jstat.data_ptr(), aog if gl else None, n,
        batch, c, d, d2, m_keys, L,
        plan["scp"], plan["dp"], B.dtype_code(kw["wsc"].dtype), plan["rows"],
        float(thresh), B.stream_of(x2))
    B.check(rc, "asr_fused_sheath_scan")
    # sheath_rows and sheath_mem_ctl per step, sheath_finish
    n_l = 2 * L + 1 if n else 0
    fused_sheath_scan.launches += n_l
    if gl:
        fused_sheath_scan.routes["global"] += n_l
    return out, actions, jstat


fused_sheath_scan.launches = 0
fused_sheath_scan.routes = {"global": 0}
