"""Whole attention calls of the decode step: the CUDA kernels
``csrc/xattn.cu`` (and ``csrc/xattn_wide.cu``) and their plain PyTorch
versions.

Replaces ``asr_model_tpu/ops/pallas/xattn_kernel.py:fused_attn_cached``
(cross-attention against a precomputed, processed K/V cache) and
``fused_attn_full`` (the kv side computed from ``xa`` in the call; xa = x
for self-attention).  A call is q_norm -> q_proj -> * hd^-0.25 -> rotary
(lane pairs, magnitude ||x row||) -> per-head head_norm, the same for k
from xa in a full call (v raw), masked softmax attention (masked logits
-1e30, causal mask aligned bottom-right), out_proj.  Products take
operands rounded to the storage type with f32 sums, rounded where the
Pallas kernel rounds.  Head width 128 or 256, D = hd * heads <= 2048.

A cached call in bf16 is two launches on the tensor cores
(``launch_plan_cached``): the q side as a full call's first launch (a
cluster per 32-row tile norms its rows once and projects, rotates and
head-norms whole heads), then a cluster of ``ns`` CTAs per (query tile,
head, batch row) that splits the cached keys, takes the exact softmax in
one pass (row maxima and sums exchanged over distributed shared memory),
sums the PV partials in rank order and takes the head's share of
out_proj; the last cluster per (query tile, batch row) adds the heads'
shares.  f32 takes three CUDA-core launches (norm router, q side +
attention per (16-row tile, head, batch), out_proj).  A full call in
bf16 with at most 1024 keys (every call the model's gate admits) is two
launches on the tensor cores (``launch_plan_full``): the rows launch for
x and xa, then a cluster of one CTA a head per 16-query tile takes the
exact softmax in one pass, the PV product and out_proj.  Other full
calls (f32, longer key sets) take four CUDA-core launches.

Other widths -- head widths other than 128 and 256 (up to 1024), rows
past 2048 channels -- take the wide route (``csrc/xattn_wide.cu``) in either
dtype (route "wide"): the norms through ``fused_abby``'s kernel, a CUDA-core
projection with the rotary in its epilogue, a two-pass softmax attention
a (16-query tile, head, batch row; keys split over up to 8 blocks where
those do not fill the card), out_proj; five launches a cached call, eight
a full one, two more with a key split (``launch_plan_cached``).

Past the wide route's widths the same chain takes global pieces (route
"global"): head widths past 1024 take the attention as three launches
through an f32 score matrix (``csrc/global_attn.cuh``, flash's global
route), and a D (or head width) past AbbyNormal's cluster plan takes that
norm as its global route's three launches (``abby.is_global``);
``fused_attn_*.routes["global"]`` counts their launches.
"""

from __future__ import annotations

import math

import torch

from asr_model_tpu_torch.ops.cuda import build as B
from asr_model_tpu_torch.ops.cuda import abby
from asr_model_tpu_torch.ops.cuda.attention import _counters, _sm_count
from asr_model_tpu_torch.ops.cuda.abby import abby_values, linear_t

NEG_INF = -1e30
# the head widths and rows of xattn.cu's two routes; other widths take
# the wide route (head widths up to WIDE_MAX_HD)
HEAD_DIMS, MAX_D = (128, 256), 2048
WIDE_MAX_HD = 1024
LAUNCHES_WIDE_CACHED, LAUNCHES_WIDE_FULL = 5, 8   # two more with a split
WIDE_QT, WIDE_KT, WIDE_MAX_SPLIT = 16, 16, 8      # the wide attention's tiles
# a cached call's launches: the tensor-core route, the CUDA-core one
LAUNCHES_CACHED, LAUNCHES_CACHED_CC = 2, 3
# a full call's launches: the tensor-core route, the CUDA-core one
LAUNCHES_FULL, LAUNCHES_FULL_CC = 2, 4
TC_MAX_KEYS = 1024               # csrc/xattn.cu XA_TC_MAX_KEYS
ROWS, Q_ROWS = 32, 16            # the tiles of the two launches
STAGES = 3                       # their k chunks in flight (XA_ST)
# the cached call's second launch (csrc/xattn.cu XC_*): keys a ring
# block, query rows a CTA at most
C_KB, C_MAXQR = 128, 80
MAX_CLUSTER = 8
SMEM_MAX = 232448                # dynamic shared memory a block may use
SMEM_SM = 233472                 # shared memory of a multiprocessor
NORM_KEYS = ("n_w1", "n_b1", "n_w2", "n_b2")
PROJ_KEYS = ("proj_w", "proj_b")


# ---------------------------------------------------------- plain versions

def _rotate(q, cond, freqs, head: int):
    """Signal-adaptive rotary on (B, T, D) values: the pair (a, b) at
    channels (2i, 2i + 1) becomes (a m cos - b m sin, b m cos + a m sin),
    m = ||cond row|| (0 for a zero row), angle t * freqs[i % (hd / 2)]."""
    b_, t_, d = q.shape
    ft = q.dtype
    t = torch.arange(t_, dtype=ft, device=q.device)
    ang = t[:, None] * freqs.to(ft).repeat(head)[None]     # (T, D / 2)
    sq = (cond * cond).sum(dim=-1, keepdim=True)
    m = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq,
                                                   torch.ones_like(sq))),
                    torch.zeros_like(sq))
    mc, ms = m * torch.cos(ang), m * torch.sin(ang)
    pairs = q.reshape(b_, t_, d // 2, 2)
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * mc + b * (-ms), b * mc + a * ms],
                       dim=-1).reshape(b_, t_, d)


def _heads_norm(q, wh, head: int, size_h: int, akw, dt):
    """Per-head AbbyNormal of (B, T, D) values (rounded to dt first, as
    the head norm's input) -> (B, H, T, hd), rounded."""
    b_, t_, d = q.shape
    hd = d // head
    qh = q.to(dt).reshape(-1, hd)
    out = abby_values(qh, *(wh[n] for n in NORM_KEYS), size_h, *akw)
    return out.to(dt).to(q.dtype).reshape(b_, t_, head, hd).transpose(1, 2)


def _side(x, w, freqs, head: int, size_d: int, akw, ct, kv: bool):
    """Norm -> projection; returns (k or q scaled and rotated, v or None)
    as (B, T, D) values."""
    b_, t_, d = x.shape
    n = abby_values(x.reshape(-1, d), *(w[k] for k in NORM_KEYS), size_d,
                    *akw).to(x.dtype).to(ct)
    p = linear_t(n, w["proj_w"], ct) + w["proj_b"].to(ct)
    p = p.reshape(b_, t_, -1)
    v = p[..., d:] if kv else None
    qk = p[..., :d] * (d // head) ** -0.25
    return _rotate(qk, x.to(ct), freqs, head), v


def _attend_out(qhn, khn, v, kv_valid, causal: bool, wo, dt, ct):
    """Masked softmax attention of (B, H, T, hd) heads (weights rounded
    to dt before the V product), then out_proj; returns (B, T, D) in dt."""
    hd = qhn.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", qhn, khn) * (1.0 / hd ** 0.5)
    tq, tk = logits.shape[-2:]
    if causal:
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=logits.device).tril(tk - tq)
        logits = torch.where(cm[None, None], logits, NEG_INF)
    if kv_valid is not None:
        logits = torch.where(kv_valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(dt).to(ct)
    a = torch.einsum("bhqk,bhkd->bhqd", w, v.to(dt).to(ct))
    b_, h, t_, _ = a.shape
    o = a.transpose(1, 2).reshape(b_, t_, h * hd).to(dt).to(ct)
    return (linear_t(o, wo["proj_w"], ct) + wo["proj_b"].to(ct)).to(dt)


def attn_cached_plain(x, kn, v, kv_valid, freqs, wq, wh, wo, head: int,
                      size_d: int, size_h: int, alpha: float, k: float,
                      beta: float):
    """x (B, T, D); kn, v (B, H, Tk, hd) the processed cache; kv_valid
    (B, Tk) bool or None; freqs (hd / 2,) the (non-causal) ladder; wq =
    q_norm (n_w1, n_b1, n_w2, n_b2) + q_proj (proj_w, proj_b), wh =
    head_norm, wo = out_proj, torch (out, in) layouts."""
    attn_cached_plain.calls += 1
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    akw = (alpha, k, beta)
    q, _ = _side(x, wq, freqs, head, size_d, akw, ct, kv=False)
    qhn = _heads_norm(q, wh, head, size_h, akw, dt)
    return _attend_out(qhn, kn.to(dt).to(ct), v, kv_valid, False, wo, dt,
                       ct)


attn_cached_plain.calls = 0


def attn_full_plain(x, xa, kv_valid, freqs, wq, wkv, wh, wo, head: int,
                    size_d: int, size_h: int, alpha: float, k: float,
                    beta: float, causal: bool):
    """As ``attn_cached_plain`` with the kv side from xa (B, Ta, D): wkv =
    kv_norm + kv_proj (proj_w (2D, D)); freqs is the ladder of both
    sides (``causal`` picks it)."""
    attn_full_plain.calls += 1
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    akw = (alpha, k, beta)
    q, _ = _side(x, wq, freqs, head, size_d, akw, ct, kv=False)
    kk, v = _side(xa.to(dt), wkv, freqs, head, size_d, akw, ct, kv=True)
    qhn = _heads_norm(q, wh, head, size_h, akw, dt)
    khn = _heads_norm(kk, wh, head, size_h, akw, dt)
    b_, ta, d = v.shape
    vh = v.reshape(b_, ta, head, d // head).transpose(1, 2)
    return _attend_out(qhn, khn, vh, kv_valid, causal, wo, dt, ct)


attn_full_plain.calls = 0


# ---------------------------------------------------------------- kernels

def _weights(wq, wkv, wh, wo):
    """The 18 weights in the kernels' order (csrc/xattn.cuh XaWeight)."""
    out = [wq[n] for n in NORM_KEYS + PROJ_KEYS]
    out += ([wkv[n] for n in NORM_KEYS + PROJ_KEYS] if wkv is not None
            else [None] * 6)
    out += [wh[n] for n in NORM_KEYS] + [wo[n] for n in PROJ_KEYS]
    return out


def wide_splits(b: int, t: int, tk: int, head: int, sms: int = 132) -> int:
    """Key splits of the wide route's attention (``xw_attend``): 1 where
    its (16-query tile, head, batch row) blocks fill the card's ``sms``,
    else enough for two blocks an SM, at most 8, none without keys."""
    blocks = -(-t // WIDE_QT) * head * b
    if blocks >= sms:
        return 1
    ns = min(WIDE_MAX_SPLIT, -(-2 * sms // blocks), -(-tk // WIDE_KT),
             max(1, 65535 // max(b, 1)))
    kps = -(-(-(-tk // ns)) // WIDE_KT) * WIDE_KT
    return -(-tk // kps)


def _wide_plan(b, t, tk, d, head, dtype, sms, launches, norms):
    """The wide route's plan, or the global route's where the head width
    passes WIDE_MAX_HD (the attention: 3 launches, no key split) or a
    norm passes AbbyNormal's cluster plan (each such norm call: 3
    launches); ``norms`` counts the calls of the D-wide and the head
    norms."""
    hd = d // head
    gl_attn = hd > WIDE_MAX_HD
    extra = 2 * (norms[0] * abby.is_global(d, dtype)
                 + norms[1] * abby.is_global(hd, dtype))
    if gl_attn or extra:
        return dict(route="global", splits=1,
                    attention="global" if gl_attn else "wide",
                    launches=launches + extra + (2 if gl_attn else 0),
                    scores_bytes=4 * b * head * t * tk if gl_attn else 0)
    ns = wide_splits(b, t, tk, head, sms)
    return dict(route="wide", splits=ns,
                launches=launches + (2 if ns > 1 else 0))


def narrow(d: int, head: int) -> bool:
    """Widths of ``csrc/xattn.cu``'s routes: D = hd * heads <= MAX_D with
    head width hd in HEAD_DIMS (the rest take the wide route)."""
    return d // head in HEAD_DIMS and d <= MAX_D


def supports(d: int, head: int) -> bool:
    """The widths the kernels take: D = hd * heads a multiple of 64 and
    an even head width (past WIDE_MAX_HD, or past AbbyNormal's cluster
    plan, the global route)."""
    return (head >= 1 and d % head == 0 and d % 64 == 0
            and (d // head) % 2 == 0)


def _check(name, x, tensors, head, weights, kv_valid, tk):
    b_, t_, d = x.shape
    ws = [w for w in weights if w is not None]
    ok = (x.dim() == 3 and supports(d, head)
          and all(t.dtype == x.dtype and t.is_contiguous()
                  and t.device == x.device for t in [x, *tensors, *ws]))
    if kv_valid is not None:
        ok = ok and (kv_valid.shape == (b_, tk)
                     and kv_valid.dtype == torch.bool
                     and kv_valid.is_contiguous()
                     and kv_valid.device == x.device)
    if not ok:
        raise ValueError(
            f"{name} kernels take contiguous (B, T, D = hd * heads, a "
            "multiple of 64, hd even) "
            "inputs and torch-layout weights of one dtype on one device and "
            f"a (B, Tk) bool mask; got x {tuple(x.shape)} {x.dtype}, "
            f"{head} heads")


def _cuda_freqs(x, freqs):
    """The ladder as the kernels read it (f32 on x's device); raises for
    a device that is neither the CPU nor CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"fused attention: unsupported device {x.device}")
    return freqs.to(device=x.device, dtype=torch.float32).contiguous()


def _wide_call(full, x, xa, kn, v, kv_valid, fr, ws, head, size_d, size_h,
               alpha, k, beta, causal, plan):
    """The wide or global route (``asr_fused_attn_wide``) with the plan's
    key splits: out (B, T, D)."""
    b_, t_, d = x.shape
    tk = (xa if full else kn).shape[1 if full else 2]
    es = x.element_size()
    hd = d // head
    ns = plan["splits"]
    rows = b_ * max(t_, tk if full else 0)
    gnorm = plan["route"] == "global" and (abby.is_global(d, x.dtype)
                                           or abby.is_global(hd, x.dtype))
    sizes = ([b_ * t_ * d * es] * 4 + [b_ * tk * d * es * full] * 4
             + ([4 * b_ * head * ns * t_ * 2, 4 * b_ * head * ns * t_ * hd]
                if ns > 1 else [0, 0])
             + [plan.get("scores_bytes", 0), rows * d * es * gnorm,
                4 * rows * head * gnorm])
    work, pieces = B.workspace(x.device, sizes)
    out = torch.empty_like(x)
    fn = B.function("asr_fused_attn_wide",
                    [B.I, B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.PP, B.P, B.PP,
                     B.I, B.I, B.I, B.I, B.I, B.I, B.I, B.I, B.F, B.F, B.F,
                     B.I, B.P])
    rc = fn(B.dtype_code(x.dtype), int(full), x.data_ptr(), B.ptr(xa),
            B.ptr(kn), B.ptr(v), B.ptr(kv_valid), fr.data_ptr(),
            B.ptr_array([B.ptr(w) for w in ws]), out.data_ptr(),
            B.ptr_array([p if n else None for p, n in zip(pieces, sizes)]),
            b_, t_, tk, d, head, int(bool(causal)),
            int(size_d), int(size_h), float(alpha), float(k), float(beta),
            int(ns), B.stream_of(x))
    B.check(rc, "asr_fused_attn_wide")
    return out


def cached_kpc(tk: int, ns: int) -> int:
    """Keys a CTA of the cached call's second launch takes: its share of
    Tk in whole 128-key blocks (``csrc/xattn.cu:xc_kpc``)."""
    share = -(-tk // ns)
    return -(-share // C_KB) * C_KB


def cached_smem(qr: int, tk: int, ns: int, hd: int = 128) -> int:
    """Dynamic shared memory of the cached call's second launch
    (``csrc/xattn.cu:xc_attend_smem``): the Q tile, the K/V ring (two
    128-key slots, one where a CTA takes at most 128 keys), the score
    region (f32 scores, then the bf16 weights in place, later the pushed
    partial outputs), nineteen values a row."""
    kpc = cached_kpc(tk, ns)
    per = -(-qr // ns)
    slots = 2 if kpc > C_KB else 1
    sc = _align(max(4 * qr * (kpc + 4), 4 * ns * per * hd))
    return (_align(2 * qr * (hd + 8)) + _align(2 * slots * C_KB * (hd + 8))
            + sc + 4 * 19 * qr)


def _per_sm(smem: int) -> int:
    """CTAs of ``smem`` bytes a multiprocessor holds (two at most; the
    runtime reserves 1 KB a block)."""
    return 2 if 2 * (smem + 1024) <= SMEM_SM else 1


def launch_plan_cached(b: int, t: int, tk: int, d: int, dtype,
                       operands_ok: bool = True, sms: int = 132,
                       head: int | None = None) -> dict:
    """What ``asr_fused_attn_cached`` launches for x (b, t, d) against a
    cache of tk keys a head: the route ("tc", two tensor-core launches,
    for bf16 where ``operands_ok`` -- 16-byte aligned operands, windows of
    at most 103 taps; else "cc", three CUDA-core launches) and, for "tc",
    the query rows a CTA (``qr``: the whole width up to 80 rows, else
    64-row tiles; smaller where the scores would not fit), the CTAs a
    cluster that split the keys (``ns``, 1..8: the most that still run
    in one wave on the card's ``sms``, no more than the 128-key blocks,
    none left without keys; where none does, the fewest whose scores
    fit), the grid (ns, q_tiles, b * heads), the second launch's shared
    memory in bytes and its f32 workspace of the heads' out_proj shares.
    ``head`` defaults to heads of 128 columns."""
    head = head or d // 128
    hd = d // head
    if not narrow(d, head):
        return _wide_plan(b, t, tk, d, head, dtype, sms,
                          LAUNCHES_WIDE_CACHED, (1, 1))
    tiles_rows = -(-b * t // ROWS)
    if not (dtype == torch.bfloat16 and operands_ok and tiles_rows <= 65535
            and b * head <= 65535):
        return dict(route="cc", launches=LAUNCHES_CACHED_CC)
    want = 16 * -(-t // 16) if t <= C_MAXQR else 64
    blocks = -(-tk // C_KB)
    for qr in range(want, 0, -16):
        q_tiles = -(-t // qr)
        clusters = b * head * q_tiles
        fit = [n for n in (1, 2, 4, 8) if n <= max(1, blocks)
               and cached_smem(qr, tk, n, hd) <= SMEM_MAX]
        if not fit:
            continue
        wave = [n for n in fit
                if clusters * n <= sms * _per_sm(cached_smem(qr, tk, n, hd))]
        ns = max(wave) if wave else min(fit)
        ns = min(ns, -(-tk // cached_kpc(tk, ns)))    # no CTA without keys
        return dict(route="tc", launches=LAUNCHES_CACHED,
                    tiles_rows=tiles_rows, rows=ROWS,
                    cluster=abby.launch_plan(1, d, dtype)["cluster"],
                    units=head, rows_smem=rows_smem(d, hd), qr=qr, ns=ns,
                    kpc=cached_kpc(tk, ns), q_tiles=q_tiles,
                    grid=(ns, q_tiles, b * head),
                    smem=cached_smem(qr, tk, ns, hd),
                    part_bytes=4 * b * q_tiles * head * qr * d)
    return dict(route="cc", launches=LAUNCHES_CACHED_CC)


def fused_attn_cached(x, kn, v, kv_valid, freqs, wq, wh, wo, head: int,
                      size_d: int, size_h: int, alpha: float, k: float,
                      beta: float):
    """One cached cross-attention call (arguments as in
    ``attn_cached_plain``): the kernels on CUDA tensors (f32 or bf16),
    the plain version on CPU tensors.  Two launches in bf16
    (``launch_plan_cached``), else three."""
    if x.device.type == "cpu":
        return attn_cached_plain(x, kn, v, kv_valid, freqs, wq, wh, wo, head,
                                 size_d, size_h, alpha, k, beta)
    B.eval_only("fused_attn_cached", "models/attention.py "
                "Attention._fused_ok", lambda: (x, kn, v, *wq.values(),
                                                *wh.values(), *wo.values()))
    fr = _cuda_freqs(x, freqs)
    b_, t_, d = x.shape
    tk = kn.shape[2]
    ws = _weights(wq, None, wh, wo)
    _check("fused_attn_cached", x, (kn, v), head, ws, kv_valid, tk)
    if kn.shape != (b_, head, tk, d // head) or v.shape != kn.shape:
        raise ValueError(f"fused_attn_cached: K/V {tuple(kn.shape)} / "
                         f"{tuple(v.shape)} for x {tuple(x.shape)}")
    es = x.element_size()
    ok = (all(p % 16 == 0 for p in [x.data_ptr(), kn.data_ptr(),
                                    v.data_ptr(),
                                    *(w.data_ptr() for w in ws
                                      if w is not None)])
          and max(size_d, size_h) <= abby.MAX_TAPS)
    plan = launch_plan_cached(b_, t_, tk, d, x.dtype, ok,
                              _sm_count(x.device.index or 0), head)
    if plan["route"] in ("wide", "global"):
        out = _wide_call(False, x, None, kn, v, kv_valid, fr, ws, head,
                         size_d, size_h, alpha, k, beta, False, plan)
        n_l = plan["launches"] if b_ else 0
        fused_attn_cached.launches += n_l
        if plan["route"] == "global":
            fused_attn_cached.routes["global"] += n_l
        return out
    tc = plan["route"] == "tc"
    stream = B.stream_of(x)
    if tc:                        # normed rows, q heads, out_proj shares
        sizes = [b_ * t_ * d * es, b_ * t_ * d * es, plan["part_bytes"]]
        qr, ns = plan["qr"], plan["ns"]
        counters = _counters(x.device, stream, b_ * plan["q_tiles"])
    else:                         # router logits, -, o
        sizes = [-(-d // 64) * b_ * t_ * 12, 0, b_ * t_ * d * es]
        qr, ns, counters = 0, 0, None
    work, pieces = B.workspace(x.device, sizes)
    out = torch.empty_like(x)
    fn = B.function("asr_fused_attn_cached",
                    [B.I, B.I, B.P, B.P, B.P, B.P, B.P, B.PP, B.P, B.P, B.P,
                     B.P, B.P, B.I, B.I, B.I, B.I, B.I, B.I, B.I, B.F, B.F,
                     B.F, B.I, B.I, B.P])
    rc = fn(B.dtype_code(x.dtype), int(tc), x.data_ptr(), kn.data_ptr(),
            v.data_ptr(), B.ptr(kv_valid), fr.data_ptr(),
            B.ptr_array([B.ptr(w) for w in ws]), out.data_ptr(), *pieces,
            B.ptr(counters), b_, t_, tk, d, head, int(size_d), int(size_h),
            float(alpha), float(k), float(beta), qr, ns, stream)
    B.check(rc, "asr_fused_attn_cached")
    fused_attn_cached.launches += plan["launches"] if b_ else 0
    return out


fused_attn_cached.launches = 0
fused_attn_cached.routes = {"global": 0}


def _align(n: int) -> int:
    return -(-n // 128) * 128


def rows_smem(d: int, hd: int = 128) -> int:
    """Dynamic shared memory of the full call's first tensor-core launch
    (``csrc/xattn.cu:xa_rows_smem``): the larger of the norm's and a
    head unit's (ring, head tile, ||row||, partial logits, routes)."""
    unit = (_align(B.tc_ring_bytes(2, 4, False, False, STAGES))
            + _align(2 * ROWS * (hd + 8)) + 4 * (ROWS + 4 * ROWS * 3)
            + 4 * ROWS)
    return max(abby.launch_plan(1, d, torch.bfloat16)["smem"], unit)


def attend_smem(d: int, ta: int, hd: int = 128) -> int:
    """Dynamic shared memory of the second launch
    (``csrc/xattn.cu:xa_attend_smem``): ring, Q tile, the heads, f32
    scores and bf16 weights over the keys padded to 128."""
    tp = -(-ta // 128) * 128
    ring = max(B.tc_ring_bytes(1, 2, True, False, STAGES),
               B.tc_ring_bytes(1, 2, True, True, STAGES))
    return (_align(ring) + _align(2 * Q_ROWS * (hd + 8))
            + _align(2 * Q_ROWS * (d + 8)) + _align(4 * Q_ROWS * tp)
            + 2 * Q_ROWS * (tp + 8))


def launch_plan_full(b: int, t: int, ta: int, d: int, dtype,
                     operands_ok: bool = True,
                     head: int | None = None, sms: int = 132) -> dict:
    """What ``asr_fused_attn_full`` launches for x (b, t, d) against xa
    (b, ta, d): the route ("tc": two tensor-core launches, bf16 with at
    most TC_MAX_KEYS keys, where ``operands_ok`` -- 16-byte aligned
    operands, windows of at most 103 taps, at most 65535 row tiles; else
    "cc", four CUDA-core launches), and for "tc" the first launch's
    clusters (one a 32-row tile of x, then of xa; ``cluster`` CTAs each,
    the norm's) and the second's (one CTA a head, at most 8, per
    (16-query tile, batch row)), with their shared memory in bytes.
    ``head`` defaults to heads of 128 columns."""
    head = head or d // 128
    hd = d // head
    if not narrow(d, head):
        return _wide_plan(b, t, ta, d, head, dtype, sms, LAUNCHES_WIDE_FULL,
                          (2, 2))
    tiles = -(-b * t // ROWS) + -(-b * ta // ROWS)
    if not (dtype == torch.bfloat16 and ta <= TC_MAX_KEYS and operands_ok
            and tiles <= 65535 and b <= 65535):
        return dict(route="cc", launches=LAUNCHES_FULL_CC)
    return dict(route="tc", launches=LAUNCHES_FULL,
                tiles_q=-(-b * t // ROWS), tiles_kv=-(-b * ta // ROWS),
                rows=ROWS, cluster=abby.launch_plan(1, d, dtype)["cluster"],
                units_q=head, units_kv=2 * head,
                rows_smem=rows_smem(d, hd),
                q_tiles=-(-t // Q_ROWS), q_rows=Q_ROWS,
                attend_cluster=min(head, MAX_CLUSTER),
                attend_smem=attend_smem(d, ta, hd))


def fused_attn_full(x, xa, kv_valid, freqs, wq, wkv, wh, wo, head: int,
                    size_d: int, size_h: int, alpha: float, k: float,
                    beta: float, causal: bool):
    """One full attention call (arguments as in ``attn_full_plain``): the
    kernels on CUDA tensors (f32 or bf16), the plain version on CPU
    tensors.  Two launches in bf16 (``launch_plan_full``), else four."""
    if x.device.type == "cpu":
        return attn_full_plain(x, xa, kv_valid, freqs, wq, wkv, wh, wo, head,
                               size_d, size_h, alpha, k, beta, causal)
    B.eval_only("fused_attn_full", "models/attention.py Attention._fused_ok",
                lambda: (x, xa, *wq.values(), *wkv.values(), *wh.values(),
                         *wo.values()))
    fr = _cuda_freqs(x, freqs)
    b_, t_, d = x.shape
    ta = xa.shape[1]
    ws = _weights(wq, wkv, wh, wo)
    _check("fused_attn_full", x, (xa,), head, ws, kv_valid, ta)
    if xa.shape != (b_, ta, d):
        raise ValueError(f"fused_attn_full: xa {tuple(xa.shape)} for x "
                         f"{tuple(x.shape)}")
    es = x.element_size()
    ok = (all(p % 16 == 0 for p in [x.data_ptr(), xa.data_ptr(),
                                    *(w.data_ptr() for w in ws)])
          and max(size_d, size_h) <= abby.MAX_TAPS)
    plan = launch_plan_full(b_, t_, ta, d, x.dtype, ok, head,
                            _sm_count(x.device.index or 0))
    if plan["route"] in ("wide", "global"):
        out = _wide_call(True, x, xa, None, None, kv_valid, fr, ws, head,
                         size_d, size_h, alpha, k, beta, causal, plan)
        n_l = plan["launches"] if b_ else 0
        fused_attn_full.launches += n_l
        if plan["route"] == "global":
            fused_attn_full.routes["global"] += n_l
        return out
    tc = plan["route"] == "tc"
    if tc:                        # normed rows, then q, k, v heads
        sizes = [b_ * t_ * d * es, b_ * ta * d * es, b_ * t_ * d * es,
                 b_ * ta * d * es, b_ * ta * d * es]
    else:                         # router logits, k, v heads, o
        slices = -(-d // 64)
        sizes = [slices * b_ * t_ * 12, slices * b_ * ta * 12,
                 b_ * ta * d * es, b_ * ta * d * es, b_ * t_ * d * es]
    work, pieces = B.workspace(x.device, sizes)
    out = torch.empty_like(x)
    fn = B.function("asr_fused_attn_full",
                    [B.I, B.I, B.P, B.P, B.P, B.P, B.PP, B.P, B.P, B.P, B.P,
                     B.P, B.P, B.I, B.I, B.I, B.I, B.I, B.I, B.I, B.I, B.F,
                     B.F, B.F, B.P])
    rc = fn(B.dtype_code(x.dtype), int(tc), x.data_ptr(), xa.data_ptr(),
            B.ptr(kv_valid), fr.data_ptr(),
            B.ptr_array([w.data_ptr() for w in ws]), out.data_ptr(), *pieces,
            b_, t_, ta, d, head, int(bool(causal)), int(size_d),
            int(size_h), float(alpha), float(k), float(beta), B.stream_of(x))
    B.check(rc, "asr_fused_attn_full")
    fused_attn_full.launches += plan["launches"] if b_ else 0
    return out


fused_attn_full.launches = 0
fused_attn_full.routes = {"global": 0}
