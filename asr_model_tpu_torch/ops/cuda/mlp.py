"""The residual-MLP tail of a decoder block, ``x + ln(W_out gelu(W_in
tgate(ln(x))))`` with one shared AbbyNormal ``ln``: the CUDA kernels
``csrc/mlp.cu`` and their plain PyTorch version.

Replaces ``asr_model_tpu/ops/pallas/mlp_kernel.py:fused_mlp_residual``.
The GELU is torch's exact erf form (the Pallas kernel built erf from a
rational approximation, within 1.5e-7 of it).  Products take operands
rounded to the storage type (h0, h1, h2, h3, where the Pallas kernel
rounds) with f32 sums.  About 11 D^2 multiply-adds a row against ~5.8 MB
of bf16 weights at D = 512, and each product needs whole rows of its
input, so a call is five launches (``launch_plan``): ln(x) by a cluster
per 32-row tile (the router sliced over its CTAs, the tail once a row),
the gates, W_in + GELU, W_out, and x + ln(h3) as the first.  bf16 rows
of 16-byte multiples take the tensor cores (32-row tiles x 64-column
slices); f32 takes the CUDA cores in the same launches.

Past those plans, two routes (either dtype): more than 12 TGate types
take the types in a launch of their own and the gates on the CUDA cores
with their pointers and the types in device memory (six launches;
``fused_mlp_residual.routes["types"]``); a D whose norms take AbbyNormal's
global route (past 59,392 in bf16, ``abby.is_global``) runs each norm as
that route's three launches (``routes["global"]``).
"""

from __future__ import annotations

import torch

from asr_model_tpu_torch.ops.cuda import build as B
from asr_model_tpu_torch.ops.cuda import abby
from asr_model_tpu_torch.ops.cuda.abby import abby_values, linear_t

LAUNCHES = 5                     # a call's kernel launches (mlp.cu)
MAX_TYPES = 12                   # TGate types of the gates' launch
                                 # (mlp.cu MLP_MAX_NT); past it one more
GKCH = 2048                      # h0 columns a CUDA-core gates CTA holds
ROWS, COLS = 32, 64              # the tensor-core tiles (mlp.cu)
STAGES = 3                       # their k chunks in flight (MLP_ST)


def gate_cols(nt: int) -> int:
    """Columns of each gate a CTA of the tensor-core gates launch takes:
    nt slices and the nt rows of cs fill one 128-column tile
    (``csrc/mlp.cu:mlp_gate_cols``)."""
    return (128 - nt) // nt // 8 * 8


def gates_tc_smem() -> int:
    """Dynamic shared memory of the tensor-core gates launch
    (``csrc/mlp.cu:mlp_gates_tc_smem``): the ring, the gates' values
    [32][128] and the types, f32."""
    return (B.tc_ring_bytes(2, 4, False, False, STAGES)
            + 4 * ROWS * (128 + MAX_TYPES))


def launch_plan(n: int, d: int, hid: int, dtype, nt: int = 3) -> dict:
    """What ``asr_fused_mlp_residual`` launches for (n, d) rows and a
    hidden width ``hid``: the two norms' clusters (``abby.launch_plan``),
    whether the products take the tensor cores (bf16, d and hid
    multiples of 8, on aligned operands), their (row tile, column slice)
    grids (``gate_cols(nt)`` columns of each of nt gates a CTA in the
    tensor-core gates launch) and shared memory in bytes.  Past MAX_TYPES
    gates (``types`` "many") one launch more, the gates on the CUDA
    cores; where the norm's plan is AbbyNormal's global route, each norm
    is its three launches."""
    norm = abby.launch_plan(n, d, dtype)
    tc = dtype == torch.bfloat16 and d % 8 == 0 and hid % 8 == 0
    rows = ROWS if tc else 16
    many = nt > MAX_TYPES
    # each norm on AbbyNormal's global route: its launches, not one
    extra = 2 * (norm["launches"] - 1) if norm.get("route") == "global" \
        else 0
    launches = LAUNCHES + int(many) + extra
    return dict(launches=launches, tc=tc, norm=norm, rows=rows,
                types="many" if many else "tc" if tc else "cc",
                tiles=-(-n // rows), slices_d=-(-d // COLS),
                slices_hid=-(-hid // COLS),
                gate_cols=gate_cols(nt) if tc and not many else COLS,
                slices_gates=-(-d // (gate_cols(nt) if tc and not many
                                      else COLS)),
                gates_smem=(gates_tc_smem() if tc and not many
                            else 4 * (16 * min(d, GKCH) + 32 * 65
                                      + (0 if many else 16 * MAX_TYPES))),
                linear_smem=(B.tc_ring_bytes(2, 2, False, False, STAGES) if tc
                             else 4 * (16 * min(max(d, hid), 2048)
                                       + 32 * 65)))


def supports(d: int, nt: int) -> bool:
    """The widths the kernels take: any D >= 2, any number of gates, any
    window."""
    return d >= 2 and nt >= 1


def mlp_residual_plain(x2, ln_w, cs_w, cs_b, gates, in_w, in_b, out_w,
                       out_b, size_d: int, alpha: float, k: float,
                       beta: float):
    """x2 (N, D); ln_w = (w1 (D, D), b1 (D,), w2 (3, D), b2 (3,)), the
    shared AbbyNormal; cs_w (nt, D), cs_b (nt,); gates [(w (D, D), b
    (D,)), ...] per TGate gate; in_w (3D, D), out_w (D, 3D) -- torch
    (out, in) layouts."""
    mlp_residual_plain.calls += 1
    dt = x2.dtype
    ct = torch.promote_types(dt, torch.float32)
    r = lambda t: t.to(dt).to(ct)          # rounded to the storage type
    h0 = r(abby_values(x2, *ln_w, size_d, alpha, k, beta))
    types = torch.softmax(linear_t(h0, cs_w, ct) + cs_b.to(ct), dim=-1)
    h1 = torch.zeros_like(h0)
    for i, (gw, gb) in enumerate(gates):
        h1 = h1 + torch.sigmoid(linear_t(h0, gw, ct) + gb.to(ct)) \
            * types[:, i:i + 1]
    h2 = linear_t(r(h1), in_w, ct) + in_b.to(ct)
    h2 = 0.5 * h2 * (1.0 + torch.erf(h2 * 0.7071067811865476))
    h3 = linear_t(r(h2), out_w, ct) + out_b.to(ct)
    h4 = abby_values(h3.to(dt), *ln_w, size_d, alpha, k, beta)
    return (x2.to(ct) + h4).to(dt)


mlp_residual_plain.calls = 0


def fused_mlp_residual(x2, ln_w, cs_w, cs_b, gates, in_w, in_b, out_w,
                       out_b, size_d: int, alpha: float, k: float,
                       beta: float):
    """``x2 + mlp(x2)`` over the rows of x2 (N, D): the kernels on CUDA
    tensors (f32 or bf16, weights of x2's dtype, any D >= 2, any number
    of gates: ``launch_plan``), the plain version on CPU tensors.
    Arguments as in ``mlp_residual_plain``."""
    args = (x2, ln_w, cs_w, cs_b, gates, in_w, in_b, out_w, out_b, size_d,
            alpha, k, beta)
    if x2.device.type == "cpu":
        return mlp_residual_plain(*args)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_mlp_residual: unsupported device "
                         f"{x2.device}")
    n, d = x2.shape
    nt, hid = len(gates), in_w.shape[0]
    weights = [*ln_w, cs_w, cs_b, *[t for g in gates for t in g], in_w,
               in_b, out_w, out_b]
    B.eval_only("fused_mlp_residual", "models/decoder.py "
                "Residual._mlp_fused_ok", lambda: (x2, *weights))
    ok = (x2.dim() == 2 and supports(d, nt) and hid >= 1
          and size_d >= 1
          and n <= 65535 * ROWS and ln_w[0].shape == (d, d)
          and ln_w[2].shape == (3, d) and cs_w.shape == (nt, d)
          and all(g[0].shape == (d, d) and g[1].shape == (d,) for g in gates)
          and in_w.shape == (hid, d) and out_w.shape == (d, hid)
          and all(t.dtype == x2.dtype and t.is_contiguous()
                  and t.device == x2.device for t in [x2, *weights]))
    if not ok:
        raise ValueError(
            "fused_mlp_residual kernels take contiguous (N, D >= 2) x and "
            "torch-layout weights of its dtype and device; "
            f"got x {tuple(x2.shape)} {x2.dtype}, in_w {tuple(in_w.shape)}, "
            f"{nt} gates")
    code = B.dtype_code(x2.dtype)
    es = x2.element_size()
    plan = launch_plan(n, d, hid, x2.dtype, nt)
    many = plan["types"] == "many"
    norm_global = plan["norm"].get("route") == "global"
    work, (h0, h1, h2, h3, tys, choice) = B.workspace(
        x2.device, [n * d * es, n * d * es, n * hid * es, n * d * es,
                    4 * n * nt * many, 4 * n * norm_global])
    dev_gates = None
    if many:          # the gates' pointers, weights then biases
        dev_gates = torch.tensor([g[0].data_ptr() for g in gates]
                                 + [g[1].data_ptr() for g in gates],
                                 dtype=torch.int64).to(x2.device)
    out = torch.empty_like(x2)
    fn = B.function("asr_fused_mlp_residual",
                    [B.I, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.PP, B.PP, B.I,
                     B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P, B.P,
                     B.P, B.I, B.I, B.I, B.I, B.F, B.F, B.F, B.P])
    rc = fn(code, x2.data_ptr(), *(t.data_ptr() for t in ln_w),
            cs_w.data_ptr(), cs_b.data_ptr(),
            B.ptr_array([g[0].data_ptr() for g in gates]),
            B.ptr_array([g[1].data_ptr() for g in gates]), nt,
            in_w.data_ptr(), in_b.data_ptr(), out_w.data_ptr(),
            out_b.data_ptr(), out.data_ptr(), h0, h1, h2, h3,
            B.ptr(dev_gates), tys if many else None,
            choice if norm_global else None, n, d, hid, int(size_d),
            float(alpha), float(k), float(beta), B.stream_of(x2))
    B.check(rc, "asr_fused_mlp_residual")
    n_l = plan["launches"] if n else 0
    fused_mlp_residual.launches += n_l
    if many:
        fused_mlp_residual.routes["types"] += n_l
    if norm_global:
        fused_mlp_residual.routes["global"] += n_l
    return out


fused_mlp_residual.launches = 0
fused_mlp_residual.routes = {"types": 0, "global": 0}
