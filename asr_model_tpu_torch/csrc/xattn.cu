// Whole attention calls of the decode step for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/xattn_kernel.py:fused_attn_cached and
// fused_attn_full.
//
// One call, per query row x (D values, H heads of HD = 128):
//   q = (q_norm(x) Wq^T + bq) * HD^-0.25, rotated by lane pairs (2i, 2i+1)
//       at angle t * freq_i (t the row's position, the ladder tiled per
//       head) and scaled by ||x row||; per head, qh = head_norm(q_head)
//   cached: K, V (B, H, Tk, HD) are the precomputed, processed cache;
//   full:   from xa (Ta rows) as the q side: k = (kv_norm(xa) Wk^T + bk) *
//           HD^-0.25, rotated by ||xa row||, per-head head_norm; v raw
//   a = softmax(qh K^T / sqrt(HD), masked) V per head, masked logits -1e30
//       (a fully masked row is the mean of V), the causal mask aligned
//       bottom-right (key j visible to query i when j <= i + Tk - T)
//   out = concat(a) Wo^T + bo
// Every AbbyNormal is the eval one (router product + tail,
// abby_tail.cuh).  Products take storage-type operands with f32 sums;
// values are rounded to the storage type where the reference rounds them:
// the norms' outputs, the rotated q/k, the head-normed q/k, v, the
// softmax weights, the heads' outputs and the result.
//
// What bounds it: the flagship cached call (x 8 x 65 x 512, K/V 8 x 4 x
// 1001 x 128 bf16) needs ~0.9 GFLOP of q side and ~1.1 GFLOP of attention
// against ~19 MB, K/V above all: bytes at tensor-core rates (~6 us), but
// operations on the CUDA cores this version uses; a full call at width
// 65 reads little and is bound by operations.  The Pallas kernel held a
// batch row's whole K/V in VMEM (2 MB at the flagship, past shared
// memory) with a grid of B = 8 programs; here a call is split over
// (16-row tile, head, batch) blocks (160 at the flagship) that stream K/V
// in 32-key tiles, and the launches are those the row-wide dependencies
// force:
//   1 the q_norm (and, full, kv_norm) router products -> partial logits
//     (abby_router_tile over 64-column slices)
//   2 full only: the kv side per (16-key tile, head, batch) -> K, V
//   3 the q side per (16-row tile, head, batch): norm tail, the head's
//     q columns, rotary, head_norm, then attention over K/V -> heads
//   4 out_proj over (16-row tile, 64-column slice)      (linear_rows)
// Three launches a cached call, four a full one.  Softmax runs in two
// passes over the keys (running max and sum, then the normalised,
// rounded weights times V), so the weights are rounded as the reference
// rounds them; the second pass recomputes the scores.
#include "abby_tail.cuh"

constexpr int XA_HD = 128;                 // head width the kernels take
constexpr int XA_QLD = XA_HD + 1;          // padded row of a head tile
constexpr int XA_KT = 32;                  // keys per tile
constexpr float XA_MASKED = -1e30f;

// Weights of a call, torch (out, in) layouts, in this order.
enum XaWeight {
  QN_W1, QN_B1, QN_W2, QN_B2, QP_W, QP_B,
  KN_W1, KN_B1, KN_W2, KN_B2, KP_W, KP_B,
  HN_W1, HN_B1, HN_W2, HN_B2, OP_W, OP_B, XA_NW
};

template <typename T>
struct XaW {
  const T* p[XA_NW];
};

struct XaShape {
  int B, T, Tk, D, H, causal, size_d, size_h;
  float alpha, k, beta, qk_scale, sm_scale;
};

// Load the 16 rows t0.. of one batch row's (S, D) input, keep ||row|| in
// mn, and run the AbbyNormal tail in place (router logits from plog,
// rows b * S + t of N): xs holds the norm's output, rounded.
template <typename T>
__device__ void xa_load_norm(const T* __restrict__ x, int S, int t0, int D,
                             const float* __restrict__ plog, int N,
                             int row0, const T* __restrict__ b2, float* xs,
                             float* mn, const XaShape& sh) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
    const int r = e / D, j = e % D;
    xs[e] = (t0 + r < S) ? to_f32(x[(size_t)(t0 + r) * D + j]) : 0.0f;
  }
  __syncthreads();
  const int slices = (D + GEMM_NT - 1) / GEMM_NT;
  for (int r = warp; r < GEMM_ROWS; r += blockDim.x / 32) {
    float* xr = xs + r * D;
    float sq = 0.0f;
    for (int j = lane; j < D; j += 32) sq += xr[j] * xr[j];
    sq = warp_sum(sq);
    if (lane == 0) mn[r] = sq > 0.0f ? sqrtf(sq) : 0.0f;
    if (t0 + r < S) {
      float lg[3];
      abby_logits<T>(plog, N, slices, row0 + t0 + r, b2, lg);
      abby_row_tail_inplace<T, true>(xr, D, lg, sh.size_d, sh.alpha, sh.k,
                                     sh.beta, lane);
    }
  }
  __syncthreads();
}

// dst[r][c] = (xs[r] . W[col0 + c] + bias[col0 + c]) * scale for the
// head's HD columns; W (Nout, D).
template <typename T>
__device__ void xa_head_proj(const float* xs, int D, const T* __restrict__ w,
                             const T* __restrict__ bias, int Nout, int col0,
                             float scale, float* dst, int ld, float* wt) {
  const int t = threadIdx.x;
  for (int half = 0; half < XA_HD / GEMM_NT; ++half) {
    const int n0 = col0 + half * GEMM_NT;
    float acc[4];
    gemm_rows16<T, false>(xs, D, D, w, D, n0, Nout, wt, acc);
    const int c = t % GEMM_NT;
    const float b = to_f32(bias[n0 + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[(4 * (t / GEMM_NT) + i) * ld + half * GEMM_NT + c] =
          (acc[i] + b) * scale;
  }
  __syncthreads();
}

// The signal-adaptive rotary of a head tile in place, rounded: the pair
// (a, b) at channels (2i, 2i + 1) of row r (position t0 + r) becomes
// (a m cos - b m sin, b m cos + a m sin), m = mn[r], angle (t0 + r) f_i.
template <typename T>
__device__ void xa_rotate(float* qs, int ld, const float* mn, int t0,
                          const float* __restrict__ freqs) {
  for (int e = threadIdx.x; e < GEMM_ROWS * XA_HD / 2; e += blockDim.x) {
    const int r = e / (XA_HD / 2), p = e % (XA_HD / 2);
    float* q = qs + r * ld + 2 * p;
    const float f = (float)(t0 + r) * freqs[p];
    const float mc = mn[r] * cosf(f), ms = mn[r] * sinf(f);
    const float a = q[0], b = q[1];
    q[0] = to_f32(from_f32<T>(a * mc + b * (-ms)));
    q[1] = to_f32(from_f32<T>(b * mc + a * ms));
  }
  __syncthreads();
}

// Scores of row `row` against keys tx and tx + 16 of the staged tile,
// scaled and masked; keys past Tk are -inf (no weight at all).
__device__ __forceinline__ void xa_scores(const float* qs, const float* kt,
                                          int row, int tx, int k0, int qpos,
                                          int Tq, int Tk,
                                          const uint8_t* valid, int causal,
                                          float sm_scale, float s[2]) {
  float d0 = 0.0f, d1 = 0.0f;
  const float* q = qs + row * XA_QLD;
  const float* ka = kt + tx * (XA_HD + 1);
  const float* kb = kt + (tx + 16) * (XA_HD + 1);
#pragma unroll 8
  for (int d = 0; d < XA_HD; ++d) {
    d0 = fmaf(q[d], ka[d], d0);
    d1 = fmaf(q[d], kb[d], d1);
  }
  const float dd[2] = {d0, d1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kj = k0 + tx + 16 * j;
    if (kj >= Tk) {
      s[j] = -INFINITY;
    } else {
      bool masked = causal && kj > qpos + Tk - Tq;
      if (valid && !valid[kj]) masked = true;
      s[j] = masked ? XA_MASKED : dd[j] * sm_scale;
    }
  }
}

template <typename T>
__device__ void xa_stage(const T* __restrict__ kh, const T* __restrict__ vh,
                         int k0, int Tk, float* kt, float* vt) {
  for (int e = threadIdx.x; e < XA_KT * XA_HD; e += blockDim.x) {
    const int r = e / XA_HD, d = e % XA_HD;
    const bool in = k0 + r < Tk;
    const size_t off = (size_t)(k0 + r) * XA_HD + d;
    kt[r * (XA_HD + 1) + d] = in ? to_f32(kh[off]) : 0.0f;
    if (vt) vt[r * XA_HD + d] = in ? to_f32(vh[off]) : 0.0f;
  }
}

// Attention of the tile's 16 head-normed query rows (qs) over one head's
// keys: pass 1 the running max and sum, pass 2 the normalised weights
// rounded to the storage type times V.  Writes the rows' head outputs
// (rounded) to o (row stride D).
template <typename T>
__device__ void xa_attend(const float* qs, const T* __restrict__ kh,
                          const T* __restrict__ vh,
                          const uint8_t* __restrict__ valid, int t0, int Tq,
                          int Tk, int causal, float sm_scale, float* kt,
                          float* vt, float* ps, T* __restrict__ o, int D) {
  const int t = threadIdx.x, row = t / 16, tx = t % 16;
  const int qpos = t0 + row;
  float m_run = -INFINITY, l_run = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += XA_KT) {
    __syncthreads();
    xa_stage<T>(kh, vh, k0, Tk, kt, nullptr);
    __syncthreads();
    float s[2];
    xa_scores(qs, kt, row, tx, k0, qpos, Tq, Tk, valid, causal, sm_scale, s);
    float mx = fmaxf(s[0], s[1]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);    // finite: key k0 exists
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sum += s[j] == -INFINITY ? 0.0f : expf(s[j] - m_new);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }

  float acc[XA_HD / 16];
#pragma unroll
  for (int j = 0; j < XA_HD / 16; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += XA_KT) {
    __syncthreads();
    xa_stage<T>(kh, vh, k0, Tk, kt, vt);
    __syncthreads();
    float s[2];
    xa_scores(qs, kt, row, tx, k0, qpos, Tq, Tk, valid, causal, sm_scale, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ps[row * (XA_KT + 1) + tx + 16 * j] =
          s[j] == -INFINITY
              ? 0.0f
              : to_f32(from_f32<T>(expf(s[j] - m_run) / l_run));
    __syncthreads();
    const int kmax = min(XA_KT, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p = ps[row * (XA_KT + 1) + c];
#pragma unroll
      for (int j = 0; j < XA_HD / 16; ++j)
        acc[j] = fmaf(p, vt[c * XA_HD + tx + 16 * j], acc[j]);
    }
  }
  if (qpos < Tq) {
#pragma unroll
    for (int j = 0; j < XA_HD / 16; ++j)
      o[(size_t)qpos * D + tx + 16 * j] = from_f32<T>(acc[j]);
  }
}

__host__ __device__ constexpr int xa_q_smem_floats(int D) {
  return GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * XA_QLD +
         GEMM_ROWS * XA_HD + GEMM_ROWS * 3 + GEMM_ROWS +
         XA_KT * (XA_HD + 1) + XA_KT * XA_HD + GEMM_ROWS * (XA_KT + 1);
}

__host__ __device__ constexpr int xa_kv_smem_floats(int D) {
  return GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * XA_QLD +
         GEMM_ROWS * XA_HD + GEMM_ROWS * 3 + GEMM_ROWS;
}

// Launch 1: the router products of q_norm over x (blockIdx.z = 0) and,
// in a full call, of kv_norm over xa (blockIdx.z = 1).
template <typename T>
__global__ void __launch_bounds__(256)
xattn_routers(const T* __restrict__ x, const T* __restrict__ xa, XaW<T> w,
              float* __restrict__ plog_q, float* __restrict__ plog_kv,
              int Nq, int Nkv, int D) {
  extern __shared__ float smem[];
  const bool kv = blockIdx.z == 1;
  const int N = kv ? Nkv : Nq;
  const int r0 = blockIdx.x * GEMM_ROWS;
  if (r0 >= N) return;                       // the whole block leaves
  if (kv)
    abby_router_tile<T>(xa, w.p[KN_W1], w.p[KN_B1], w.p[KN_W2], plog_kv, N,
                        D, r0, blockIdx.y, smem);
  else
    abby_router_tile<T>(x, w.p[QN_W1], w.p[QN_B1], w.p[QN_W2], plog_q, N, D,
                        r0, blockIdx.y, smem);
}

// Launch 2 (full calls): the kv side of one (16-key tile, head, batch).
template <typename T>
__global__ void __launch_bounds__(256)
xattn_kv(const T* __restrict__ xa, XaW<T> w, const float* __restrict__ plog,
         const float* __restrict__ freqs, T* __restrict__ kout,
         T* __restrict__ vout, XaShape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, Ta = sh.Tk;
  float* xs = smem;                          // [16][D]
  float* wt = xs + GEMM_ROWS * D;
  float* ks = wt + GEMM_WT_FLOATS;           // [16][QLD]
  float* hs = ks + GEMM_ROWS * XA_QLD;       // [16][HD]
  float* lgs = hs + GEMM_ROWS * XA_HD;       // [16][3]
  float* mn = lgs + GEMM_ROWS * 3;           // [16]
  const int t0 = blockIdx.x * GEMM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(GEMM_ROWS, Ta - t0);
  const size_t head = ((size_t)b * sh.H + h) * Ta;

  xa_load_norm<T>(xa + (size_t)b * Ta * D, Ta, t0, D, plog, sh.B * Ta,
                  b * Ta, w.p[KN_B2], xs, mn, sh);
  // v: the head's columns D + h HD .., raw, rounded
  xa_head_proj<T>(xs, D, w.p[KP_W], w.p[KP_B], 2 * D, D + h * XA_HD, 1.0f,
                  hs, XA_HD, wt);
  for (int e = threadIdx.x; e < rows * XA_HD; e += blockDim.x)
    vout[(head + t0) * XA_HD + e] = from_f32<T>(hs[e]);
  // k: scaled, rotated by ||xa row||, head-normed
  xa_head_proj<T>(xs, D, w.p[KP_W], w.p[KP_B], 2 * D, h * XA_HD,
                  sh.qk_scale, ks, XA_QLD, wt);
  xa_rotate<T>(ks, XA_QLD, mn, t0, freqs);
  abby_tile_inblock<T>(ks, XA_QLD, XA_HD, w.p[HN_W1], w.p[HN_B1],
                       w.p[HN_W2], w.p[HN_B2], hs, lgs, wt, rows, sh.size_h,
                       sh.alpha, sh.k, sh.beta);
  for (int e = threadIdx.x; e < rows * XA_HD; e += blockDim.x)
    kout[(head + t0) * XA_HD + e] =
        from_f32<T>(ks[(e / XA_HD) * XA_QLD + e % XA_HD]);
}

// Launch 3: the q side of one (16-row tile, head, batch) and its
// attention over the head's K/V; writes the heads' outputs o (B, T, D).
template <typename T>
__global__ void __launch_bounds__(256)
xattn_q_attend(const T* __restrict__ x, XaW<T> w,
               const float* __restrict__ plog,
               const float* __restrict__ freqs, const T* __restrict__ kc,
               const T* __restrict__ vc, const uint8_t* __restrict__ valid,
               T* __restrict__ o, XaShape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, Tq = sh.T;
  float* xs = smem;                          // [16][D]
  float* wt = xs + GEMM_ROWS * D;
  float* qs = wt + GEMM_WT_FLOATS;           // [16][QLD]
  float* hs = qs + GEMM_ROWS * XA_QLD;       // [16][HD]
  float* lgs = hs + GEMM_ROWS * XA_HD;       // [16][3]
  float* mn = lgs + GEMM_ROWS * 3;           // [16]
  float* kt = mn + GEMM_ROWS;                // [KT][HD + 1]
  float* vt = kt + XA_KT * (XA_HD + 1);      // [KT][HD]
  float* ps = vt + XA_KT * XA_HD;            // [16][KT + 1]
  const int t0 = blockIdx.x * GEMM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(GEMM_ROWS, Tq - t0);

  xa_load_norm<T>(x + (size_t)b * Tq * D, Tq, t0, D, plog, sh.B * Tq,
                  b * Tq, w.p[QN_B2], xs, mn, sh);
  xa_head_proj<T>(xs, D, w.p[QP_W], w.p[QP_B], D, h * XA_HD, sh.qk_scale, qs,
                  XA_QLD, wt);
  xa_rotate<T>(qs, XA_QLD, mn, t0, freqs);
  abby_tile_inblock<T>(qs, XA_QLD, XA_HD, w.p[HN_W1], w.p[HN_B1],
                       w.p[HN_W2], w.p[HN_B2], hs, lgs, wt, rows, sh.size_h,
                       sh.alpha, sh.k, sh.beta);
  const size_t head = ((size_t)b * sh.H + h) * sh.Tk * XA_HD;
  xa_attend<T>(qs, kc + head, vc + head,
               valid ? valid + (size_t)b * sh.Tk : nullptr, t0, Tq, sh.Tk,
               sh.causal, sh.sm_scale, kt, vt, ps,
               o + (size_t)b * Tq * D + h * XA_HD, D);
}

template <typename T>
static int launch_xattn(bool full, const void* x, const void* xa,
                        const void* kc, const void* vc, const void* valid,
                        const void* freqs, const void* const* wp, void* out,
                        void* plog_q, void* plog_kv, void* kbuf, void* vbuf,
                        void* o, const XaShape& sh, cudaStream_t st) {
  XaW<T> w;
  for (int i = 0; i < XA_NW; ++i) w.p[i] = (const T*)wp[i];
  const int D = sh.D, Nq = sh.B * sh.T, Nkv = full ? sh.B * sh.Tk : 0;
  const int slices = (D + GEMM_NT - 1) / GEMM_NT;

  const size_t smem_r = sizeof(float) * abby_router_smem_floats(D);
  cudaFuncSetAttribute(xattn_routers<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_r);
  const int rt = ((Nq > Nkv ? Nq : Nkv) + GEMM_ROWS - 1) / GEMM_ROWS;
  xattn_routers<T><<<dim3(rt, slices, full ? 2 : 1), 256, smem_r, st>>>(
      (const T*)x, (const T*)xa, w, (float*)plog_q, (float*)plog_kv, Nq, Nkv,
      D);

  if (full) {
    const size_t smem_kv = sizeof(float) * xa_kv_smem_floats(D);
    cudaFuncSetAttribute(xattn_kv<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_kv);
    xattn_kv<T><<<dim3((sh.Tk + GEMM_ROWS - 1) / GEMM_ROWS, sh.H, sh.B), 256,
                  smem_kv, st>>>((const T*)xa, w, (const float*)plog_kv,
                                 (const float*)freqs, (T*)kbuf, (T*)vbuf, sh);
    kc = kbuf;
    vc = vbuf;
  }

  const size_t smem_q = sizeof(float) * xa_q_smem_floats(D);
  cudaFuncSetAttribute(xattn_q_attend<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_q);
  xattn_q_attend<T><<<dim3((sh.T + GEMM_ROWS - 1) / GEMM_ROWS, sh.H, sh.B),
                      256, smem_q, st>>>(
      (const T*)x, w, (const float*)plog_q, (const float*)freqs,
      (const T*)kc, (const T*)vc, (const uint8_t*)valid, (T*)o, sh);

  launch_linear_rows<T, LIN_NONE>(o, wp[OP_W], wp[OP_B], out, Nq, D, D, st);
  return (int)cudaGetLastError();
}

static int xattn_checks(int D, int H, int T, int Tk) {
  if (H < 1 || D != H * XA_HD || D > ABBY_MAX_D || T < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

static XaShape xa_shape(int B, int T, int Tk, int D, int H, int causal,
                        int size_d, int size_h, float alpha, float k,
                        float beta) {
  XaShape sh;
  sh.B = B; sh.T = T; sh.Tk = Tk; sh.D = D; sh.H = H; sh.causal = causal;
  sh.size_d = size_d; sh.size_h = size_h;
  sh.alpha = alpha; sh.k = k; sh.beta = beta;
  sh.qk_scale = (float)pow((double)XA_HD, -0.25);   // as the host computes
  sh.sm_scale = (float)(1.0 / sqrt((double)XA_HD));
  return sh;
}

// Cached call.  x, out: (B, T, D); kc, vc: (B, H, Tk, 128), the processed
// K and raw V; valid: (B, Tk) bytes or null; freqs: (64,) f32 angular
// frequencies (the non-causal ladder); w: XA_NW weight pointers in
// XaWeight order (the KN_* / KP_* entries unused) -- all of one dtype (0 =
// f32, 1 = bf16).  Workspace: plog_q f32 of ceil(D / 64) * B * T * 3, o
// (B, T, D) of the dtype.  D = 128 H <= 1024.  Three launches.
ASR_API int asr_fused_attn_cached(int dtype, const void* x, const void* kc,
                                  const void* vc, const void* valid,
                                  const void* freqs, const void* const* w,
                                  void* out, void* plog_q, void* o, int B,
                                  int T, int Tk, int D, int H, int size_d,
                                  int size_h, float alpha, float k,
                                  float beta, void* stream) {
  const int bad = xattn_checks(D, H, T, Tk);
  if (bad) return bad;
  if (B == 0) return 0;
  const XaShape sh = xa_shape(B, T, Tk, D, H, 0, size_d, size_h, alpha, k,
                              beta);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_xattn<float>(false, x, nullptr, kc, vc, valid, freqs, w,
                               out, plog_q, nullptr, nullptr, nullptr, o, sh,
                               st);
  return launch_xattn<__nv_bfloat16>(false, x, nullptr, kc, vc, valid, freqs,
                                     w, out, plog_q, nullptr, nullptr,
                                     nullptr, o, sh, st);
}

// Full call.  x, out: (B, T, D); xa: (B, Ta, D) (xa = x for
// self-attention); valid: (B, Ta) bytes or null; causal: bottom-right
// mask; freqs: (64,) f32, the ladder of both sides; w: all XA_NW weights.
// Workspace: plog_q and plog_kv f32 of ceil(D / 64) * B * T * 3 and
// ceil(D / 64) * B * Ta * 3; kbuf, vbuf (B, H, Ta, 128) and o (B, T, D)
// of the dtype.  Four launches.
ASR_API int asr_fused_attn_full(int dtype, const void* x, const void* xa,
                                const void* valid, const void* freqs,
                                const void* const* w, void* out,
                                void* plog_q, void* plog_kv, void* kbuf,
                                void* vbuf, void* o, int B, int T, int Ta,
                                int D, int H, int causal, int size_d,
                                int size_h, float alpha, float k, float beta,
                                void* stream) {
  const int bad = xattn_checks(D, H, T, Ta);
  if (bad) return bad;
  if (B == 0) return 0;
  const XaShape sh = xa_shape(B, T, Ta, D, H, causal, size_d, size_h, alpha,
                              k, beta);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_xattn<float>(true, x, xa, nullptr, nullptr, valid, freqs,
                               w, out, plog_q, plog_kv, kbuf, vbuf, o, sh,
                               st);
  return launch_xattn<__nv_bfloat16>(true, x, xa, nullptr, nullptr, valid,
                                     freqs, w, out, plog_q, plog_kv, kbuf,
                                     vbuf, o, sh, st);
}
