// Whole attention calls of the decode step for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/xattn_kernel.py:fused_attn_cached and
// fused_attn_full.
//
// One call, per query row x (D values, H heads of HD = 128 or 256):
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
// against ~19 MB, K/V above all: bytes at tensor-core rates (~6 us).  A
// full call at width 65 needs ~3.1 MB of bf16 weights against ~0.5 MB of
// activations.  Both are set by the bytes each CTA streams into its SM
// and by the latency of the phases a row-wide dependency forces.  The
// Pallas kernel held a batch row's whole K/V in VMEM (2 MB at the
// flagship, past shared memory) with a grid of B = 8 programs.
// In bf16 (the model's route) a call is two launches on the tensor
// cores: xattn_full_rows (the q side; in a full call the kv side too),
// then xattn_full_attend (a full call) or xattn_cached_attend (a cached
// call, keys split across a cluster) -- designs below.  f32, and a full
// call past XA_TC_MAX_KEYS keys, take the CUDA cores in full f32 (TF32
// would not hold the f32 route's 1e-4), split over (16-row tile, head,
// batch) blocks that stream K/V in 32-key tiles, in the launches the
// row-wide dependencies force:
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
// The other widths take the wide route (xattn_wide.cu, its own source so
// that the two compile in parallel).
#include "abby_cluster.cuh"
#include "xattn.cuh"

constexpr int XA_HD = 128;                 // the head widths the kernels
constexpr int XA_HD2 = 256;                // take: 128 and 256
constexpr int XA_KT = 32;                  // keys per tile

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
template <typename T, int HD>
__device__ void xa_head_proj(const float* xs, int D, const T* __restrict__ w,
                             const T* __restrict__ bias, int Nout, int col0,
                             float scale, float* dst, int ld, float* wt) {
  const int t = threadIdx.x;
  for (int half = 0; half < HD / GEMM_NT; ++half) {
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
template <typename T, int HD>
__device__ void xa_rotate(float* qs, int ld, const float* mn, int t0,
                          const float* __restrict__ freqs) {
  for (int e = threadIdx.x; e < GEMM_ROWS * HD / 2; e += blockDim.x) {
    const int r = e / (HD / 2), p = e % (HD / 2);
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
template <int HD>
__device__ __forceinline__ void xa_scores(const float* qs, const float* kt,
                                          int row, int tx, int k0, int qpos,
                                          int Tq, int Tk,
                                          const uint8_t* valid, int causal,
                                          float sm_scale, float s[2]) {
  float d0 = 0.0f, d1 = 0.0f;
  const float* q = qs + row * (HD + 1);
  const float* ka = kt + tx * (HD + 1);
  const float* kb = kt + (tx + 16) * (HD + 1);
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
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

// keys k0 .. k0 + XA_KT - 1 of one head's K (or V) rows into kt [KT][HD
// + 1], zero past Tk
template <typename T, int HD>
__device__ void xa_stage(const T* __restrict__ kh, int k0, int Tk,
                         float* kt) {
  for (int e = threadIdx.x; e < XA_KT * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const bool in = k0 + r < Tk;
    kt[r * (HD + 1) + d] = in ? to_f32(kh[(size_t)(k0 + r) * HD + d]) : 0.0f;
  }
}

// Attention of the tile's 16 head-normed query rows (qs) over one head's
// keys: pass 1 the running max and sum, pass 2 the normalised weights
// rounded to the storage type times V (the key tile's buffer kt takes
// the V tile once the weights are out).  Writes the rows' head outputs
// (rounded) to o (row stride D).
template <typename T, int HD>
__device__ void xa_attend(const float* qs, const T* __restrict__ kh,
                          const T* __restrict__ vh,
                          const uint8_t* __restrict__ valid, int t0, int Tq,
                          int Tk, int causal, float sm_scale, float* kt,
                          float* ps, T* __restrict__ o, int D) {
  const int t = threadIdx.x, row = t / 16, tx = t % 16;
  const int qpos = t0 + row;
  float m_run = -INFINITY, l_run = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += XA_KT) {
    __syncthreads();
    xa_stage<T, HD>(kh, k0, Tk, kt);
    __syncthreads();
    float s[2];
    xa_scores<HD>(qs, kt, row, tx, k0, qpos, Tq, Tk, valid, causal, sm_scale, s);
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

  float acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < Tk; k0 += XA_KT) {
    __syncthreads();
    xa_stage<T, HD>(kh, k0, Tk, kt);
    __syncthreads();
    float s[2];
    xa_scores<HD>(qs, kt, row, tx, k0, qpos, Tq, Tk, valid, causal, sm_scale, s);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ps[row * (XA_KT + 1) + tx + 16 * j] =
          s[j] == -INFINITY
              ? 0.0f
              : to_f32(from_f32<T>(expf(s[j] - m_run) / l_run));
    __syncthreads();
    xa_stage<T, HD>(vh, k0, Tk, kt);
    __syncthreads();
    const int kmax = min(XA_KT, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p = ps[row * (XA_KT + 1) + c];
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
        acc[j] = fmaf(p, kt[c * (HD + 1) + tx + 16 * j], acc[j]);
    }
  }
  if (qpos < Tq) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      o[(size_t)qpos * D + tx + 16 * j] = from_f32<T>(acc[j]);
  }
}

__host__ __device__ constexpr int xa_q_smem_floats(int D, int HD) {
  return GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * (HD + 1) +
         GEMM_ROWS * HD + GEMM_ROWS * 3 + GEMM_ROWS + XA_KT * (HD + 1) +
         GEMM_ROWS * (XA_KT + 1);
}

__host__ __device__ constexpr int xa_kv_smem_floats(int D, int HD) {
  return GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * (HD + 1) +
         GEMM_ROWS * HD + GEMM_ROWS * 3 + GEMM_ROWS;
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
template <typename T, int HD>
__global__ void __launch_bounds__(256)
xattn_kv(const T* __restrict__ xa, XaW<T> w, const float* __restrict__ plog,
         const float* __restrict__ freqs, T* __restrict__ kout,
         T* __restrict__ vout, XaShape sh) {
  extern __shared__ float smem[];
  const int D = sh.D, Ta = sh.Tk;
  float* xs = smem;                          // [16][D]
  float* wt = xs + GEMM_ROWS * D;
  float* ks = wt + GEMM_WT_FLOATS;           // [16][QLD]
  float* hs = ks + GEMM_ROWS * (HD + 1);       // [16][HD]
  float* lgs = hs + GEMM_ROWS * HD;       // [16][3]
  float* mn = lgs + GEMM_ROWS * 3;           // [16]
  const int t0 = blockIdx.x * GEMM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(GEMM_ROWS, Ta - t0);
  const size_t head = ((size_t)b * sh.H + h) * Ta;

  xa_load_norm<T>(xa + (size_t)b * Ta * D, Ta, t0, D, plog, sh.B * Ta,
                  b * Ta, w.p[KN_B2], xs, mn, sh);
  // v: the head's columns D + h HD .., raw, rounded
  xa_head_proj<T, HD>(xs, D, w.p[KP_W], w.p[KP_B], 2 * D, D + h * HD, 1.0f,
                  hs, HD, wt);
  for (int e = threadIdx.x; e < rows * HD; e += blockDim.x)
    vout[(head + t0) * HD + e] = from_f32<T>(hs[e]);
  // k: scaled, rotated by ||xa row||, head-normed
  xa_head_proj<T, HD>(xs, D, w.p[KP_W], w.p[KP_B], 2 * D, h * HD,
                  sh.qk_scale, ks, (HD + 1), wt);
  xa_rotate<T, HD>(ks, (HD + 1), mn, t0, freqs);
  abby_tile_inblock<T>(ks, (HD + 1), HD, w.p[HN_W1], w.p[HN_B1],
                       w.p[HN_W2], w.p[HN_B2], hs, lgs, wt, rows, sh.size_h,
                       sh.alpha, sh.k, sh.beta);
  for (int e = threadIdx.x; e < rows * HD; e += blockDim.x)
    kout[(head + t0) * HD + e] =
        from_f32<T>(ks[(e / HD) * (HD + 1) + e % HD]);
}

// Launch 3: the q side of one (16-row tile, head, batch) and its
// attention over the head's K/V; writes the heads' outputs o (B, T, D).
template <typename T, int HD>
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
  float* hs = qs + GEMM_ROWS * (HD + 1);       // [16][HD]
  float* lgs = hs + GEMM_ROWS * HD;       // [16][3]
  float* mn = lgs + GEMM_ROWS * 3;           // [16]
  float* kt = mn + GEMM_ROWS;                // [KT][HD + 1]: K, then V
  float* ps = kt + XA_KT * (HD + 1);         // [16][KT + 1]
  const int t0 = blockIdx.x * GEMM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(GEMM_ROWS, Tq - t0);

  xa_load_norm<T>(x + (size_t)b * Tq * D, Tq, t0, D, plog, sh.B * Tq,
                  b * Tq, w.p[QN_B2], xs, mn, sh);
  xa_head_proj<T, HD>(xs, D, w.p[QP_W], w.p[QP_B], D, h * HD, sh.qk_scale, qs,
                  (HD + 1), wt);
  xa_rotate<T, HD>(qs, (HD + 1), mn, t0, freqs);
  abby_tile_inblock<T>(qs, (HD + 1), HD, w.p[HN_W1], w.p[HN_B1],
                       w.p[HN_W2], w.p[HN_B2], hs, lgs, wt, rows, sh.size_h,
                       sh.alpha, sh.k, sh.beta);
  const size_t head = ((size_t)b * sh.H + h) * sh.Tk * HD;
  xa_attend<T, HD>(qs, kc + head, vc + head,
               valid ? valid + (size_t)b * sh.Tk : nullptr, t0, Tq, sh.Tk,
               sh.causal, sh.sm_scale, kt, ps,
               o + (size_t)b * Tq * D + h * HD, D);
}

template <typename T, int HD>
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
    const size_t smem_kv = sizeof(float) * xa_kv_smem_floats(D, HD);
    cudaFuncSetAttribute(xattn_kv<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_kv);
    xattn_kv<T, HD><<<dim3((sh.Tk + GEMM_ROWS - 1) / GEMM_ROWS, sh.H, sh.B), 256,
                  smem_kv, st>>>((const T*)xa, w, (const float*)plog_kv,
                                 (const float*)freqs, (T*)kbuf, (T*)vbuf, sh);
    kc = kbuf;
    vc = vbuf;
  }

  const size_t smem_q = sizeof(float) * xa_q_smem_floats(D, HD);
  cudaFuncSetAttribute(xattn_q_attend<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_q);
  xattn_q_attend<T, HD><<<dim3((sh.T + GEMM_ROWS - 1) / GEMM_ROWS, sh.H, sh.B),
                      256, smem_q, st>>>(
      (const T*)x, w, (const float*)plog_q, (const float*)freqs,
      (const T*)kc, (const T*)vc, (const uint8_t*)valid, (T*)o, sh);

  launch_linear_rows<T, LIN_NONE>(o, wp[OP_W], wp[OP_B], out, Nq, D, D, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Full calls in bf16 on the tensor cores: two launches.
//
// Launch 1 (xattn_full_rows): a cluster of abby_cluster_size(D) CTAs per
// 32-row tile of one side -- x with q_norm (tiles_q clusters), then xa
// with kv_norm.  The cluster first norms its tile (abby_cluster_tile: the
// router product sliced over the CTAs, the tail once a row) into xn;
// after a cluster barrier each CTA takes whole heads of HD = 128 or 256
// columns (units): a q or k head is its projection, the scale, the
// rotary and the head's own AbbyNormal (router HD x HD on the tensor
// cores, 128 columns a product, tail from the tile in shared memory),
// written to (B, H, S, HD); a v head is its raw projection.  The q side
// has H units, the kv side 2H.
// Launch 2 (xattn_full_attend): a cluster of min(H, 8) CTAs per (16-query
// tile, batch row), one a head (CTA r takes heads r, r + 8, ... past 8
// heads): the tile's scores against every key of the head (at most
// XA_TC_MAX_KEYS, held in shared memory), the exact softmax in one pass,
// the normalised weights rounded to bf16 as the reference rounds them,
// the PV product, the head's rounded output pushed into every CTA of the
// cluster (distributed shared memory), and after a cluster barrier each
// CTA's 128-column blocks of out_proj.
constexpr int XA_TC_MAX_KEYS = 1024;  // the gate admits Ta <= 1024 (D 128)
constexpr int XA_ST = 3;              // k chunks in flight
// bf16 row of a head tile
__host__ __device__ constexpr int xa_tld(int HD) { return HD + 8; }

// the second launch's ring: score blocks (K rows) and PV (V rows)
__host__ __device__ constexpr int xa_att_ring_elems() {
  return tc_ring_elems(1, 2, true, false, XA_ST) >
                 tc_ring_elems(1, 2, true, true, XA_ST)
             ? tc_ring_elems(1, 2, true, false, XA_ST)
             : tc_ring_elems(1, 2, true, true, XA_ST);
}

__host__ __device__ constexpr size_t xa_align(size_t b) {
  return (b + 127) / 128 * 128;
}

// launch 1's phase-2 buffers: the ring, the head tile [32][TLD] bf16,
// ||row|| [32], the head norm's partial logits [4][32][3], routes [32]
__host__ __device__ constexpr size_t xa_rows_unit_bytes(int HD) {
  return xa_align(sizeof(bf16) * tc_ring_elems(2, 4, false, false, XA_ST)) +
         xa_align(sizeof(bf16) * AB_ROWS * xa_tld(HD)) +
         sizeof(float) * (AB_ROWS + 4 * AB_ROWS * 3) + sizeof(int) * AB_ROWS;
}
__host__ __device__ constexpr size_t xa_rows_smem(int D, int HD) {
  return abby_smem_bytes(ASR_BF16, D) > xa_rows_unit_bytes(HD)
             ? abby_smem_bytes(ASR_BF16, D)
             : xa_rows_unit_bytes(HD);
}

// keys padded to whole 128-key score blocks
__host__ __device__ constexpr int xa_keys_pad(int Ta) {
  return (Ta + 127) / 128 * 128;
}
// launch 2: the ring, Q [16][TLD], the heads [16][D + 8], the scores
// [16][Tp] f32, the weights [16][Tp + 8] bf16
__host__ __device__ constexpr size_t xa_attend_smem(int D, int Ta, int HD) {
  return xa_align(sizeof(bf16) * xa_att_ring_elems()) +
         xa_align(sizeof(bf16) * 16 * xa_tld(HD)) +
         xa_align(sizeof(bf16) * 16 * (D + 8)) +
         xa_align(sizeof(float) * 16 * xa_keys_pad(Ta)) +
         sizeof(bf16) * 16 * (xa_keys_pad(Ta) + 8);
}

struct XaRowsArgs {
  const bf16* x[2];         // the sides' inputs: x, xa
  int n[2], s[2];           // rows B * S and positions S of each side
  bf16* xn[2];              // the normed rows
  bf16* head[2];            // q (B, H, T, HD) and k (B, H, Ta, HD)
  bf16* v;                  // (B, H, Ta, HD)
  int tiles_q, vec[2];
};

// one unit of launch 1: head u of the side (kv: u >= H is v head u - H)
// for the cluster's 32 rows from row r0
template <int HD>
__device__ void xa_rows_unit(const XaRowsArgs& a, const XaW<bf16>& w,
                             const float* __restrict__ freqs, int kv, int u,
                             int r0, const XaShape& sh,
                             unsigned char* smem) {
  constexpr int TLD = xa_tld(HD);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int D = sh.D, H = sh.H, N = a.n[kv], S = a.s[kv];
  const int rows = min(AB_ROWS, N - r0);
  const bool is_v = kv && u >= H;
  const int h = is_v ? u - H : u;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* ts = reinterpret_cast<bf16*>(
      smem + xa_align(sizeof(bf16) * tc_ring_elems(2, 4, false, false, XA_ST)));
  float* mn = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ts) +
      xa_align(sizeof(bf16) * AB_ROWS * TLD));
  float* pl = mn + AB_ROWS;                  // [4][32][3]
  int* chs = reinterpret_cast<int*>(pl + 4 * AB_ROWS * 3);
  const bf16* wp = w.p[kv ? KP_W : QP_W];
  const bf16* bp = w.p[kv ? KP_B : QP_B];
  const int col0 = (is_v ? D : 0) + h * HD;

  // ||row|| of the side's input, for the rotary
  if (!is_v)
    for (int r = warp; r < AB_ROWS; r += 8) {
      float sq = 0.0f;
      if (r < rows)
        for (int j = lane; j < D; j += 32) {
          const float v = to_f32(a.x[kv][(size_t)(r0 + r) * D + j]);
          sq += v * v;
        }
      sq = warp_sum(sq);
      if (lane == 0) mn[r] = sq > 0.0f ? sqrtf(sq) : 0.0f;
    }
  float acc[4][4];
  for (int hc = 0; hc < HD; hc += 128) {     // 128 columns a product
    tc_gemm<2, 4, false, false, XA_ST>(a.xn[kv] + (size_t)r0 * D, D, rows,
                                       wp + (size_t)(col0 + hc) * D, D, 128,
                                       D, ring, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = tc_row<2>(e), c = hc + tc_col<2, 4>(j, e);
        float v0 = acc[j][e] + to_f32(bp[col0 + c]);
        float v1 = acc[j][e + 1] + to_f32(bp[col0 + c + 1]);
        if (is_v) {
          if (r < rows) {
            const int g = r0 + r, b = g / S, p = g % S;
            *reinterpret_cast<__nv_bfloat162*>(
                a.v + (((size_t)b * H + h) * S + p) * HD + c) =
                __floats2bfloat162_rn(v0, v1);
          }
          continue;
        }
        // scale, then the pair (c, c + 1) rotated at angle p f_(c / 2) by
        // m = ||row||, rounded (xa_rotate)
        v0 *= sh.qk_scale;
        v1 *= sh.qk_scale;
        const float f = (float)((r0 + r) % S) * freqs[c / 2];
        const float mc = mn[r] * cosf(f), ms = mn[r] * sinf(f);
        *reinterpret_cast<__nv_bfloat162*>(ts + r * TLD + c) =
            __floats2bfloat162_rn(v0 * mc + v1 * (-ms), v1 * mc + v0 * ms);
      }
  }
  if (is_v) return;

  // the head's AbbyNormal: h = silu(ts W1^T + b1) rounded, partial logits
  // of the warp's 32 columns of each 128, summed over the 4 lanes of a row
  const bf16* b1 = w.p[HN_B1];
  const bf16* w2 = w.p[HN_W2];
  float p[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  for (int hc = 0; hc < HD; hc += 128) {
    tc_gemm<2, 4, true, false, XA_ST>(ts, TLD, AB_ROWS,
                                      w.p[HN_W1] + (size_t)hc * HD, HD, 128,
                                      HD, ring, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = hc + tc_col<2, 4>(j, e);
        const float hv =
            to_f32(from_f32<bf16>(siluf_(acc[j][e] + to_f32(b1[c]))));
#pragma unroll
        for (int q = 0; q < 3; ++q) p[e >> 1][q] += hv * to_f32(w2[q * HD + c]);
      }
  }
  const int wn = warp / 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float v = p[hh][q];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        pl[(wn * AB_ROWS + tc_row<2>(2 * hh)) * 3 + q] = v;
    }
  __syncthreads();
  // each row's route: argmax(logits + cv), the first maximum on ties
  for (int r = warp; r < rows; r += 8) {
    const float cv = abby_row_cv(ts + r * TLD, HD, lane);
    if (lane == 0) {
      int best = 0;
      float bv = 0.0f;
      for (int q = 0; q < 3; ++q) {
        float s = 0.0f;
        for (int g = 0; g < 4; ++g) s += pl[(g * AB_ROWS + r) * 3 + q];
        const float v = (s + to_f32(w.p[HN_B2][q])) + cv;
        if (q == 0 || v > bv) {
          bv = v;
          best = q;
        }
      }
      chs[r] = best;
    }
  }
  __syncthreads();
  bf16* out = a.head[kv];
  for (int it = t; it < rows * (HD / 8); it += 256) {
    const int r = it / (HD / 8), j0 = (it % (HD / 8)) * 8;
    const int g = r0 + r, b = g / S, pp = g % S;
    bf16* orow = out + (((size_t)b * H + h) * S + pp) * HD;
    if (sh.size_h == 7)             // window_size(128)
      abby_tail8_sized<7>(ts + r * TLD, j0, HD, chs[r], sh.alpha, sh.k,
                          sh.beta, orow, (const bf16*)nullptr);
    else if (sh.size_h <= ABBY_REG_TAPS)
      abby_tail8<ABBY_REG_TAPS>(ts + r * TLD, j0, HD, sh.size_h, chs[r],
                                sh.alpha, sh.k, sh.beta, orow,
                                (const bf16*)nullptr);
    else
      abby_tail8_wide(ts + r * TLD, j0, HD, sh.size_h, chs[r], sh.alpha,
                      sh.k, sh.beta, orow, (const bf16*)nullptr);
  }
}

template <int HD>
__global__ void __launch_bounds__(AB_THREADS, 2)
xattn_full_rows(XaRowsArgs a, XaW<bf16> w, const float* __restrict__ freqs,
                XaShape sh) {
  extern __shared__ __align__(128) unsigned char xa_smem[];
  const int kv = (int)blockIdx.y >= a.tiles_q;
  const int r0 = (blockIdx.y - (kv ? a.tiles_q : 0)) * AB_ROWS;
  const int S = (int)gridDim.x, rank = (int)blockIdx.x;
  abby_cluster_tile<bf16>(a.x[kv], w.p[kv ? KN_W1 : QN_W1],
                          w.p[kv ? KN_B1 : QN_B1], w.p[kv ? KN_W2 : QN_W2],
                          w.p[kv ? KN_B2 : QN_B2], nullptr, a.xn[kv],
                          a.n[kv], sh.D, sh.size_d, sh.alpha, sh.k, sh.beta,
                          a.vec[kv], r0, xa_smem);
  // every CTA's rows of the normed tile are written (and this CTA's
  // shared memory is no longer read by the others)
  __threadfence();
  cluster_arrive();
  cluster_wait();
  const int units = kv ? 2 * sh.H : sh.H;
  for (int u = rank; u < units; u += S)
    xa_rows_unit<HD>(a, w, freqs, kv, u, r0, sh, xa_smem);
}

// the CTAs of a launch-2 cluster: one a head, at most 8 (CTA r takes the
// heads r, r + 8, ...)
__host__ __device__ constexpr int xa_attend_cluster(int H) {
  return H < 8 ? H : 8;
}

template <int HD>
__global__ void __launch_bounds__(256)
xattn_full_attend(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
                  const bf16* __restrict__ vh,
                  const uint8_t* __restrict__ valid, XaW<bf16> w,
                  bf16* __restrict__ out, XaShape sh) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char xa_smem[];
  cluster_arrive_relaxed();             // waited on before the first push
  const int t = threadIdx.x;
  const int rank = (int)blockIdx.x, S = (int)gridDim.x;
  const int t0 = blockIdx.y * 16, b = blockIdx.z;
  const int D = sh.D, H = sh.H, T = sh.T, Ta = sh.Tk;
  constexpr int TLD = xa_tld(HD);
  const int Tp = xa_keys_pad(Ta), ldc = D + 8, ldp = Tp + 8;
  const int rows = min(16, T - t0);
  const size_t ring_b = xa_align(
      sizeof(bf16) * xa_att_ring_elems());
  bf16* ring = reinterpret_cast<bf16*>(xa_smem);
  bf16* qs = reinterpret_cast<bf16*>(xa_smem + ring_b);
  bf16* cat = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(qs) +
      xa_align(sizeof(bf16) * 16 * TLD));
  float* sc = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(cat) +
      xa_align(sizeof(bf16) * 16 * ldc));
  bf16* ps = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(sc) +
      xa_align(sizeof(float) * 16 * Tp));
  const uint8_t* vrow = valid ? valid + (size_t)b * Ta : nullptr;
  float acc[2][4];

  for (int h = rank; h < H; h += S) {
    const size_t hq = ((size_t)b * H + h) * T, hk = ((size_t)b * H + h) * Ta;
    for (int e = t; e < 16 * (HD / 8); e += 256) {
      const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
      const bool in = r < rows;
      cp_async16(qs + r * TLD + c, in ? qh + (hq + t0 + r) * HD + c : qh, in);
    }
    cp_async_commit();
    cp_async_wait<0>();

    // scores of the tile's rows against blocks of 128 keys, scaled and
    // masked (-1e30); keys past Ta take no weight at all
    for (int k0 = 0; k0 < Ta; k0 += 128) {
      tc_gemm<1, 2, true, false, XA_ST>(qs, TLD, 16, kh + (hk + k0) * HD,
                                        HD, min(128, Ta - k0), HD, ring,
                                        acc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = tc_row<1>(e), kj = k0 + tc_col<1, 2>(j, e);
          float s = -INFINITY;
          if (kj < Ta) {
            bool masked = sh.causal && kj > t0 + r + Ta - T;
            if (vrow && !vrow[kj]) masked = true;
            s = masked ? XA_MASKED : acc[j][e] * sh.sm_scale;
          }
          sc[r * Tp + kj] = s;
        }
    }
    __syncthreads();
    // the exact softmax of each row, 16 threads a row; the normalised
    // weights rounded to bf16 (zero past Ta, up to Tp)
    {
      const int r = t / 16, tx = t % 16;
      const float* sr = sc + r * Tp;
      float mx = -INFINITY;
      for (int kj = tx; kj < Ta; kj += 16) mx = fmaxf(mx, sr[kj]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int kj = tx; kj < Ta; kj += 16) sum += expf(sr[kj] - mx);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int kj = tx; kj < Tp; kj += 16)
        ps[r * ldp + kj] = kj < Ta ? from_f32<bf16>(expf(sr[kj] - mx) / sum)
                                   : from_f32<bf16>(0.0f);
    }
    // the head's output, 128 columns a product: weights times V (keys
    // past Ta read as 0), rounded, into every CTA's copy of the tile's
    // heads
    for (int hc = 0; hc < HD; hc += 128) {
      tc_gemm<1, 2, true, true, XA_ST>(ps, ldp, 16, vh + hk * HD + hc, HD,
                                       128, Ta, ring, acc);
      if (h == rank && hc == 0) cluster_wait();   // every CTA has started
      for (int q = 0; q < S; ++q) {
        bf16* dst = cl.map_shared_rank(cat, q);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = tc_row<1>(e), c = hc + tc_col<1, 2>(j, e);
            *reinterpret_cast<__nv_bfloat162*>(dst + r * ldc + h * HD + c) =
                __floats2bfloat162_rn(acc[j][e], acc[j][e + 1]);
          }
      }
    }
  }
  cluster_arrive();
  cluster_wait();
  // out_proj: this CTA's 128-column blocks of the tile's rows
  const bf16* ob = w.p[OP_B];
  for (int c0 = rank * 128; c0 < D; c0 += S * 128) {
    tc_gemm<1, 2, true, false, XA_ST>(cat, ldc, 16,
                                      w.p[OP_W] + (size_t)c0 * D, D, 128, D,
                                      ring, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = tc_row<1>(e), c = c0 + tc_col<1, 2>(j, e);
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((size_t)b * T + t0 + r) * D + c) =
              __floats2bfloat162_rn(acc[j][e] + to_f32(ob[c]),
                                    acc[j][e + 1] + to_f32(ob[c + 1]));
      }
  }
}

// ---------------------------------------------------------------------
// Cached calls in bf16 on the tensor cores: two launches.
//
// Launch 1 is xattn_full_rows over the q side alone (q_norm once a row,
// then whole heads: projection, scale, rotary, head norm) -> qh (B, H, T,
// HD).  Launch 2 (xattn_cached_attend): a cluster of NS CTAs per
// (QR-query tile, head, batch row) splits the head's Tk cached keys, CTA
// r taking keys [r kpc, (r + 1) kpc).  Each CTA streams its K and then
// its V in 128-key blocks through a cp.async ring (two slots, so the next
// block loads while one is multiplied; one slot where a CTA has one block
// of each, its V then loading behind the softmax), keeps its f32 scores in
// shared memory (in log2 units), and takes each row's maximum over its
// keys and the exponentials against it (kept in place of the scores)
// with their sum.  One exchange over distributed shared memory gives
// every CTA every CTA's pair; the row's maximum and its sum (the CTAs'
// sums rescaled, added in rank order) are then the same in every CTA,
// so the softmax is exact in one pass over the keys and each CTA
// normalises its weights (one product each: the exponential times the
// row's 2^(local max - max) / sum) and rounds them to bf16 as the
// reference does, in place over the scores.  (At the flagship's width
// 65 this fits two CTAs an SM: 256 CTAs in one wave.)
// Each CTA's PV product over its keys goes to the CTA that owns the row
// (DSMEM), which adds the NS partials in rank order (deterministic),
// rounds the head's output and pushes it to every CTA of the cluster.
// Each CTA then takes 64-column blocks of the head's share of out_proj,
// o_h Wo[:, h HD .. h HD + HD)^T, into an f32 workspace; the cluster
// that finishes a (query tile, batch row) last among its H heads (a
// counter, after __threadfence, reset by that cluster) adds the H shares
// in head order, the bias, and writes the rows.  Keys past Tk take no
// weight; masked keys -1e30, so a fully masked row is the mean of V.
constexpr int XC_KB = 128;            // keys a ring block
constexpr int XC_MAXQR = 80;          // query rows a CTA at most

__host__ __device__ constexpr int xc_imax(int a, int b) { return a > b ? a : b; }
// keys a CTA takes: whole blocks
__host__ __device__ constexpr int xc_kpc(int Tk, int NS) {
  return ((Tk + NS - 1) / NS + XC_KB - 1) / XC_KB * XC_KB;
}
// ring slots: two, or one for a CTA with one K and one V block
__host__ __device__ constexpr int xc_slots(int kpc) {
  return kpc > XC_KB ? 2 : 1;
}
// rows of the partial outputs each CTA owns in the reduction
__host__ __device__ constexpr int xc_per(int QR, int NS) {
  return (QR + NS - 1) / NS;
}
// the score region: f32 scores [QR][kpc + 4] (then the bf16 weights in
// place), later the partial outputs pushed here [NS][per][HD] f32
__host__ __device__ constexpr size_t xc_sc_bytes(int QR, int kpc, int NS,
                                                 int HD) {
  return xa_align((size_t)xc_imax(4 * QR * (kpc + 4),
                                  4 * NS * xc_per(QR, NS) * HD));
}
// the Q tile (later the head's output) [QR][TLD] and the ring
// [slots][KB][TLD] (later 64-row blocks of Wo) bf16, the score region, and
// f32 [19][QR]: each row's local maximum and sum, the factor of its
// weights, and every CTA's maxima and sums as read over DSMEM
__host__ __device__ constexpr size_t xc_attend_smem(int QR, int kpc, int NS,
                                                    int HD) {
  return xa_align(sizeof(bf16) * QR * xa_tld(HD)) +
         xa_align(sizeof(bf16) * xc_slots(kpc) * XC_KB * xa_tld(HD)) +
         xc_sc_bytes(QR, kpc, NS, HD) + sizeof(float) * 19 * QR;
}

template <int HD>
__global__ void __launch_bounds__(256)
xattn_cached_attend(const bf16* __restrict__ qh, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc,
                    const uint8_t* __restrict__ valid,
                    const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                    float* __restrict__ part, bf16* __restrict__ out,
                    int* __restrict__ counters, XaShape sh, int QR) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char xa_smem[];
  __shared__ int s_last;
  // warp w's 16-column groups of the head in the PV product
  constexpr int TLD = xa_tld(HD), NDW = HD / 128;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int NS = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int qt = blockIdx.y, t0 = qt * QR, bh = blockIdx.z;
  const int H = sh.H, b = bh / H, h = bh % H, T = sh.T, Tk = sh.Tk, D = sh.D;
  const int rows = min(QR, T - t0), mq = QR / 16;
  const int kpc = xc_kpc(Tk, NS), ldsc = kpc + 4, ldp = 2 * ldsc;
  const int nst = xc_slots(kpc);
  const int k_beg = rank * kpc, k_end = min(Tk, k_beg + kpc);
  const int nk = max(0, k_end - k_beg), nb = (nk + XC_KB - 1) / XC_KB;
  bf16* qs = reinterpret_cast<bf16*>(xa_smem);   // [QR][TLD]
  bf16* ohs = qs;                                // then the head's output
  bf16* ring = reinterpret_cast<bf16*>(
      xa_smem + xa_align(sizeof(bf16) * QR * TLD));
  bf16* wsm = ring;                              // then [64][TLD] of Wo
  unsigned char* scb = reinterpret_cast<unsigned char*>(ring) +
                       xa_align(sizeof(bf16) * nst * XC_KB * TLD);
  float* sc = reinterpret_cast<float*>(scb);   // [QR][ldsc]
  bf16* ps = reinterpret_cast<bf16*>(scb);     // then [QR][ldp], in place
  float* recv = sc;                            // then [NS][per][HD]
  float* lmax = reinterpret_cast<float*>(scb + xc_sc_bytes(QR, kpc, NS, HD));
  float* lsum = lmax + QR;
  float* wf = lsum + QR;                       // the weights' factor
  float* xmax = wf + QR;                       // [8][QR]
  float* xsum = xmax + 8 * QR;                 // [8][QR]
  const size_t hq = (size_t)bh * T, hk = (size_t)bh * Tk;
  const uint8_t* vrow = valid ? valid + (size_t)b * Tk : nullptr;
  const float sm_scale_log2 = sh.sm_scale * 1.4426950408889634f;

  // the Q tile (rows past the call's read as 0), one commit group
  for (int e = t; e < QR * (HD / 8); e += 256) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    const bool in = r < rows;
    cp_async16(qs + r * TLD + c, in ? qh + (hq + t0 + r) * HD + c : qh, in);
  }
  // job j < nb: K block j; nb <= j < 2 nb: V block j - nb; one commit
  // group a job (empty past the last), ring slot j % nst
  auto load = [&](int j) {
    if (j < 2 * nb) {
      const bf16* src = j < nb ? kc : vc;
      const int kb = k_beg + (j % nb) * XC_KB;
      bf16* dst = ring + (j % nst) * XC_KB * TLD;
      for (int e = t; e < XC_KB * (HD / 8); e += 256) {
        const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
        const bool in = kb + r < k_end;
        cp_async16(dst + r * TLD + c,
                   in ? src + (hk + kb + r) * HD + c : src, in);
      }
    }
    cp_async_commit();
  };
  load(0);                                     // with the Q tile
  // job c has landed for every thread; with two slots the next job loads
  // while this one runs, with one after it
  auto next = [&](int c) {
    cp_async_wait<0>();
    __syncthreads();
    if (nst == 2) load(c + 1);
  };
  auto after = [&](int c) {
    if (nst == 1) {
      __syncthreads();
      load(c + 1);
    }
  };

  // scores: warp w takes 16 keys of a block for every 16-row m tile
  for (int c = 0; c < nb; ++c) {
    next(c);
    const bf16* kt = ring + (c % nst) * XC_KB * TLD;
    float acc[XC_MAXQR / 16][2][4];
#pragma unroll
    for (int m = 0; m < XC_MAXQR / 16; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t bfr[4];
      ldsm_x4(bfr, kt + (16 * warp + (lm >> 1) * 8 + lr) * TLD + kk +
                       (lm & 1) * 8);
#pragma unroll
      for (int m = 0; m < XC_MAXQR / 16; ++m)
        if (m < mq) {
          uint32_t af[4];
          ldsm_x4(af, qs + (16 * m + (lane & 15)) * TLD + kk +
                          (lane >> 4) * 8);
          mma_bf16(acc[m][0], af, bfr[0], bfr[1]);
          mma_bf16(acc[m][1], af, bfr[2], bfr[3]);
        }
    }
    const int kb = c * XC_KB;                  // local key of the block
#pragma unroll
    for (int m = 0; m < XC_MAXQR / 16; ++m)
      if (m < mq)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * m + g + 8 * (e >> 1);
            const int kl = kb + 16 * warp + 8 * j + 2 * tg + (e & 1);
            const int key = k_beg + kl;
            float s = -INFINITY;
            if (kl < nk)
              s = (vrow && !vrow[key]) ? XA_MASKED
                                       : acc[m][j][e] * sm_scale_log2;
            sc[r * ldsc + kl] = s;
          }
    after(c);
  }
  __syncthreads();

  // each row's maximum over this CTA's keys, the exponentials against it
  // in place of the scores, and their sum; 16 threads a row (-inf and 0
  // for a CTA without keys)
  for (int r0 = 0; r0 < QR; r0 += 16) {
    const int r = r0 + t / 16, tx = t % 16;
    float* sr = sc + r * ldsc;
    float mx = -INFINITY;
    for (int kl = tx; kl < nk; kl += 16) mx = fmaxf(mx, sr[kl]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int kl = tx; kl < nk; kl += 16) {
      const float p = exp2f(sr[kl] - mx);
      sr[kl] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) {
      lmax[r] = mx;
      lsum[r] = sum;
    }
  }
  // every CTA's pair of each row, all the remote loads in flight at once;
  // then the row's maximum, and its sum in rank order
  cluster_arrive();
  cluster_wait();
  for (int e = t; e < NS * QR; e += 256) {
    xmax[e] = cl.map_shared_rank(lmax, e / QR)[e % QR];
    xsum[e] = cl.map_shared_rank(lsum, e / QR)[e % QR];
  }
  __syncthreads();
  // each row's factor from this CTA's exponentials to its weights:
  // 2^(local max - max) / sum
  for (int r = t; r < QR; r += 256) {
    float mx = -INFINITY;
    for (int q = 0; q < NS; ++q) mx = fmaxf(mx, xmax[q * QR + r]);
    float l = 0.0f;
    for (int q = 0; q < NS; ++q)
      l += xsum[q * QR + r] * exp2f(xmax[q * QR + r] - mx);
    wf[r] = exp2f(lmax[r] - mx) / l;
  }
  __syncthreads();
  // the normalised weights, rounded to bf16 (zero past this CTA's keys),
  // in place: a warp a row, four keys a lane; keys k4 .. k4 + 3 are read
  // (f32 at bytes 4 k4 ..) before the warp writes them (bf16 at 2 k4 ..)
  for (int r = warp; r < QR; r += 8) {
    const float f = wf[r];
    for (int k4 = 4 * lane; k4 < nb * XC_KB; k4 += 128) {
      const float4 v = *reinterpret_cast<const float4*>(sc + r * ldsc + k4);
      __syncwarp();
      const float p[4] = {v.x, v.y, v.z, v.w};
      __nv_bfloat162 w2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w2[i] = __floats2bfloat162_rn(k4 + 2 * i < nk ? p[2 * i] * f : 0.0f,
                                      k4 + 2 * i + 1 < nk ? p[2 * i + 1] * f
                                                          : 0.0f);
      *reinterpret_cast<uint2*>(ps + r * ldp + k4) =
          *reinterpret_cast<const uint2*>(w2);
    }
  }
  __syncthreads();

  // PV over this CTA's keys: warp w takes the head's columns 16 NDW w ..
  // + 16 NDW - 1
  float acc[XC_MAXQR / 16][2 * NDW][4];
#pragma unroll
  for (int m = 0; m < XC_MAXQR / 16; ++m)
#pragma unroll
    for (int j = 0; j < 2 * NDW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
  for (int c = nb; c < 2 * nb; ++c) {
    next(c);
    const bf16* vt = ring + (c % nst) * XC_KB * TLD;
    const int kb = (c - nb) * XC_KB;
#pragma unroll
    for (int kk = 0; kk < XC_KB; kk += 16) {
      uint32_t bfr[NDW][4];
#pragma unroll
      for (int dg = 0; dg < NDW; ++dg)
        ldsm_x4_t(bfr[dg], vt + (kk + (lm & 1) * 8 + lr) * TLD +
                               16 * (NDW * warp + dg) + (lm >> 1) * 8);
#pragma unroll
      for (int m = 0; m < XC_MAXQR / 16; ++m)
        if (m < mq) {
          uint32_t af[4];
          ldsm_x4(af, ps + (16 * m + (lane & 15)) * ldp + kb + kk +
                          (lane >> 4) * 8);
#pragma unroll
          for (int dg = 0; dg < NDW; ++dg) {
            mma_bf16(acc[m][2 * dg], af, bfr[dg][0], bfr[dg][1]);
            mma_bf16(acc[m][2 * dg + 1], af, bfr[dg][2], bfr[dg][3]);
          }
        }
    }
    after(c);
  }
  cp_async_wait<0>();
  // every CTA is done with its scores, weights and ring: the partials go
  // to the rows' owners (over the owners' score regions)
  cluster_arrive();
  cluster_wait();
  const int per = xc_per(QR, NS);
#pragma unroll
  for (int m = 0; m < XC_MAXQR / 16; ++m)
    if (m < mq)
#pragma unroll
      for (int j = 0; j < 2 * NDW; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = 16 * m + g + 8 * (e >> 1), q = r / per;
          const int col = 16 * NDW * warp + 8 * j + 2 * tg;
          float* dst = cl.map_shared_rank(recv, q) +
                       ((size_t)rank * per + r - q * per) * HD + col;
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[m][j][e], acc[m][j][e + 1]);
        }
  cluster_arrive();
  cluster_wait();
  // this CTA's rows of the head's output: the partials in rank order,
  // rounded, into every CTA's copy (over the Q tiles)
  const int lr0 = rank * per, nown = max(0, min(per, rows - lr0));
  for (int e = t; e < nown * (HD / 2); e += 256) {
    const int rr = e / (HD / 2), col = 2 * (e % (HD / 2));
    float s0 = 0.0f, s1 = 0.0f;
    for (int q = 0; q < NS; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(
          recv + ((size_t)q * per + rr) * HD + col);
      s0 += v.x;
      s1 += v.y;
    }
    const __nv_bfloat162 v2 = __floats2bfloat162_rn(s0, s1);
    for (int q = 0; q < NS; ++q)
      *reinterpret_cast<__nv_bfloat162*>(cl.map_shared_rank(ohs, q) +
                                         (lr0 + rr) * TLD + col) = v2;
  }
  cluster_arrive();
  cluster_wait();
  // the head's share of out_proj for this CTA's 64-column blocks: warp w
  // takes 8 columns of the block for every m tile, K = HD (the head's
  // columns of Wo)
  // (every block's Wo rows requested at once, as many as the ring holds)
  float* pb = part + (((size_t)b * gridDim.y + qt) * H + h) * QR * D;
  const int WB = nst * XC_KB / 64;
  for (int c0 = 64 * rank, i = 0; c0 < D && i < WB; c0 += 64 * NS, ++i)
    for (int e = t; e < 64 * (HD / 8); e += 256) {
      const int n = e / (HD / 8), c = (e % (HD / 8)) * 8;
      cp_async16(wsm + (i * 64 + n) * TLD + c,
                 wo + (size_t)(c0 + n) * D + h * HD + c, true);
    }
  cp_async_commit();
  for (int c0 = 64 * rank, i = 0; c0 < D; c0 += 64 * NS, ++i) {
    if (i == WB) {                  // more blocks than the ring holds
      __syncthreads();
      for (int cc = c0, k = 0; cc < D && k < WB; cc += 64 * NS, ++k)
        for (int e = t; e < 64 * (HD / 8); e += 256) {
          const int n = e / (HD / 8), c = (e % (HD / 8)) * 8;
          cp_async16(wsm + (k * 64 + n) * TLD + c,
                     wo + (size_t)(cc + n) * D + h * HD + c, true);
        }
      cp_async_commit();
      i = 0;
    }
    cp_async_wait<0>();
    __syncthreads();
    const bf16* wblk = wsm + i * 64 * TLD;
    float pacc[XC_MAXQR / 16][4];
#pragma unroll
    for (int m = 0; m < XC_MAXQR / 16; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[m][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      uint32_t bfr[4];              // columns 8 w .., k kk .. kk + 31
      ldsm_x4(bfr, wblk + (8 * warp + lr) * TLD + kk + lm * 8);
#pragma unroll
      for (int m = 0; m < XC_MAXQR / 16; ++m)
        if (m < mq) {
          uint32_t af[4];
          ldsm_x4(af, ohs + (16 * m + (lane & 15)) * TLD + kk +
                          (lane >> 4) * 8);
          mma_bf16(pacc[m], af, bfr[0], bfr[1]);
          ldsm_x4(af, ohs + (16 * m + (lane & 15)) * TLD + kk + 16 +
                          (lane >> 4) * 8);
          mma_bf16(pacc[m], af, bfr[2], bfr[3]);
        }
    }
#pragma unroll
    for (int m = 0; m < XC_MAXQR / 16; ++m)
      if (m < mq)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = 16 * m + g + 8 * (e >> 1);
          if (r < rows)
            *reinterpret_cast<float2*>(pb + (size_t)r * D + c0 + 8 * warp +
                                       2 * tg) =
                make_float2(pacc[m][e], pacc[m][e + 1]);
        }
  }
  __threadfence();
  cluster_arrive();
  cluster_wait();
  // the last of the tile's H clusters to get here adds the heads' shares
  if (rank == 0 && t == 0) {
    int* cnt = counters + (size_t)b * gridDim.y + qt;
    const int last = atomicAdd(cnt, 1) == H - 1;
    if (last) *cnt = 0;                        // ready for the next call
    for (int q = 0; q < NS; ++q) *cl.map_shared_rank(&s_last, q) = last;
  }
  cluster_arrive();
  cluster_wait();
  if (!s_last) return;
  __threadfence();
  const float* p0 = part + ((size_t)b * gridDim.y + qt) * H * QR * D;
  for (int c0 = 64 * rank; c0 < D; c0 += 64 * NS)
#pragma unroll 4
    for (int e = t; e < rows * 32; e += 256) {
      const int r = e / 32, c = c0 + 2 * (e % 32);
      float s0 = 0.0f, s1 = 0.0f;
      for (int hh = 0; hh < H; ++hh) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(
            p0 + ((size_t)hh * QR + r) * D + c));
        s0 += v.x;
        s1 += v.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * T + t0 + r) * D +
                                         c) =
          __floats2bfloat162_rn(s0 + to_f32(bo[c]), s1 + to_f32(bo[c + 1]));
    }
}

template <int HD>
static int launch_xattn_full_tc(const void* x, const void* xa,
                                const void* valid, const void* freqs,
                                const void* const* wp, void* out, void* xn,
                                void* xan, void* qh, void* kh, void* vh,
                                const XaShape& sh, cudaStream_t st) {
  XaW<bf16> w;
  for (int i = 0; i < XA_NW; ++i) w.p[i] = (const bf16*)wp[i];
  const int D = sh.D;
  XaRowsArgs a;
  a.x[0] = (const bf16*)x;
  a.x[1] = (const bf16*)xa;
  a.n[0] = sh.B * sh.T;
  a.n[1] = sh.B * sh.Tk;
  a.s[0] = sh.T;
  a.s[1] = sh.Tk;
  a.xn[0] = (bf16*)xn;
  a.xn[1] = (bf16*)xan;
  a.head[0] = (bf16*)qh;
  a.head[1] = (bf16*)kh;
  a.v = (bf16*)vh;
  a.tiles_q = (a.n[0] + AB_ROWS - 1) / AB_ROWS;
  a.vec[0] = ((uintptr_t)x | (uintptr_t)wp[QN_W1]) % 16 == 0;
  a.vec[1] = ((uintptr_t)xa | (uintptr_t)wp[KN_W1]) % 16 == 0;
  const int S = abby_cluster_size(D);
  cudaError_t e = launch_clusters(
      xattn_full_rows<HD>,
      dim3(S, a.tiles_q + (a.n[1] + AB_ROWS - 1) / AB_ROWS, 1), S,
      xa_rows_smem(D, HD), st, a, w, (const float*)freqs, sh);
  if (e != cudaSuccess) return (int)e;
  const int SA = xa_attend_cluster(sh.H);
  e = launch_clusters(xattn_full_attend<HD>,
                      dim3(SA, (sh.T + 15) / 16, sh.B), SA,
                      xa_attend_smem(D, sh.Tk, HD), st, (const bf16*)qh,
                      (const bf16*)kh, (const bf16*)vh,
                      (const uint8_t*)valid, w, (bf16*)out, sh);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the two launches of a bf16 cached call (the design above
// xattn_cached_attend)
template <int HD>
static int launch_xattn_cached_tc(const void* x, const void* kc,
                                  const void* vc, const void* valid,
                                  const void* freqs, const void* const* wp,
                                  void* out, void* xn, void* qh, void* part,
                                  void* counters, const XaShape& sh, int QR,
                                  int NS, cudaStream_t st) {
  XaW<bf16> w;
  for (int i = 0; i < XA_NW; ++i) w.p[i] = (const bf16*)wp[i];
  const int D = sh.D;
  XaRowsArgs a = {};
  a.x[0] = a.x[1] = (const bf16*)x;
  a.n[0] = sh.B * sh.T;                       // no kv tiles
  a.s[0] = a.s[1] = sh.T;
  a.xn[0] = a.xn[1] = (bf16*)xn;
  a.head[0] = a.head[1] = (bf16*)qh;
  a.v = (bf16*)qh;
  a.tiles_q = (a.n[0] + AB_ROWS - 1) / AB_ROWS;
  a.vec[0] = ((uintptr_t)x | (uintptr_t)wp[QN_W1]) % 16 == 0;
  const int S = abby_cluster_size(D);
  cudaError_t e =
      launch_clusters(xattn_full_rows<HD>, dim3(S, a.tiles_q, 1), S,
                      xa_rows_smem(D, HD), st, a, w, (const float*)freqs, sh);
  if (e != cudaSuccess) return (int)e;
  e = launch_clusters(
      xattn_cached_attend<HD>, dim3(NS, (sh.T + QR - 1) / QR, sh.B * sh.H),
      NS, xc_attend_smem(QR, xc_kpc(sh.Tk, NS), NS, HD), st,
      (const bf16*)qh, (const bf16*)kc, (const bf16*)vc,
      (const uint8_t*)valid, w.p[OP_W], w.p[OP_B], (float*)part, (bf16*)out,
      (int*)counters, sh, QR);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// D = H HD with HD = 128 or 256, D <= ABBY_MAX_D
static int xattn_checks(int D, int H, int T, int Tk) {
  if (H < 1 || D % H || (D / H != XA_HD && D / H != XA_HD2) ||
      D > ABBY_MAX_D || T < 1 || Tk < 1)
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
  const double hd = (double)(D / H);
  sh.qk_scale = (float)pow(hd, -0.25);      // as the host computes
  sh.sm_scale = (float)(1.0 / sqrt(hd));
  return sh;
}

// Cached call.  x, out: (B, T, D); kc, vc: (B, H, Tk, HD), the processed
// K and raw V; valid: (B, Tk) bytes or null; freqs: (HD / 2,) f32 angular
// frequencies (the non-causal ladder); w: XA_NW weight pointers in
// XaWeight order (the KN_* / KP_* entries unused) -- all of one dtype (0 =
// f32, 1 = bf16).  D = HD H <= ABBY_MAX_D, HD = 128 or 256.
// tc (bf16 only, 16-byte aligned operands, windows of at most
// ABBY_MAX_TAPS): the two tensor-core launches with QR query rows (a
// multiple of 16, at most XC_MAXQR) and NS key-split CTAs (1..8) a
// cluster; workspace ws0 the normed rows (B, T, D) and ws1 qh (B, H, T,
// HD), bf16, ws2 the heads' shares of out_proj, B * ceil(T / QR) * H * QR
// * D f32, and counters B * ceil(T / QR) ints, zero (the kernel leaves
// them zero; calls that share them run in order).  Else
// the three CUDA-core launches: ws0 f32 of ceil(D / 64) * B * T * 3 (the
// q_norm router's partial logits), ws2 o (B, T, D) of the dtype.
ASR_API int asr_fused_attn_cached(int dtype, int tc, const void* x,
                                  const void* kc, const void* vc,
                                  const void* valid, const void* freqs,
                                  const void* const* w, void* out, void* ws0,
                                  void* ws1, void* ws2, void* counters, int B,
                                  int T, int Tk, int D, int H, int size_d,
                                  int size_h, float alpha, float k,
                                  float beta, int QR, int NS, void* stream) {
  const int bad = xattn_checks(D, H, T, Tk);
  if (bad) return bad;
  if (tc && (dtype != ASR_BF16 || QR < 16 || QR > XC_MAXQR || QR % 16 ||
             NS < 1 || NS > 8 || !counters || size_d < 1 ||
             size_d > ABBY_MAX_TAPS || size_h < 1 ||
             size_h > ABBY_MAX_TAPS || (long)B * H > 65535 ||
             ((long)B * T + AB_ROWS - 1) / AB_ROWS > 65535 ||
             (T + QR - 1) / QR > 65535 ||
             xc_attend_smem(QR, xc_kpc(Tk, NS), NS, D / H) > 232448))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const XaShape sh = xa_shape(B, T, Tk, D, H, 0, size_d, size_h, alpha, k,
                              beta);
  cudaStream_t st = (cudaStream_t)stream;
#define XA_CACHED(HD)                                                         \
  if (tc)                                                                     \
    return launch_xattn_cached_tc<HD>(x, kc, vc, valid, freqs, w, out, ws0,  \
                                      ws1, ws2, counters, sh, QR, NS, st);   \
  if (dtype == ASR_F32)                                                       \
    return launch_xattn<float, HD>(false, x, nullptr, kc, vc, valid, freqs,  \
                                   w, out, ws0, nullptr, nullptr, nullptr,    \
                                   ws2, sh, st);                              \
  return launch_xattn<bf16, HD>(false, x, nullptr, kc, vc, valid, freqs, w,  \
                                out, ws0, nullptr, nullptr, nullptr, ws2, sh, \
                                st)
  if (D / H == XA_HD2) {
    XA_CACHED(XA_HD2);
  }
  XA_CACHED(XA_HD);
#undef XA_CACHED
}

// Full call.  x, out: (B, T, D); xa: (B, Ta, D) (xa = x for
// self-attention); valid: (B, Ta) bytes or null; causal: bottom-right
// mask; freqs: (64,) f32, the ladder of both sides; w: all XA_NW weights.
// D = HD H, HD = 128 or 256.
// tc (bf16 only, Ta <= XA_TC_MAX_KEYS, 16-byte aligned operands): the two
// tensor-core launches, workspace ws0, ws1 the normed rows (B, T, D) and
// (B, Ta, D), ws2 q (B, H, T, HD), ws3 k and ws4 v (B, H, Ta, HD), all
// bf16.  Else the four CUDA-core launches of the cached call's design
// (xattn_routers, xattn_kv, xattn_q_attend, out_proj), workspace ws0 and
// ws1 f32 of ceil(D / 64) * B * T * 3 and ceil(D / 64) * B * Ta * 3, ws2,
// ws3 (B, H, Ta, HD) and ws4 (B, T, D) of the dtype.
ASR_API int asr_fused_attn_full(int dtype, int tc, const void* x,
                                const void* xa, const void* valid,
                                const void* freqs, const void* const* w,
                                void* out, void* ws0, void* ws1, void* ws2,
                                void* ws3, void* ws4, int B, int T, int Ta,
                                int D, int H, int causal, int size_d,
                                int size_h, float alpha, float k, float beta,
                                void* stream) {
  const int bad = xattn_checks(D, H, T, Ta);
  if (bad) return bad;
  if (tc && (dtype != ASR_BF16 || Ta > XA_TC_MAX_KEYS || size_d < 1 ||
             size_d > ABBY_MAX_TAPS || size_h < 1 ||
             size_h > ABBY_MAX_TAPS || B > 65535 ||
             ((long)B * T + AB_ROWS - 1) / AB_ROWS +
                     ((long)B * Ta + AB_ROWS - 1) / AB_ROWS >
                 65535))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const XaShape sh = xa_shape(B, T, Ta, D, H, causal, size_d, size_h, alpha,
                              k, beta);
  cudaStream_t st = (cudaStream_t)stream;
#define XA_FULL(HD)                                                          \
  if (tc)                                                                    \
    return launch_xattn_full_tc<HD>(x, xa, valid, freqs, w, out, ws0, ws1,  \
                                    ws2, ws3, ws4, sh, st);                  \
  if (dtype == ASR_F32)                                                      \
    return launch_xattn<float, HD>(true, x, xa, nullptr, nullptr, valid,    \
                                   freqs, w, out, ws0, ws1, ws2, ws3, ws4,   \
                                   sh, st);                                  \
  return launch_xattn<bf16, HD>(true, x, xa, nullptr, nullptr, valid, freqs, \
                                w, out, ws0, ws1, ws2, ws3, ws4, sh, st)
  if (D / H == XA_HD2) {
    XA_FULL(XA_HD2);
  }
  XA_FULL(XA_HD);
#undef XA_FULL
}

// the dynamic shared memory of the two tensor-core launches, for head
// width HD
ASR_API int asr_xattn_rows_smem(int D, int HD) {
  return (int)xa_rows_smem(D, HD);
}
ASR_API int asr_xattn_attend_smem(int D, int Ta, int HD) {
  return (int)xa_attend_smem(D, Ta, HD);
}
// the dynamic shared memory of a cached call's second tensor-core launch
ASR_API int asr_xattn_cached_smem(int QR, int Tk, int NS, int HD) {
  return (int)xc_attend_smem(QR, xc_kpc(Tk, NS), NS, HD);
}
