// Whole attention calls of the decode step at the widths xattn.cu's
// routes do not take, for Hopper (sm_90a): the wide route and, past its
// head width, the global one.
//
// Replaces asr_model_tpu/ops/pallas/xattn_kernel.py:fused_attn_cached and
// fused_attn_full at those widths; the function is xattn.cu's.
#include "abby_cluster.cuh"
#include "global_attn.cuh"
#include "xattn.cuh"

// The wide route: whole calls at the widths xattn.cu's kernels do not
// take -- head widths other than 128 and 256 (384, 512, ... up to
// XW_MAX_HD) and rows wider than 2048 channels (D 4096 with 32 heads of
// 128), both dtypes.  The function is the one at the top of xattn.cu:
// q = rotary(q_norm(x) Wq^T + bq) * HD^-0.25, per head head_norm; in a
// full call k the same from xa with kv_norm, v raw; softmax(qh K^T /
// sqrt(HD), masked -1e30) V per head; out_proj.  Values are rounded to
// the storage type where the reference rounds them.
//
// What bounds it: as xattn.cu's calls, bytes at decode widths (the
// weights: 4 D^2 values a full call, 2 D^2 a cached one, plus the cache).
// Design: the chain of launches the row-wide dependencies force, each a
// kernel of this library, each spreading its work over the card:
//   1 q_norm(x)          asr_fused_abby (abby.cu: any D, one launch)
//   2 q columns          xw_proj: (16-row tile, 64-column slice) CUDA-core
//                        product (gemm_rows16, x 2048 columns at a time),
//                        bias, scale and the rotary pair by a shuffle with
//                        the neighbouring column, rounded
//   3 head_norm          asr_fused_abby over the (B T H, HD) head rows
//   4 attention          xw_attend: (16-query tile, head, batch row), the
//                        exact softmax in two passes over 16-key tiles (max
//                        and sum, then the normalised weights rounded to
//                        the storage type times V, as the reference
//                        rounds them), HD / 16 output channels a thread;
//                        where those blocks would not fill the card (a
//                        decode-width x), NS blocks split the keys: the
//                        passes as two launches (the splits' max and sum,
//                        merged by each block of the second) and a third
//                        adds the splits' shares in split order; past
//                        XW_MAX_HD global_attn.cuh's three launches
//                        through an f32 score matrix
//   5 out_proj           linear_rows (common.cuh)
// and in a full call 1-3 for the kv side first (xw_proj writes k rotated
// and v raw).  Five launches a cached call, eight a full one (seven and
// ten with a key split or past XW_MAX_HD; a norm past AbbyNormal's
// cluster plan two more, xw_norm).  The
// products stay on the CUDA cores in full f32 (the f32 route's 1e-4).

ASR_API int asr_fused_abby(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, int N, int D, int size, float alpha,
                           float k, float beta, void* stream);
ASR_API int asr_abby_global(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* res, void* out, void* hbuf,
                            void* choice, int N, int D, int size,
                            float alpha, float k, float beta, void* stream);

// a norm of the chain: asr_fused_abby, or past its shared-memory plan
// (abby_smem_bytes) asr_abby_global's three launches through hbuf (N, D)
// and choice (N ints)
static int xw_norm(int dtype, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, void* hbuf,
                   void* choice, int N, int D, int size, float alpha,
                   float k, float beta, cudaStream_t st) {
  if (abby_smem_bytes(dtype, D) > 232448)
    return asr_abby_global(dtype, x, w1, b1, w2, b2, nullptr, out, hbuf,
                           choice, N, D, size, alpha, k, beta, st);
  return asr_fused_abby(dtype, x, w1, b1, w2, b2, out, N, D, size, alpha, k,
                        beta, st);
}

constexpr int XW_KCH = 2048;        // x columns a projection CTA holds
constexpr int XW_QT = 16;           // query rows of an attention block
constexpr int XW_KT = 16;           // keys a tile
constexpr int XW_MAX_HD = 1024;     // the widest head of xw_attend (registers,
                                    // smem); past it global_attn.cuh

// p = xn W^T + b over one (16-row tile, 64-column slice), W (Nout, D):
// columns below D (q or k) scaled by qk_scale and rotated in pairs (2i,
// 2i + 1) by angle pos * freqs[(i mod HD) / 2] (pos = row mod S) and the
// magnitude ||cond row||, written to qk (rows of D); columns from D on
// (a full call's v) written raw to vout.  Both rounded.  D % 64 == 0.
template <typename T>
__global__ void __launch_bounds__(256)
xw_proj(const T* __restrict__ xn, const T* __restrict__ cond,
        const T* __restrict__ w, const T* __restrict__ bias,
        const float* __restrict__ freqs, T* __restrict__ qk,
        T* __restrict__ vout, int N, int S, int D, int hd, int Nout,
        float qk_scale) {
  extern __shared__ float smem[];
  const int kch = min(D, XW_KCH);
  float* as = smem;                          // [16][kch]
  float* wt = as + GEMM_ROWS * kch;
  float* mn = wt + GEMM_WT_FLOATS;           // [16] ||cond row||
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  const bool rot = n0 < D;                   // the whole slice (D % 64 == 0)
  if (rot) {
    for (int r = warp; r < GEMM_ROWS; r += 8) {
      float s = 0.0f;
      if (r0 + r < N)
        for (int j = lane; j < D; j += 32) {
          const float v = to_f32(cond[(size_t)(r0 + r) * D + j]);
          s += v * v;
        }
      s = warp_sum(s);
      if (lane == 0) mn[r] = s > 0.0f ? sqrtf(s) : 0.0f;
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < D; k0 += kch) {
    const int kc = min(kch, D - k0);
    for (int e = t; e < GEMM_ROWS * kc; e += 256) {
      const int r = e / kc, j = e % kc;
      as[e] = (r0 + r < N) ? to_f32(xn[(size_t)(r0 + r) * D + k0 + j]) : 0.0f;
    }
    __syncthreads();
    float part[4];
    gemm_rows16<T, false>(as, kc, kc, w + k0, D, n0, Nout, wt, part);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += part[i];
  }
  const int c = t % GEMM_NT, n = n0 + c;
  const float b = n < Nout ? to_f32(bias[n]) : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = 4 * (t / GEMM_NT) + i, row = r0 + rr;
    float val = acc[i] + b;
    if (rot) {
      val *= qk_scale;
      const float other = __shfl_xor_sync(0xffffffffu, val, 1);
      const int p = (n % hd) >> 1;
      const float f = (float)(row % S) * freqs[p];
      const float mc = mn[rr] * cosf(f), ms = mn[rr] * sinf(f);
      val = (n & 1) ? val * mc + other * ms : val * mc + other * (-ms);
      if (row < N) qk[(size_t)row * D + n] = from_f32<T>(val);
    } else if (row < N && n < Nout) {
      vout[(size_t)row * D + n - D] = from_f32<T>(val);
    }
  }
}

// Scores of query row qr (shared, f32) against the tile's key kr, scaled
// and masked; keys past kend (the block's range) are -inf (no weight at
// all).
__device__ __forceinline__ float xw_score(const float* qr, const float* kr,
                                          int hd, int kj, int kend, int qpos,
                                          int Tq, int Tk,
                                          const uint8_t* valid, int causal,
                                          float sm_scale) {
  float s = 0.0f;
  for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
  if (kj >= kend) return -INFINITY;
  bool masked = causal && kj > qpos + Tk - Tq;
  if (valid && !valid[kj]) masked = true;
  return masked ? XA_MASKED : s * sm_scale;
}

// One (16-query tile, head, batch row, key split): q rows (B, Tq, H, hd)
// of stride D; K and V rows of head h of batch row b at kh + b k_bs + h
// k_hs + j k_rs.  With NS = 1 split (MODE XW_WHOLE) both passes over every
// key, and the head's output o (B, Tq, D) at column h hd, rounded.  With
// NS > 1 each block takes kps keys: XW_STATS writes its rows' (max, sum)
// to ml [B H][NS][Tq][2]; XW_PV merges the NS pairs of its rows in split
// order (the rows' max and sum over every key) and writes its keys' share
// of the output, the rounded weights times V summed in f32, to po [B
// H][NS][Tq][hd]; xw_merge adds the shares in split order and rounds.
enum XwMode { XW_WHOLE = 0, XW_STATS = 1, XW_PV = 2 };

template <typename T, int NJ, int MODE>
__global__ void __launch_bounds__(256)
xw_attend(const T* __restrict__ q, const T* __restrict__ kh,
          const T* __restrict__ vh, long k_bs, long k_hs, int k_rs,
          const uint8_t* __restrict__ valid_all, T* __restrict__ o,
          float* __restrict__ ml, float* __restrict__ po, int NS, int kps,
          int Tq, int Tk, int D, int hd, int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* qs = smem;                          // [QT][hdp]
  float* ks = qs + XW_QT * hdp;              // [KT][hdp]
  float* vs = ks + XW_KT * hdp;              // [KT][hd]
  float* ps = vs + XW_KT * hd;               // [QT][KT + 1]
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int t0 = blockIdx.x * XW_QT, h = blockIdx.y;
  const int b = blockIdx.z / NS, sp = blockIdx.z % NS;
  const int qpos = t0 + ty, H = gridDim.y;
  const int klo = MODE == XW_WHOLE ? 0 : sp * kps;
  const int khi = MODE == XW_WHOLE ? Tk : min(Tk, klo + kps);
  const size_t row_ml = (((size_t)b * H + h) * NS * Tq + qpos) * 2;
  const T* kb = kh + b * k_bs + h * k_hs;
  const T* vb = vh + b * k_bs + h * k_hs;
  const uint8_t* valid = valid_all ? valid_all + (size_t)b * Tk : nullptr;
  for (int e = t; e < XW_QT * hd; e += 256) {
    const int r = e / hd, d = e % hd;
    qs[r * hdp + d] =
        t0 + r < Tq ? to_f32(q[((size_t)b * Tq + t0 + r) * D + h * hd + d])
                    : 0.0f;
  }
  auto stage = [&](const T* src, float* dst, int ld, int k0) {
    for (int e = t; e < XW_KT * hd; e += 256) {
      const int r = e / hd, d = e % hd;
      dst[r * ld + d] =
          k0 + r < Tk ? to_f32(src[(size_t)(k0 + r) * k_rs + d]) : 0.0f;
    }
  };
  // pass 1: the row's max and sum over the block's keys
  float m_run = -INFINITY, l_run = 0.0f;
  for (int k0 = klo; k0 < khi && MODE != XW_PV; k0 += XW_KT) {
    __syncthreads();
    stage(kb, ks, hdp, k0);
    __syncthreads();
    const float s = xw_score(qs + ty * hdp, ks + tx * hdp, hd, k0 + tx, khi,
                             qpos, Tq, Tk, valid, causal, sm_scale);
    float mx = s;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);    // finite: key k0 exists
    float sum = s == -INFINITY ? 0.0f : expf(s - m_new);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_run = l_run * expf(m_run - m_new) + sum;
    m_run = m_new;
  }
  if constexpr (MODE == XW_STATS) {
    if (tx == 0 && qpos < Tq) {
      ml[row_ml + (size_t)sp * Tq * 2] = m_run;
      ml[row_ml + (size_t)sp * Tq * 2 + 1] = l_run;
    }
    return;
  }
  if constexpr (MODE == XW_PV) {   // the splits' pairs, in split order
    if (qpos < Tq) {
      for (int q2 = 0; q2 < NS; ++q2)
        m_run = fmaxf(m_run, ml[row_ml + (size_t)q2 * Tq * 2]);
      for (int q2 = 0; q2 < NS; ++q2)
        l_run += ml[row_ml + (size_t)q2 * Tq * 2 + 1] *
                 expf(ml[row_ml + (size_t)q2 * Tq * 2] - m_run);
    }
  }
  // pass 2: the normalised weights, rounded, times V
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;
  for (int k0 = klo; k0 < khi; k0 += XW_KT) {
    __syncthreads();
    stage(kb, ks, hdp, k0);
    stage(vb, vs, hd, k0);
    __syncthreads();
    const float s = xw_score(qs + ty * hdp, ks + tx * hdp, hd, k0 + tx, khi,
                             qpos, Tq, Tk, valid, causal, sm_scale);
    ps[ty * (XW_KT + 1) + tx] =
        s == -INFINITY ? 0.0f : to_f32(from_f32<T>(expf(s - m_run) / l_run));
    __syncwarp();
    const int kmax = min(XW_KT, khi - k0);
    for (int c = 0; c < kmax; ++c) {
      const float p = ps[ty * (XW_KT + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) acc[j] = fmaf(p, vs[c * hd + d], acc[j]);
      }
    }
  }
  if (qpos >= Tq) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = tx + 16 * j;
    if (d >= hd) continue;
    if constexpr (MODE == XW_PV)
      po[((((size_t)b * H + h) * NS + sp) * Tq + qpos) * hd + d] = acc[j];
    else
      o[((size_t)b * Tq + qpos) * D + h * hd + d] = from_f32<T>(acc[j]);
  }
}

// o (B, Tq, D) = the NS splits' shares po [B H][NS][Tq][hd] added in
// split order, rounded
template <typename T>
__global__ void __launch_bounds__(256)
xw_merge(const float* __restrict__ po, T* __restrict__ o, int B, int H,
         int NS, int Tq, int hd) {
  const size_t n = (size_t)B * Tq * H * hd;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(e % hd);
    const size_t r = e / hd;               // (b, t, h) in o's order
    const int h = (int)(r % H);
    const size_t bt = r / H;
    const int tq = (int)(bt % Tq), b = (int)(bt / Tq);
    const float* p = po + ((((size_t)b * H + h) * NS) * Tq + tq) * hd + d;
    float v = 0.0f;
    for (int q2 = 0; q2 < NS; ++q2) v += p[(size_t)q2 * Tq * hd];
    o[e] = from_f32<T>(v);
  }
}

__host__ __device__ constexpr size_t xw_proj_smem(int D) {
  return sizeof(float) *
         (GEMM_ROWS * (D < XW_KCH ? D : XW_KCH) + GEMM_WT_FLOATS + GEMM_ROWS);
}
// keys a split takes: its share of Tk in whole 16-key tiles
__host__ __device__ constexpr int xw_keys_per_split(int Tk, int NS) {
  return ((Tk + NS - 1) / NS + XW_KT - 1) / XW_KT * XW_KT;
}
__host__ __device__ constexpr size_t xw_attend_smem(int hd) {
  return sizeof(float) * ((size_t)(XW_QT + XW_KT) * (hd + 1) + XW_KT * hd +
                          XW_QT * (XW_KT + 1));
}

template <typename T>
static cudaError_t xw_launch_proj(const void* xn, const void* cond,
                                  const void* w, const void* bias,
                                  const void* freqs, void* qk, void* vout,
                                  int N, int S, int D, int hd, int Nout,
                                  float qk_scale, cudaStream_t st) {
  const size_t smem = xw_proj_smem(D);
  cudaFuncSetAttribute(xw_proj<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((N + GEMM_ROWS - 1) / GEMM_ROWS,
                  (Nout + GEMM_NT - 1) / GEMM_NT);
  xw_proj<T><<<grid, 256, smem, st>>>(
      (const T*)xn, (const T*)cond, (const T*)w, (const T*)bias,
      (const float*)freqs, (T*)qk, (T*)vout, N, S, D, hd, Nout, qk_scale);
  return cudaGetLastError();
}

template <typename T, int NJ, int MODE>
static cudaError_t xw_launch_attend_mode(const void* q, const void* kh,
                                         const void* vh, long k_bs,
                                         long k_hs, int k_rs,
                                         const void* valid, void* o,
                                         float* ml, float* po, int NS,
                                         int kps, int B, int Tq, int Tk,
                                         int D, int H, int hd, int causal,
                                         float sm_scale, cudaStream_t st) {
  const size_t smem = xw_attend_smem(hd);
  cudaFuncSetAttribute(xw_attend<T, NJ, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  xw_attend<T, NJ, MODE>
      <<<dim3((Tq + XW_QT - 1) / XW_QT, H, B * NS), 256, smem, st>>>(
          (const T*)q, (const T*)kh, (const T*)vh, k_bs, k_hs, k_rs,
          (const uint8_t*)valid, (T*)o, ml, po, NS, kps, Tq, Tk, D, hd,
          causal, sm_scale);
  return cudaGetLastError();
}

// one launch (NS 1), or the stats, PV and merge launches over NS splits
template <typename T, int NJ>
static cudaError_t xw_launch_attend_nj(const void* q, const void* kh,
                                       const void* vh, long k_bs, long k_hs,
                                       int k_rs, const void* valid, void* o,
                                       float* ml, float* po, int NS, int B,
                                       int Tq, int Tk, int D, int H, int hd,
                                       int causal, float sm_scale,
                                       cudaStream_t st) {
  if (NS <= 1)
    return xw_launch_attend_mode<T, NJ, XW_WHOLE>(
        q, kh, vh, k_bs, k_hs, k_rs, valid, o, nullptr, nullptr, 1, Tk, B, Tq,
        Tk, D, H, hd, causal, sm_scale, st);
  const int kps = xw_keys_per_split(Tk, NS);
  cudaError_t e = xw_launch_attend_mode<T, NJ, XW_STATS>(
      q, kh, vh, k_bs, k_hs, k_rs, valid, o, ml, po, NS, kps, B, Tq, Tk, D, H,
      hd, causal, sm_scale, st);
  if (e != cudaSuccess) return e;
  e = xw_launch_attend_mode<T, NJ, XW_PV>(q, kh, vh, k_bs, k_hs, k_rs, valid,
                                          o, ml, po, NS, kps, B, Tq, Tk, D, H,
                                          hd, causal, sm_scale, st);
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * Tq * H * hd;
  xw_merge<T><<<(int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0,
                st>>>(po, (T*)o, B, H, NS, Tq, hd);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t xw_launch_attend(const void* q, const void* kh,
                                    const void* vh, long k_bs, long k_hs,
                                    int k_rs, const void* valid, void* o,
                                    float* ml, float* po, int NS, int B,
                                    int Tq, int Tk, int D, int H, int hd,
                                    int causal, float sm_scale,
                                    cudaStream_t st) {
#define XW_A(nj)                                                           \
  return xw_launch_attend_nj<T, nj>(q, kh, vh, k_bs, k_hs, k_rs, valid, o, \
                                    ml, po, NS, B, Tq, Tk, D, H, hd, causal, \
                                    sm_scale, st)
  if (hd <= 128) XW_A(8);
  if (hd <= 256) XW_A(16);
  if (hd <= 384) XW_A(24);
  if (hd <= 512) XW_A(32);
  if (hd <= 768) XW_A(48);
  XW_A(64);
#undef XW_A
}

template <typename T>
static int xw_call(int dtype, bool full, const void* x, const void* xa,
                   const void* kc, const void* vc, const void* valid,
                   const void* freqs, const void* const* w, void* out,
                   void* const* ws, int B, int Tq, int Tk, int D, int H,
                   int causal, int size_d, int size_h, float alpha, float k,
                   float beta, int NS, cudaStream_t st) {
  const int hd = D / H, N = B * Tq;
  const float qk_scale = (float)pow((double)hd, -0.25);
  const float sm_scale = (float)(1.0 / sqrt((double)hd));
  void *xn = ws[0], *q = ws[1], *qh = ws[2], *o = ws[3];
  int rc = xw_norm(dtype, x, w[QN_W1], w[QN_B1], w[QN_W2], w[QN_B2], xn,
                   ws[11], ws[12], N, D, size_d, alpha, k, beta, st);
  if (rc) return rc;
  cudaError_t e = xw_launch_proj<T>(xn, x, w[QP_W], w[QP_B], freqs, q,
                                    nullptr, N, Tq, D, hd, D, qk_scale, st);
  if (e != cudaSuccess) return (int)e;
  rc = xw_norm(dtype, q, w[HN_W1], w[HN_B1], w[HN_W2], w[HN_B2], qh, ws[11],
               ws[12], N * H, hd, size_h, alpha, k, beta, st);
  if (rc) return rc;
  long k_bs = (long)H * Tk * hd, k_hs = (long)Tk * hd;
  int k_rs = hd;
  if (full) {                      // the kv side: (B, Ta, H, hd) rows
    void *xan = ws[4], *kk = ws[5], *kh = ws[6], *vv = ws[7];
    const int Na = B * Tk;
    rc = xw_norm(dtype, xa, w[KN_W1], w[KN_B1], w[KN_W2], w[KN_B2], xan,
                 ws[11], ws[12], Na, D, size_d, alpha, k, beta, st);
    if (rc) return rc;
    e = xw_launch_proj<T>(xan, xa, w[KP_W], w[KP_B], freqs, kk, vv, Na,
                          Tk, D, hd, 2 * D, qk_scale, st);
    if (e != cudaSuccess) return (int)e;
    rc = xw_norm(dtype, kk, w[HN_W1], w[HN_B1], w[HN_W2], w[HN_B2], kh,
                 ws[11], ws[12], Na * H, hd, size_h, alpha, k, beta, st);
    if (rc) return rc;
    kc = kh;
    vc = vv;
    k_bs = (long)Tk * D;
    k_hs = hd;
    k_rs = D;
  }
  if (hd > XW_MAX_HD) {           // global_attn.cuh: three launches
    const GlStrides qs{(long)Tq * D, hd, D}, ks{k_bs, k_hs, k_rs};
    e = gl_attention<T>(qh, qs, kc, ks, vc, ks, valid, o, qs, (float*)ws[10],
                        B, H, Tq, Tk, hd, sm_scale, causal, st);
  } else {
    e = xw_launch_attend<T>(qh, kc, vc, k_bs, k_hs, k_rs, valid, o,
                            (float*)ws[8], (float*)ws[9], NS, B, Tq, Tk, D,
                            H, hd, causal, sm_scale, st);
  }
  if (e != cudaSuccess) return (int)e;
  launch_linear_rows<T, LIN_NONE>(o, w[OP_W], w[OP_B], out, N, D, D,
                                  st);
  return (int)cudaGetLastError();
}

// A whole attention call at the widths of this file.  full 0: cached, kc / vc
// (B, H, Tk, hd) the processed K and raw V, xa unused; full 1: xa (B, Tk,
// D), kc / vc unused, causal the bottom-right mask.  x, out (B, T, D);
// valid (B, Tk) bytes or null; freqs (hd / 2,) f32; w: the 18 weights in
// XaWeight order (the kv entries unused when cached); all of
// one dtype (0 = f32, 1 = bf16).  Workspace of the dtype: ws[0..3] (B, T,
// D) each (normed x, q, head-normed q, heads' outputs), and in a full
// call ws[4..7] (B, Tk, D) each (normed xa, k, head-normed k, v); with
// NS > 1 key splits of the attention (xw_splits), ws[8] f32 B H NS T 2
// and ws[9] f32 B H NS T hd.  D = H hd, D % 64 == 0, hd even.  Past
// XW_MAX_HD (NS 1) the attention is global_attn.cuh's three launches
// through ws[10], B H T Tk f32; where a norm's plan does not fit a block
// (abby_smem_bytes of D or hd) it takes asr_abby_global's three launches
// through ws[11] (B max(T, Tk) D of the dtype) and ws[12] (B max(T, Tk)
// H ints).
ASR_API int asr_fused_attn_wide(int dtype, int full, const void* x,
                                const void* xa, const void* kc,
                                const void* vc, const void* valid,
                                const void* freqs, const void* const* w,
                                void* out, void* const* ws, int B, int T,
                                int Tk, int D, int H, int causal, int size_d,
                                int size_h, float alpha, float k, float beta,
                                int NS, void* stream) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  const bool gl = D / H > XW_MAX_HD,
             gnorm = abby_smem_bytes(dtype, D) > 232448 ||
                     abby_smem_bytes(dtype, D / H) > 232448;
  if (D % H || D % 64 || (D / H) % 2 || T < 1 ||
      (gl && (NS != 1 || ws[10] == nullptr || (long)B * H > 65535)) ||
      (gnorm && (ws[11] == nullptr || ws[12] == nullptr)) ||
      Tk < 1 || size_d < 1 || size_h < 1 || B > 65535 || H > 65535 ||
      (long)B * T > 65535L * GEMM_ROWS || NS < 1 ||
      (long)B * NS > 65535 || NS > (Tk + XW_KT - 1) / XW_KT ||
      (NS > 1 && (ws[8] == nullptr || ws[9] == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return xw_call<float>(dtype, full != 0, x, xa, kc, vc, valid, freqs, w,
                          out, ws, B, T, Tk, D, H, causal, size_d, size_h,
                          alpha, k, beta, NS, st);
  return xw_call<__nv_bfloat16>(dtype, full != 0, x, xa, kc, vc, valid, freqs,
                                w, out, ws, B, T, Tk, D, H, causal, size_d,
                                size_h, alpha, k, beta, NS, st);
}
