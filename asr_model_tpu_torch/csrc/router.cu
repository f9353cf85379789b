// The modality Router over identical inputs, Router(*[x] * n_mod), for
// Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/router_kernel.py:fused_router_same.
//
// With every modality the same tensor x (N, D), the stacked product
// collapses: [x | ... | x] W^T = x (sum of W's D-column slices)^T and the
// weighted sum of the stack is x * sum_c(w_c).  Per row: top = x E_top^T +
// b_top, soft = softmax(x E_soft^T + b_soft) (nt values each); w =
// sigmoid(alpha) * top2hard(top) + (1 - sigmoid(alpha)) * soft, where
// top2hard puts softmax(v1, v2) at the two largest scores (ties to the
// first occurrence, in rank order) and 0 elsewhere; out = x * sum_c w_c
// in f32, cast to the storage type.  The folded weights E are summed in
// f32 and rounded to the storage type, as the reference folds them.
// sum_c w_c is 1 only up to rounding, so it is computed, not assumed.
//
// What bounds it: 2 * nt * N * D operations on 2 * N * D * sizeof(T)
// bytes -- about 3 per byte at nt = 3, far below the card's ridge, so
// bytes.  At decode widths (N = 72 .. 520 rows, 72 KB .. 520 KB of bf16
// x) the bound is a fraction of a microsecond and a launch costs a few:
// what counts is how many serial steps a CTA takes after it starts.
//
// Design: one launch of router_rows, 128 threads a CTA, rpc rows a CTA
// (1, 2 or 4 as N grows, rt_rows_per_cta), 4 / rpc warps a row.  A CTA
//   1 folds (2, nt, n_mod * D) into (2, nt, D) in shared memory, stored
//     as T: 16-byte loads from L2, split over all 128 threads;
//   2 meanwhile loads its rows with 16-byte loads into registers (VPL
//     vectors a lane), each row read from device memory once;
//   3 takes all 2 nt dot products of a row in one pass over the
//     registers, NTC types at a time (4, or 8 past nt 4), and ends them
//     in one reduce-scatter across the warp (2 NTC values in 2 NTC - 1
//     shuffles, not 2 NTC warp sums), the warps of a row adding their
//     partials in a fixed order (deterministic);
//   4 routes each row on every lane and scales it from the registers,
//     16-byte stores.
// Rows wider than the registers hold (VPL 0) are read again from L2 for
// each NTC types and the scaling.  Where the folded weights do not fit in
// shared memory (2 nt D sizeof(T) past RT_FOLD_SMEM_MAX) a first launch
// (router_fold) folds them into a device workspace once and the rows
// kernel reads them from L2: two launches there.  The dynamic shared
// memory attribute is set once per process.
#include "common.cuh"

constexpr int RT_THREADS = 128;          // 4 warps a CTA
constexpr int RT_WARPS = RT_THREADS / 32;
constexpr int RT_FOLD_SMEM_MAX = 200 * 1024;  // fold bytes held in a CTA
constexpr int RT_SMEM_ATTR = 232448;     // the most a block may use
constexpr float ROUTER_NEG = -1e30f;

template <typename T>
__host__ __device__ constexpr int rt_epv() {
  return 16 / (int)sizeof(T);            // elements a 16-byte vector
}

// EPV values of row p at columns j .. j + EPV - 1 as f32: one 16-byte
// load when `vec` (p + j 16-byte aligned), else scalars, 0 past D
template <typename T>
__device__ __forceinline__ void rt_load(const T* p, int j, int D, bool vec,
                                        float* v) {
  constexpr int EPV = rt_epv<T>();
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + j));
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      v[0] = __uint_as_float(u.x);
      v[1] = __uint_as_float(u.y);
      v[2] = __uint_as_float(u.z);
      v[3] = __uint_as_float(u.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPV; ++i)
      v[i] = j + i < D ? to_f32(p[j + i]) : 0.0f;
  }
}

// the same from shared memory (always 16-byte aligned there when `vec`)
template <typename T>
__device__ __forceinline__ void rt_load_s(const T* p, int j, int D, bool vec,
                                          float* v) {
  constexpr int EPV = rt_epv<T>();
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + j);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      v[0] = __uint_as_float(u.x);
      v[1] = __uint_as_float(u.y);
      v[2] = __uint_as_float(u.z);
      v[3] = __uint_as_float(u.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPV; ++i)
      v[i] = j + i < D ? to_f32(p[j + i]) : 0.0f;
  }
}

// EPV values rounded to T at columns j .. of p (16 bytes when `vec`)
template <typename T>
__device__ __forceinline__ void rt_store(T* p, int j, int D, bool vec,
                                         const float* v) {
  constexpr int EPV = rt_epv<T>();
  if (vec) {
    uint4 u;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    } else {
      u.x = __float_as_uint(v[0]);
      u.y = __float_as_uint(v[1]);
      u.z = __float_as_uint(v[2]);
      u.w = __float_as_uint(v[3]);
    }
    *reinterpret_cast<uint4*>(p + j) = u;
  } else {
#pragma unroll
    for (int i = 0; i < EPV; ++i)
      if (j + i < D) p[j + i] = from_f32<T>(v[i]);
  }
}

// Fold vectors [e0, e1) of the (2, nt, D) folded weights, step `step`:
// vector e is (which, c, column vector) of top_w (which 0) or soft_w (1),
// its n_mod slices summed in f32 in slice order, rounded to T.
template <typename T>
__device__ __forceinline__ void rt_fold(const T* __restrict__ top_w,
                                        const T* __restrict__ soft_w,
                                        T* fold, int D, int nt, int n_mod,
                                        bool vec, int e0, int step) {
  constexpr int EPV = rt_epv<T>();
  const int nvec = (D + EPV - 1) / EPV;
  for (int e = e0; e < 2 * nt * nvec; e += step) {
    const int cw = e / nvec, j = (e % nvec) * EPV;
    const int which = cw / nt, c = cw % nt;
    const T* src = (which ? soft_w : top_w) + (size_t)c * n_mod * D;
    float s[EPV], u[EPV];
    rt_load(src, j, D, vec, s);
    for (int i = 1; i < n_mod; ++i) {
      rt_load(src + (size_t)i * D, j, D, vec, u);
#pragma unroll
      for (int q = 0; q < EPV; ++q) s[q] += u[q];
    }
    rt_store(fold + (size_t)cw * D, j, D, vec, s);
  }
}

// Sum NV per-lane values over the warp by halving: at each step a lane
// keeps the half its bit selects and adds the other lane's copy of it
// (NV - 1 shuffles in all, then the full steps once one value is left).
// Returns the total of value (lane >> (5 - log2 NV)) & (NV - 1).
template <int NV>
__device__ __forceinline__ float rt_reduce_scatter(float (&v)[NV], int lane) {
  constexpr int L = NV == 16 ? 4 : NV == 8 ? 3 : NV == 4 ? 2 : 1;
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const int off = 16 >> s, half = NV >> (s + 1);
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float r = v[0];
#pragma unroll
  for (int off = 16 >> L; off > 0; off >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// bytes of router_rows' shared memory ahead of the fold: the warps'
// partial scores [4][2 NTC] and the rows' scores [4][2 nt], f32
__host__ __device__ constexpr int rt_head_bytes(int nt) {
  return (4 * (RT_WARPS * 2 * 8 + RT_WARPS * 2 * nt) + 15) / 16 * 16;
}

// The router of rpc rows a CTA (the design above).  efold: the folded
// weights in device memory, or null to fold them here into shared
// memory.  VPL: 16-byte vectors of a row a lane holds (0: read again).
template <typename T, int VPL, int NTC>
__global__ void __launch_bounds__(RT_THREADS)
router_rows(const T* __restrict__ x, const T* __restrict__ top_w,
            const T* __restrict__ top_b, const T* __restrict__ soft_w,
            const T* __restrict__ soft_b, const T* __restrict__ alpha_raw,
            const T* __restrict__ efold, T* __restrict__ out, int N, int D,
            int nt, int n_mod, int rpc, int vec) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  constexpr int EPV = rt_epv<T>(), NV = 2 * NTC;
  float* part = reinterpret_cast<float*>(rt_smem);     // [4][2 NTC]
  float* scores = part + RT_WARPS * NV;                // [rpc][2 nt]
  T* sfold = reinterpret_cast<T*>(rt_smem + rt_head_bytes(nt));
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wpr = RT_WARPS / rpc, rl = warp / wpr, wr = warp % wpr;
  const int r = blockIdx.x * rpc + rl;
  const bool live = r < N;
  const int nvec = (D + EPV - 1) / EPV, stride = 32 * wpr;
  const int v0 = wr * 32 + lane;             // the lane's first vector
  const T* xr = x + (size_t)(live ? r : 0) * D;

  // the row into registers first, so its loads overlap the fold's
  float xv[VPL > 0 ? VPL : 1][EPV];
  if constexpr (VPL > 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = v0 + i * stride;
      if (live && v < nvec) {
        rt_load(xr, v * EPV, D, vec, xv[i]);
      } else {
#pragma unroll
        for (int q = 0; q < EPV; ++q) xv[i][q] = 0.0f;
      }
    }
  }
  const T* E = efold;
  if (E == nullptr) {
    rt_fold(top_w, soft_w, sfold, D, nt, n_mod, vec != 0, t, RT_THREADS);
    E = sfold;
    __syncthreads();
  }

  for (int c0 = 0; c0 < nt; c0 += NTC) {
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
    auto dots = [&](const float* xx, int j) {
#pragma unroll
      for (int cc = 0; cc < NTC; ++cc) {
        const int c = c0 + cc;
        if (c < nt) {
          float et[EPV], es[EPV];
          if (efold) {
            rt_load(E + (size_t)c * D, j, D, vec != 0, et);
            rt_load(E + (size_t)(nt + c) * D, j, D, vec != 0, es);
          } else {
            rt_load_s(E + (size_t)c * D, j, D, vec != 0, et);
            rt_load_s(E + (size_t)(nt + c) * D, j, D, vec != 0, es);
          }
#pragma unroll
          for (int q = 0; q < EPV; ++q) {
            acc[cc] = fmaf(xx[q], et[q], acc[cc]);
            acc[NTC + cc] = fmaf(xx[q], es[q], acc[NTC + cc]);
          }
        }
      }
    };
    if (live) {
      if constexpr (VPL > 0) {
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          if (v0 + i * stride < nvec) dots(xv[i], (v0 + i * stride) * EPV);
      } else {
        for (int v = v0; v < nvec; v += stride) {
          float xx[EPV];
          rt_load(xr, v * EPV, D, vec != 0, xx);
          dots(xx, v * EPV);
        }
      }
    }
    const float s = rt_reduce_scatter<NV>(acc, lane);
    constexpr int LOW = NV == 16 ? 1 : NV == 8 ? 3 : 7;   // 32 / NV - 1
    if ((lane & LOW) == 0) part[warp * NV + lane / (LOW + 1)] = s;
    __syncthreads();
    // a row's scores: its warps' partials in warp order, plus the bias
    if (t < rpc * NV) {
      const int rr = t / NV, k = t % NV, cc = k % NTC, which = k / NTC;
      const int c = c0 + cc;
      if (c < nt) {
        float v = 0.0f;
        for (int w = 0; w < wpr; ++w) v += part[(rr * wpr + w) * NV + k];
        scores[rr * 2 * nt + which * nt + c] =
            v + to_f32((which ? soft_b : top_b)[c]);
      }
    }
    __syncthreads();
  }
  if (!live) return;                         // no block-wide sync below

  // the route, on every lane: softmax of the soft scores, the top-2 of
  // the top scores (first occurrence on ties), sum_c w_c
  const float* top = scores + rl * 2 * nt;
  const float* soft = top + nt;
  float mx = soft[0];
  for (int c = 1; c < nt; ++c) mx = fmaxf(mx, soft[c]);
  float z = 0.0f;
  for (int c = 0; c < nt; ++c) z += expf(soft[c] - mx);
  int i1 = 0;
  for (int c = 1; c < nt; ++c)
    if (top[c] > top[i1]) i1 = c;
  int i2 = -1;
  float v2 = 0.0f;
  for (int c = 0; c < nt; ++c) {
    const float v = c == i1 ? ROUTER_NEG : top[c];
    if (i2 < 0 || v > v2) {
      v2 = v;
      i2 = c;
    }
  }
  const float v1 = top[i1];
  const float m = fmaxf(v1, v2);
  const float e1 = expf(v1 - m), e2 = expf(v2 - m);
  const float ez = e1 + e2;
  const float al = sigmoidf_(to_f32(alpha_raw[0]));
  float scale = 0.0f;
  for (int c = 0; c < nt; ++c) {
    const float hard = (c == i1 ? e1 / ez : 0.0f) + (c == i2 ? e2 / ez : 0.0f);
    scale += al * hard + (1.0f - al) * (expf(soft[c] - mx) / z);
  }

  T* orow = out + (size_t)r * D;
  if constexpr (VPL > 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = v0 + i * stride;
      if (v < nvec) {
        float y[EPV];
#pragma unroll
        for (int q = 0; q < EPV; ++q) y[q] = xv[i][q] * scale;
        rt_store(orow, v * EPV, D, vec != 0, y);
      }
    }
  } else {
    for (int v = v0; v < nvec; v += stride) {
      float y[EPV];
      rt_load(xr, v * EPV, D, vec != 0, y);
#pragma unroll
      for (int q = 0; q < EPV; ++q) y[q] *= scale;
      rt_store(orow, v * EPV, D, vec != 0, y);
    }
  }
}

// the fold alone, into a device workspace (2, nt, D), over the grid
template <typename T>
__global__ void __launch_bounds__(256)
router_fold(const T* __restrict__ top_w, const T* __restrict__ soft_w,
            T* __restrict__ fold, int D, int nt, int n_mod, int vec) {
  rt_fold(top_w, soft_w, fold, D, nt, n_mod, vec != 0,
          blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

// rows a CTA: one up to 264 rows, two up to 1056, else four -- at least
// two CTAs an SM past 264 rows (at 520 rows, 130 CTAs of four rows read
// 0.0089 ms against 0.0079 for 228 CTAs of two at 456 rows, H100 80GB
// HBM3 at 700 W, bench_kernels.py: the fold,
// the same for every CTA, costs less than the rows it serves)
__host__ __device__ constexpr int rt_rows_per_cta(int N) {
  return N <= 264 ? 1 : N <= 1056 ? 2 : 4;
}
// 16-byte vectors a lane must hold for a whole row: 0 past 8 (read again)
__host__ __device__ constexpr int rt_vpl(int D, int rpc, int epv) {
  const int per = ((D + epv - 1) / epv + 32 * (RT_WARPS / rpc) - 1) /
                  (32 * (RT_WARPS / rpc));
  return per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : 0;
}
__host__ __device__ constexpr size_t rt_fold_bytes(int D, int nt, int es) {
  return (size_t)2 * nt * D * es;
}
__host__ __device__ constexpr bool rt_fold_in_smem(int D, int nt, int es) {
  return rt_fold_bytes(D, nt, es) <= (size_t)RT_FOLD_SMEM_MAX;
}

template <typename T, int VPL, int NTC>
static cudaError_t rt_launch(int grid, size_t smem, cudaStream_t st,
                             const T* x, const T* tw, const T* tb,
                             const T* sw, const T* sb, const T* al,
                             const T* efold, T* out, int N, int D, int nt,
                             int n_mod, int rpc, int vec) {
  static bool attr = false;                // set once per process
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        router_rows<T, VPL, NTC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RT_SMEM_ATTR);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  router_rows<T, VPL, NTC><<<grid, RT_THREADS, smem, st>>>(
      x, tw, tb, sw, sb, al, efold, out, N, D, nt, n_mod, rpc, vec);
  return cudaGetLastError();
}

template <typename T, int NTC>
static cudaError_t rt_launch_vpl(int vpl, int grid, size_t smem,
                                 cudaStream_t st, const T* x, const T* tw,
                                 const T* tb, const T* sw, const T* sb,
                                 const T* al, const T* efold, T* out, int N,
                                 int D, int nt, int n_mod, int rpc, int vec) {
#define RT_L(V)                                                              \
  return rt_launch<T, V, NTC>(grid, smem, st, x, tw, tb, sw, sb, al, efold, \
                              out, N, D, nt, n_mod, rpc, vec)
  switch (vpl) {
    case 1: RT_L(1);
    case 2: RT_L(2);
    case 4: RT_L(4);
    case 8: RT_L(8);
    default: RT_L(0);
  }
#undef RT_L
}

template <typename T>
static int launch_router(const void* x, const void* top_w, const void* top_b,
                         const void* soft_w, const void* soft_b,
                         const void* alpha, void* fold_ws, void* out, int N,
                         int D, int nt, int n_mod, int vec, cudaStream_t st) {
  const int rpc = rt_rows_per_cta(N);
  const int vpl = rt_vpl(D, rpc, rt_epv<T>());
  const bool in_smem = rt_fold_in_smem(D, nt, sizeof(T));
  const T* efold = nullptr;
  if (!in_smem) {
    router_fold<T><<<264, 256, 0, st>>>((const T*)top_w, (const T*)soft_w,
                                        (T*)fold_ws, D, nt, n_mod, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    efold = (const T*)fold_ws;
  }
  const size_t smem =
      rt_head_bytes(nt) + (in_smem ? rt_fold_bytes(D, nt, sizeof(T)) : 0);
  const int grid = (N + rpc - 1) / rpc;
  const cudaError_t e =
      nt <= 4 ? rt_launch_vpl<T, 4>(vpl, grid, smem, st, (const T*)x,
                                    (const T*)top_w, (const T*)top_b,
                                    (const T*)soft_w, (const T*)soft_b,
                                    (const T*)alpha, efold, (T*)out, N, D,
                                    nt, n_mod, rpc, vec)
              : rt_launch_vpl<T, 8>(vpl, grid, smem, st, (const T*)x,
                                    (const T*)top_w, (const T*)top_b,
                                    (const T*)soft_w, (const T*)soft_b,
                                    (const T*)alpha, efold, (T*)out, N, D,
                                    nt, n_mod, rpc, vec);
  return (int)e;
}

// x, out: (N, D); top_w, soft_w: (nt, n_mod * D) torch (out, in) layout;
// top_b, soft_b: (nt,); alpha: (1,) raw parameter -- all of one dtype
// (0 = f32, 1 = bf16).  nt >= 2, any D; vec: x, out and the weights
// 16-byte aligned with D a multiple of 16 / sizeof(T) (16-byte loads).
// fold_ws: (2, nt, D) of the dtype, used where the folded weights do not
// fit in shared memory (asr_router_fold_in_smem 0), else ignored.
ASR_API int asr_fused_router_same(int dtype, const void* x, const void* top_w,
                                  const void* top_b, const void* soft_w,
                                  const void* soft_b, const void* alpha,
                                  void* fold_ws, void* out, int N, int D,
                                  int nt, int n_mod, int vec, void* stream) {
  if (nt < 2 || n_mod < 1 || D < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int es = dtype == ASR_F32 ? 4 : 2;
  if (rt_head_bytes(nt) + (rt_fold_in_smem(D, nt, es)
                               ? rt_fold_bytes(D, nt, es) : 0) > RT_SMEM_ATTR ||
      (!rt_fold_in_smem(D, nt, es) && fold_ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_router<float>(x, top_w, top_b, soft_w, soft_b, alpha,
                                fold_ws, out, N, D, nt, n_mod, vec, st);
  return launch_router<__nv_bfloat16>(x, top_w, top_b, soft_w, soft_b, alpha,
                                      fold_ws, out, N, D, nt, n_mod, vec, st);
}

// the launch plan asr_fused_router_same uses: rows a CTA, vectors a lane
// (0: read again), whether the fold sits in shared memory, smem bytes
ASR_API int asr_router_rows_per_cta(int N) { return rt_rows_per_cta(N); }
ASR_API int asr_router_vpl(int D, int N, int dtype) {
  return rt_vpl(D, rt_rows_per_cta(N), dtype == ASR_F32 ? 4 : 8);
}
ASR_API int asr_router_fold_in_smem(int D, int nt, int dtype) {
  return rt_fold_in_smem(D, nt, dtype == ASR_F32 ? 4 : 2);
}
ASR_API int asr_router_smem_bytes(int D, int nt, int dtype) {
  const int es = dtype == ASR_F32 ? 4 : 2;
  return rt_head_bytes(nt) +
         (rt_fold_in_smem(D, nt, es) ? (int)rt_fold_bytes(D, nt, es) : 0);
}
