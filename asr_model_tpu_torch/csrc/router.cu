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
// bytes.  Design: one launch; each block folds the (nt, n_mod * D)
// weights into (nt, D) in shared memory (a few thousand loads from L2)
// and gives each of its 8 warps one row: two nt-wide dot products with
// warp reductions, the selection on every lane, one scaled store.
#include "common.cuh"

constexpr int ROUTER_WARPS = 8;
constexpr int ROUTER_MAX_NT = 8;
constexpr float ROUTER_NEG = -1e30f;

template <typename T>
__global__ void __launch_bounds__(256)
router_same(const T* __restrict__ x, const T* __restrict__ top_w,
            const T* __restrict__ top_b, const T* __restrict__ soft_w,
            const T* __restrict__ soft_b, const T* __restrict__ alpha_raw,
            T* __restrict__ out, int N, int D, int nt, int n_mod) {
  extern __shared__ float smem[];
  float* et = smem;                          // [nt][D] folded top weights
  float* es = et + nt * D;                   // [nt][D] folded soft weights
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int W = n_mod * D;
  for (int e = t; e < nt * D; e += blockDim.x) {
    const int c = e / D, k = e % D;
    float st = to_f32(top_w[(size_t)c * W + k]);
    float ss = to_f32(soft_w[(size_t)c * W + k]);
    for (int i = 1; i < n_mod; ++i) {
      st += to_f32(top_w[(size_t)c * W + i * D + k]);
      ss += to_f32(soft_w[(size_t)c * W + i * D + k]);
    }
    et[e] = to_f32(from_f32<T>(st));
    es[e] = to_f32(from_f32<T>(ss));
  }
  __syncthreads();

  const int r = blockIdx.x * ROUTER_WARPS + warp;
  if (r >= N) return;                        // no block-wide sync below
  const T* xr = x + (size_t)r * D;
  float top[ROUTER_MAX_NT], soft[ROUTER_MAX_NT];
  for (int c = 0; c < nt; ++c) {
    float a = 0.0f, b = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float v = to_f32(xr[j]);
      a = fmaf(v, et[c * D + j], a);
      b = fmaf(v, es[c * D + j], b);
    }
    top[c] = warp_sum(a) + to_f32(top_b[c]);
    soft[c] = warp_sum(b) + to_f32(soft_b[c]);
  }
  // softmax of the soft scores
  float mx = soft[0];
  for (int c = 1; c < nt; ++c) mx = fmaxf(mx, soft[c]);
  float z = 0.0f;
  for (int c = 0; c < nt; ++c) {
    soft[c] = expf(soft[c] - mx);
    z += soft[c];
  }
  // top-2 of the top scores, first occurrence on ties
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
    scale += al * hard + (1.0f - al) * (soft[c] / z);
  }
  for (int j = lane; j < D; j += 32)
    out[(size_t)r * D + j] = from_f32<T>(to_f32(xr[j]) * scale);
}

template <typename T>
static int launch_router(const void* x, const void* top_w, const void* top_b,
                         const void* soft_w, const void* soft_b,
                         const void* alpha, void* out, int N, int D, int nt,
                         int n_mod, cudaStream_t st) {
  const size_t smem = sizeof(float) * 2 * nt * D;
  cudaFuncSetAttribute(router_same<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (N + ROUTER_WARPS - 1) / ROUTER_WARPS;
  router_same<T><<<grid, 32 * ROUTER_WARPS, smem, st>>>(
      (const T*)x, (const T*)top_w, (const T*)top_b, (const T*)soft_w,
      (const T*)soft_b, (const T*)alpha, (T*)out, N, D, nt, n_mod);
  return (int)cudaGetLastError();
}

// x, out: (N, D); top_w, soft_w: (nt, n_mod * D) torch (out, in) layout;
// top_b, soft_b: (nt,); alpha: (1,) raw parameter -- all of one dtype
// (0 = f32, 1 = bf16).  2 <= nt <= 8; 2 * nt * D floats of shared memory.
ASR_API int asr_fused_router_same(int dtype, const void* x, const void* top_w,
                                  const void* top_b, const void* soft_w,
                                  const void* soft_b, const void* alpha,
                                  void* out, int N, int D, int nt, int n_mod,
                                  void* stream) {
  if (nt < 2 || nt > ROUTER_MAX_NT || n_mod < 1 || 2 * nt * D > 49152)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_router<float>(x, top_w, top_b, soft_w, soft_b, alpha, out,
                                N, D, nt, n_mod, st);
  return launch_router<__nv_bfloat16>(x, top_w, top_b, soft_w, soft_b, alpha,
                                       out, N, D, nt, n_mod, st);
}
