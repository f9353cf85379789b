// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every entry point is a plain C function taking device pointers, sizes
// and the caller's stream; it launches on that stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define ASR_API extern "C" __attribute__((visibility("default")))

// element types the kernels take: 0 = float32, 1 = bfloat16
enum AsrDtype { ASR_F32 = 0, ASR_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float siluf_(float v) { return v * sigmoidf_(v); }

// ---------------------------------------------------------------------
// Row-tile GEMM: out[r][n] = sum_k A[r][k] * W(k, n) for the 16 rows of
// a tile held in shared memory (f32, row stride lda) against a weight
// matrix in device memory, for the 64 output columns [n0, n0 + 64).
//
//   KN = true : W(k, n) = w[k * ldw + n]   (flax (in, out) kernels)
//   KN = false: W(k, n) = w[n * ldw + k]   (torch (out, in) weights)
//
// 256 threads: thread t owns column n0 + (t % 64) and the four rows
// 4 * (t / 64) .. + 3, so a warp reads one A element as a broadcast and
// 32 consecutive weight columns from the staged tile.  Weights stream
// through a (32, 64) shared tile (`wt`, 32 * 65 floats, padded against
// bank conflicts) with coalesced loads in either layout.  acc[i] holds
// the sum for row 4 * (t / 64) + i; columns past N and k past K read 0.
// All 256 threads must call it (it synchronises).
constexpr int GEMM_ROWS = 16;
constexpr int GEMM_NT = 64;
constexpr int GEMM_KC = 32;
constexpr int GEMM_WT_FLOATS = GEMM_KC * (GEMM_NT + 1);

template <typename TW, bool KN>
__device__ void gemm_rows16(const float* A, int lda, int K, const TW* w,
                            int ldw, int n0, int N, float* wt,
                            float acc[4]) {
  const int t = threadIdx.x;
  const int col = t % GEMM_NT;
  const int rg = t / GEMM_NT;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += GEMM_KC) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int kk, nn;
      if (KN) {
        nn = t % GEMM_NT;
        kk = t / GEMM_NT + 4 * e;
      } else {
        kk = t % GEMM_KC;
        nn = t / GEMM_KC + 8 * e;
      }
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.0f;
      if (k < K && n < N)
        v = KN ? to_f32(w[(size_t)k * ldw + n])
               : to_f32(w[(size_t)n * ldw + k]);
      wt[kk * (GEMM_NT + 1) + nn] = v;
    }
    __syncthreads();
    const int kmax = min(GEMM_KC, K - k0);
    const float* a = A + (rg * 4) * lda + k0;
    for (int kk = 0; kk < kmax; ++kk) {
      const float wv = wt[kk * (GEMM_NT + 1) + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(a[i * lda + kk], wv, acc[i]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// Row products with an epilogue: out = epi(a W^T + bias) rounded to the
// storage type, for a (N, K) x W (Nout, K) in torch (out, in) layout.
// One block per (16-row tile, 64-column slice): the tile's rows go to
// shared memory (f32 of the storage values), LIN_KCH columns at a time
// (once, for K <= LIN_KCH), and W streams through gemm_rows16.  Shared
// floats: linear_rows_smem_floats(K).
enum LinearEpilogue { LIN_NONE = 0, LIN_GELU = 1, LIN_SILU = 2 };
constexpr int LIN_KCH = 2048;

__host__ __device__ constexpr int linear_rows_smem_floats(int K) {
  return GEMM_ROWS * (K < LIN_KCH ? K : LIN_KCH) + GEMM_WT_FLOATS;
}

// torch's exact GELU: 0.5 x (1 + erf(x / sqrt(2)))
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <typename T, int EPI>
__global__ void __launch_bounds__(256)
linear_rows(const T* __restrict__ a, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ out, int N, int K,
            int Nout) {
  extern __shared__ float smem[];
  const int kch = K < LIN_KCH ? K : LIN_KCH;
  float* as = smem;                          // [16][kch]
  float* wt = as + GEMM_ROWS * kch;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += kch) {
    const int kc = min(kch, K - k0);
    for (int e = t; e < GEMM_ROWS * kc; e += blockDim.x) {
      const int r = e / kc, j = e % kc;
      as[e] = (r0 + r < N) ? to_f32(a[(size_t)(r0 + r) * K + k0 + j]) : 0.0f;
    }
    __syncthreads();
    float part[4];
    gemm_rows16<T, false>(as, kc, kc, w + k0, K, n0, Nout, wt, part);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += part[i];
  }
  const int n = n0 + t % GEMM_NT;
  if (n >= Nout) return;
  const float b = to_f32(bias[n]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * (t / GEMM_NT) + i;
    if (r >= N) continue;
    float v = acc[i] + b;
    if (EPI == LIN_GELU) v = gelu_erf(v);
    if (EPI == LIN_SILU) v = siluf_(v);
    out[(size_t)r * Nout + n] = from_f32<T>(v);
  }
}

template <typename T, int EPI>
static void launch_linear_rows(const void* a, const void* w, const void* bias,
                               void* out, int N, int K, int Nout,
                               cudaStream_t st) {
  const size_t smem = sizeof(float) * linear_rows_smem_floats(K);
  cudaFuncSetAttribute(linear_rows<T, EPI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((N + GEMM_ROWS - 1) / GEMM_ROWS,
                  (Nout + GEMM_NT - 1) / GEMM_NT);
  linear_rows<T, EPI><<<grid, 256, smem, st>>>(
      (const T*)a, (const T*)w, (const T*)bias, (T*)out, N, K, Nout);
}
