// Eval-mode AbbyNormal, whole program per row, for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/abby_kernel.py:fused_abby (the
// Pallas kernel that fuses the router MLP and the normalising tail), and
// with asr_fused_abby_tail (the tail launch alone, on the caller's f32
// logits) that file's fused_abby_tail.
//
// Per row x (D values): h = silu(x W1^T + b1) rounded to the storage
// type; logits = h W2^T + b2 (3 values); cv = unbiased std / (mean|x| +
// 1e-6); choice = argmax(logits + cv) (first maximum on ties); over the
// channel axis of x^2 a sliding-window mean (zero padding counted in the
// divisor) and max (-inf padding); div2 = max if max > 2 * mean else
// mean; mix = div2 if choice == 1 else mean; out = x / (alpha * mix +
// k)^beta, in f32, cast back to the storage type.
//
// What bounds it: the router product, 2 * N * D * D operations against
// N * D * 2 * sizeof(T) bytes of activations, i.e. D operations per byte
// (512 at the flagship width) -- above the card's ridge in bf16 on
// tensor cores, far above it on the CUDA cores this version uses.  At
// decode widths (N = 8 * 9 .. 8 * 65 rows) the card is mostly idle, so
// the work is spread over as many blocks as the product allows.
// Design: two launches.  abby_router: one block per (16-row tile,
// 64-column slice) computes that slice of h = silu(x W1^T + b1) (W1
// streaming through a shared (32, 64) tile from L2) and its partial
// router logits h_slice W2_slice^T, written per slice.  abby_tail: one
// warp per row sums the slices' partial logits in a fixed order
// (deterministic), routes, and runs the two sliding windows as a stencil
// over the row in shared memory.  x is read once per slice and written
// once; the (N, D) hidden never reaches device memory.  Tensor-core
// products (wgmma) are the next step for this kernel.
#include "abby_tail.cuh"

constexpr int ABBY_WARPS = 8;  // rows per abby_tail block

template <typename T>
__global__ void __launch_bounds__(256)
abby_router(const T* __restrict__ x, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            float* __restrict__ plog, int N, int D) {
  extern __shared__ float smem[];
  abby_router_tile<T>(x, w1, b1, w2, plog, N, D, blockIdx.x * GEMM_ROWS,
                      blockIdx.y, smem);
}

template <typename T>
__global__ void __launch_bounds__(256)
abby_tail(const T* __restrict__ x, const T* __restrict__ b2,
          const float* __restrict__ plog, T* __restrict__ out, int N, int D,
          int slices, int size, float alpha, float k, float beta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = blockIdx.x * ABBY_WARPS + warp;
  if (r >= N) return;                        // no block-wide sync below
  float* xr = smem + warp * D;
  for (int j = lane; j < D; j += 32) xr[j] = to_f32(x[(size_t)r * D + j]);
  float lg[3];
  abby_logits<T>(plog, N, slices, r, b2, lg);
  __syncwarp();
  const int choice = abby_choice(xr, D, lg, lane);
  for (int j = lane; j < D; j += 32)
    out[(size_t)r * D + j] =
        from_f32<T>(abby_tail_at(xr, j, D, size, choice, alpha, k, beta));
}

template <typename T>
static int launch_abby(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* plog,
                       int N, int D, int size, float alpha, float k,
                       float beta, cudaStream_t st) {
  const size_t smem_r = sizeof(float) * abby_router_smem_floats(D);
  cudaFuncSetAttribute(abby_router<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_r);
  const int slices = (D + GEMM_NT - 1) / GEMM_NT;
  const dim3 grid_r((N + GEMM_ROWS - 1) / GEMM_ROWS, slices);
  abby_router<T><<<grid_r, 256, smem_r, st>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (float*)plog, N,
      D);
  const size_t smem_t = sizeof(float) * ABBY_WARPS * D;
  const int grid_t = (N + ABBY_WARPS - 1) / ABBY_WARPS;
  abby_tail<T><<<grid_t, 32 * ABBY_WARPS, smem_t, st>>>(
      (const T*)x, (const T*)b2, (const float*)plog, (T*)out, N, D, slices,
      size, alpha, k, beta);
  return (int)cudaGetLastError();
}

// x, out: (N, D); w1: (D, D) torch (out, in) layout; b1: (D,);
// w2: (3, D); b2: (3,) -- all of one dtype (0 = f32, 1 = bf16);
// plog: f32 workspace of ceil(D / 64) * N * 3 partial router logits.
ASR_API int asr_fused_abby(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, void* plog, int N, int D, int size,
                           float alpha, float k, float beta, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby<float>(x, w1, b1, w2, b2, out, plog, N, D, size,
                              alpha, k, beta, st);
  return launch_abby<__nv_bfloat16>(x, w1, b1, w2, b2, out, plog, N, D, size,
                                    alpha, k, beta, st);
}

// The tail alone (replaces abby_kernel.py:fused_abby_tail): x, out (N, D)
// of one dtype, logits (N, 3) f32 from the caller's router, no bias.
// D <= ABBY_TAIL_MAX_D (one row per warp in shared memory).
constexpr int ABBY_TAIL_MAX_D = 4096;

template <typename T>
static int launch_abby_tail(const void* x, const void* logits, void* out,
                            int N, int D, int size, float alpha, float k,
                            float beta, cudaStream_t st) {
  const size_t smem = sizeof(float) * ABBY_WARPS * D;
  cudaFuncSetAttribute(abby_tail<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = (N + ABBY_WARPS - 1) / ABBY_WARPS;
  abby_tail<T><<<grid, 32 * ABBY_WARPS, smem, st>>>(
      (const T*)x, (const T*)nullptr, (const float*)logits, (T*)out, N, D,
      1, size, alpha, k, beta);
  return (int)cudaGetLastError();
}

ASR_API int asr_fused_abby_tail(int dtype, const void* x, const void* logits,
                                void* out, int N, int D, int size,
                                float alpha, float k, float beta,
                                void* stream) {
  if (D < 2 || D > ABBY_TAIL_MAX_D) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby_tail<float>(x, logits, out, N, D, size, alpha, k,
                                   beta, st);
  return launch_abby_tail<__nv_bfloat16>(x, logits, out, N, D, size, alpha,
                                         k, beta, st);
}

ASR_API const char* asr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
