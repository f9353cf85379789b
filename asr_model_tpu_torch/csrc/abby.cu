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
// (512 at the flagship width) -- above the card's ridge in bf16 on the
// tensor cores.  At decode widths (N = 8 * 9 .. 8 * 65 rows) a kernel
// with one block per row tile would leave most of the 132 SMs idle.
//
// Design: one launch.  A thread-block cluster per 32-row tile, one CTA
// per 64-column slice of W1 (128-column slices past D = 512, and past
// D = 1024 the 64-column multiple of D / 8, so a cluster has at most 8
// CTAs: 8 at D = 512, 2 at D = 128, 7 at D = 1280).  Each CTA
// computes its slice of h = silu(x W1^T + b1), rounds it to the storage
// type as the reference does, and its partial router logits h_slice
// W2_slice^T, and pushes each row's partials into the shared memory of
// the CTA that owns the row (distributed shared memory; each CTA owns
// 32 / S of the tile's rows).  After one cluster barrier, during which
// each CTA takes its rows' cv, the owner adds the partials in rank order
// (a fixed order, no atomics: the output is deterministic) and b2, routes,
// and runs the tail from the x tile it already holds: a thread per 8
// channels of a row, the squares of the 32 channels around them in
// registers, the maxima sharing the taps the 8 windows hold in common.
//   bf16: the product on the tensor cores, mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate: the Pallas kernel's own contraction) with ldmatrix
//   fragments; the x tile and the W1 slice arrive through cp.async in
//   64-column chunks, one commit group each, so the products of a chunk
//   start while the later chunks are in flight (all of a pass's chunks
//   at once up to D = 1024, a ring of 8 past it, where 64 rows of W1 no
//   longer fit beside the x tile).
//   f32: the product stays on the CUDA cores in full f32 (gemm_rows16;
//   TF32 would not hold the f32 route's 1e-4), in the same one-launch
//   structure; past D = 1024 the tile's rows are held half at a time and
//   the tail reads them from device memory (32 f32 rows of 2048 would
//   not fit in shared memory).
// Windows of up to 51 taps (D <= 1024) run from registers, wider ones
// (up to 103, D = 2048) from the row.
// x is read once per CTA of the cluster (from L2 after the first) and
// written once; the (N, D) hidden never reaches device memory.
#include "abby_cluster.cuh"

constexpr int ABBY_WARPS = 8;     // rows per abby_tail block

template <typename T>
__global__ void __launch_bounds__(AB_THREADS)
abby_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ out, int N,
                    int D, int size, float alpha, float k, float beta,
                    int vec) {
  extern __shared__ __align__(128) unsigned char ab_smem[];
  abby_cluster_tile<T>(x, w1, b1, w2, b2, nullptr, out, N, D, size, alpha, k,
                       beta, vec, blockIdx.y * AB_ROWS, ab_smem);
}

template <typename T>
static int launch_abby(int dtype, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, int N, int D, int size, float alpha,
                       float k, float beta, cudaStream_t st) {
  const int vec = D % 8 == 0 && ((uintptr_t)x | (uintptr_t)w1) % 16 == 0;
  const cudaError_t e = launch_clusters(
      abby_cluster_kernel<T>,
      dim3(abby_cluster_size(D), (N + AB_ROWS - 1) / AB_ROWS, 1),
      abby_cluster_size(D), abby_smem_bytes(dtype, D), st, (const T*)x,
      (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, N, D,
      size, alpha, k, beta, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x, out: (N, D); w1: (D, D) torch (out, in) layout; b1: (D,);
// w2: (3, D); b2: (3,) -- all of one dtype (0 = f32, 1 = bf16);
// 2 <= D <= 2048, N <= 65535 * 32, window 1 <= size <= 103.  One launch.
ASR_API int asr_fused_abby(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, int N, int D, int size, float alpha,
                           float k, float beta, void* stream) {
  if (D < 2 || D > ABBY_MAX_D || N > 65535 * AB_ROWS || size < 1 ||
      size > ABBY_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby<float>(dtype, x, w1, b1, w2, b2, out, N, D, size,
                              alpha, k, beta, st);
  return launch_abby<bf16>(dtype, x, w1, b1, w2, b2, out, N, D, size, alpha,
                           k, beta, st);
}

// the dynamic shared memory and the cluster size asr_fused_abby uses
ASR_API int asr_abby_smem_bytes(int dtype, int D) {
  return (int)abby_smem_bytes(dtype, D);
}
ASR_API int asr_abby_cluster_size(int D) { return abby_cluster_size(D); }

// The tail alone (replaces abby_kernel.py:fused_abby_tail): x, out (N, D)
// of one dtype, logits (N, 3) f32 from the caller's router, no bias.
// D <= ABBY_TAIL_MAX_D (one row per warp in shared memory).
constexpr int ABBY_TAIL_MAX_D = 4096;

template <typename T>
__global__ void __launch_bounds__(256)
abby_tail(const T* __restrict__ x, const float* __restrict__ logits,
          T* __restrict__ out, int N, int D, int size, float alpha, float k,
          float beta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = blockIdx.x * ABBY_WARPS + warp;
  if (r >= N) return;                        // no block-wide sync below
  float* xr = smem + warp * D;
  for (int j = lane; j < D; j += 32) xr[j] = to_f32(x[(size_t)r * D + j]);
  const float lg[3] = {logits[3 * r], logits[3 * r + 1], logits[3 * r + 2]};
  __syncwarp();
  const int choice = abby_choice(xr, D, lg, lane);
  for (int j = lane; j < D; j += 32)
    out[(size_t)r * D + j] =
        from_f32<T>(abby_tail_at(xr, j, D, size, choice, alpha, k, beta));
}

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
      (const T*)x, (const float*)logits, (T*)out, N, D, size, alpha, k, beta);
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
