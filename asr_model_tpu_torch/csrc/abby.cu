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
// Past D = 2048 the tile is not held at all: bf16 streams x's 64-column
// chunks through the W1 ring beside W1's (x read again from L2 for each
// 64-column pass of the slice), f32 takes the product 512 columns of x at
// a time, and the cv and the tail read the rows from device memory.
// Windows of up to 51 taps (D <= 1024) run from registers, wider ones
// (103 at D = 2048, 205 at 4096, any) from the row.
// Past the width whose staged slices fit a block (about 59,000 in bf16)
// the global route below runs the same function in three launches
// (asr_abby_global).
// x is read once per CTA of the cluster (from L2 after the first) and
// written once; the (N, D) hidden never reaches device memory.
#include "abby_cluster.cuh"

template <typename T, bool WIDE>
__global__ void __launch_bounds__(AB_THREADS)
abby_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ out, int N,
                    int D, int size, float alpha, float k, float beta,
                    int vec) {
  extern __shared__ __align__(128) unsigned char ab_smem[];
  abby_cluster_tile<T, WIDE>(x, w1, b1, w2, b2, nullptr, out, N, D, size,
                             alpha, k, beta, vec, blockIdx.y * AB_ROWS,
                             ab_smem);
}

template <typename T>
static int launch_abby(int dtype, const void* x, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, int N, int D, int size, float alpha,
                       float k, float beta, cudaStream_t st) {
  const int vec = D % 8 == 0 && ((uintptr_t)x | (uintptr_t)w1) % 16 == 0;
  const cudaError_t e = launch_clusters(
      abby_wide(D) ? abby_cluster_kernel<T, true>
                   : abby_cluster_kernel<T, false>,
      dim3(abby_cluster_size(D), (N + AB_ROWS - 1) / AB_ROWS, 1),
      abby_cluster_size(D), abby_smem_bytes(dtype, D), st, (const T*)x,
      (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, N, D,
      size, alpha, k, beta, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x, out: (N, D); w1: (D, D) torch (out, in) layout; b1: (D,);
// w2: (3, D); b2: (3,) -- all of one dtype (0 = f32, 1 = bf16);
// D >= 2 (past AB_STREAM_D the WIDE variant; the shared memory of the
// staged W2 and b1 slices bounds D at about 57,000), N <= 65535 * 32,
// any window size.  One launch.
ASR_API int asr_fused_abby(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           void* out, int N, int D, int size, float alpha,
                           float k, float beta, void* stream) {
  if (D < 2 || N > 65535 * AB_ROWS || size < 1 ||
      abby_smem_bytes(dtype, D) > 232448)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby<float>(dtype, x, w1, b1, w2, b2, out, N, D, size,
                              alpha, k, beta, st);
  return launch_abby<bf16>(dtype, x, w1, b1, w2, b2, out, N, D, size, alpha,
                           k, beta, st);
}

// ---------------------------------------------------------------------
// The global route, past the width whose staged W2 and b1 slices fit a
// block (abby_smem_bytes > 232448: D past 59,392 in bf16, 92,160 in
// f32).  The same function in three launches, every row in device
// memory: h = silu(x W1^T + b1) rounded to the storage type
// (linear_rows, CUDA-core products in full f32, into `hbuf`), then a
// warp a row takes the router logits h W2^T + b2, the row's cv
// (abby_row_cv) and the route (the first maximum, into `choice`), then a
// thread per 8 channels of a row runs the tail over windows read from
// the row in L2 (abby_tail8_wide).  What bounds it: the router product
// (2 N D^2), whose D^2 weights dominate the bytes at these widths.
template <typename T>
__global__ void __launch_bounds__(256)
abby_global_route(const T* __restrict__ x, const T* __restrict__ h,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  int* __restrict__ choice, int N, int D) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= N) return;
  const T* hr = h + (size_t)r * D;
  float lg[3] = {0.0f, 0.0f, 0.0f};
  for (int j = lane; j < D; j += 32) {
    const float hv = to_f32(hr[j]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lg[c] = fmaf(hv, to_f32(w2[(size_t)c * D + j]), lg[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) lg[c] = warp_sum(lg[c]);
  const float cv = abby_row_cv(x + (size_t)r * D, D, lane);
  if (lane == 0) {
    int best = 0;
    float bv = lg[0] + to_f32(b2[0]) + cv;
    for (int c = 1; c < 3; ++c) {
      const float v = lg[c] + to_f32(b2[c]) + cv;
      if (v > bv) {
        bv = v;
        best = c;
      }
    }
    choice[r] = best;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
abby_global_tail(const T* __restrict__ x, const int* __restrict__ choice,
                 const T* __restrict__ res, T* __restrict__ out, int D,
                 int size, float alpha, float k, float beta) {
  const int r = blockIdx.x;
  const int j0 = 8 * (blockIdx.y * 256 + threadIdx.x);
  if (j0 >= D) return;
  const size_t o = (size_t)r * D;
  abby_tail8_wide(x + o, j0, D, size, choice[r], alpha, k, beta, out + o,
                  res ? res + o : nullptr);
}

template <typename T>
static int launch_abby_global(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* res,
                              void* out, void* hbuf, int* choice, int N,
                              int D, int size, float alpha, float k,
                              float beta, cudaStream_t st) {
  launch_linear_rows<T, LIN_SILU>(x, w1, b1, hbuf, N, D, D, st);
  abby_global_route<T><<<(N + 7) / 8, 256, 0, st>>>(
      (const T*)x, (const T*)hbuf, (const T*)w2, (const T*)b2, choice, N, D);
  abby_global_tail<T><<<dim3(N, ((D + 7) / 8 + 255) / 256), 256, 0, st>>>(
      (const T*)x, choice, (const T*)res, (T*)out, D, size, alpha, k, beta);
  return (int)cudaGetLastError();
}

// x, out, res (or null): (N, D); weights as asr_fused_abby's; hbuf (N, D)
// of the dtype and choice (N) ints of device memory from the caller.
// Any D >= 2, N <= 65535 * 32.  Three launches.
ASR_API int asr_abby_global(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* res, void* out, void* hbuf,
                            void* choice, int N, int D, int size,
                            float alpha, float k, float beta, void* stream) {
  if (D < 2 || N > 65535 * AB_ROWS || size < 1 || !hbuf || !choice)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby_global<float>(x, w1, b1, w2, b2, res, out, hbuf,
                                     (int*)choice, N, D, size, alpha, k,
                                     beta, st);
  return launch_abby_global<bf16>(x, w1, b1, w2, b2, res, out, hbuf,
                                  (int*)choice, N, D, size, alpha, k, beta,
                                  st);
}

// the dynamic shared memory and the cluster size asr_fused_abby uses
ASR_API int asr_abby_smem_bytes(int dtype, int D) {
  return (int)abby_smem_bytes(dtype, D);
}
ASR_API int asr_abby_cluster_size(int D) { return abby_cluster_size(D); }

// ---------------------------------------------------------------------
// The tail alone (replaces abby_kernel.py:fused_abby_tail): x, out (N, D)
// of one dtype, logits (N, 3) f32 from the caller's router, no bias.
//
// What bounds it: 2 N D sizeof(T) bytes against ~2 size operations a
// value: bytes at decode widths, where a launch's few microseconds are
// most of the time.  Design: one launch of abby_tail_tile, rpc rows a CTA
// (about one CTA an SM: rpc = ceil(N / 132), at most 32), 256 threads.
// The CTA copies its rows into shared memory with 16-byte loads (rows
// wider than TL_SMEM_MAX bytes a tile stay in device memory and are read
// from L2), takes each row's cv and route (argmax(logits + cv), the first
// maximum on ties, as abby_choice) a warp a row, and runs the register
// tail of abby_cluster.cuh (fused_abby's): a thread per 8 channels, the
// squares of the channels around them in registers, the maxima sharing
// the taps the 8 windows hold in common (abby_tail8_sized at 25 and 7
// taps, abby_tail8 up to 51, the row itself past that), each window
// summed in channel order.  Any D.
constexpr int TL_SMEM_MAX = 96 * 1024;  // rows a CTA copies, bytes
constexpr int TL_MAX_RPC = 32;

__host__ __device__ constexpr int tl_rows_per_cta(int N) {
  return N <= 132 ? 1 : (N + 131) / 132 < TL_MAX_RPC ? (N + 131) / 132
                                                       : TL_MAX_RPC;
}
__host__ __device__ constexpr size_t tl_rows_bytes(int rpc, int D, int es) {
  return (size_t)rpc * D * es;
}
__host__ __device__ constexpr bool tl_rows_in_smem(int rpc, int D, int es) {
  return tl_rows_bytes(rpc, D, es) <= (size_t)TL_SMEM_MAX;
}

template <typename T, int SIZE>
__global__ void __launch_bounds__(AB_THREADS)
abby_tail_tile(const T* __restrict__ x, const float* __restrict__ logits,
               T* __restrict__ out, int N, int D, int size, float alpha,
               float k, float beta, int rpc, int in_smem, int vec) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  using TS = typename std::conditional<sizeof(T) == 2, bf16, float>::type;
  int* chs = reinterpret_cast<int*>(tl_smem);          // [rpc] routes
  TS* xs = reinterpret_cast<TS*>(tl_smem + 4 * TL_MAX_RPC);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * rpc, nrows = min(rpc, N - r0);
  const TS* src = reinterpret_cast<const TS*>(x) + (size_t)r0 * D;
  // the first row of each warp's logits now, so that their loads overlap
  // the rows'
  float lg0[3] = {0.0f, 0.0f, 0.0f};
  if (lane == 0 && warp < nrows)
    for (int c = 0; c < 3; ++c) lg0[c] = logits[(size_t)(r0 + warp) * 3 + c];
  if (in_smem) {
    if (vec) {                               // 16-byte copies
      const int n16 = nrows * D * (int)sizeof(T) / 16;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(xs);
      for (int e = t; e < n16; e += AB_THREADS) d4[e] = __ldg(s4 + e);
    } else {
      for (int e = t; e < nrows * D; e += AB_THREADS) xs[e] = src[e];
    }
    __syncthreads();
  }
  const TS* xrows = in_smem ? xs : src;
  for (int rr = warp; rr < nrows; rr += AB_THREADS / 32) {
    const float cv = abby_row_cv(xrows + (size_t)rr * D, D, lane);
    if (lane == 0) {
      float lg[3];
      for (int c = 0; c < 3; ++c)
        lg[c] = rr == warp ? lg0[c] : logits[(size_t)(r0 + rr) * 3 + c];
      int best = 0;
      float bv = lg[0] + cv;
      for (int c = 1; c < 3; ++c) {
        const float v = lg[c] + cv;
        if (v > bv) {
          bv = v;
          best = c;
        }
      }
      chs[rr] = best;
    }
  }
  __syncthreads();
  abby_tail_rows<SIZE>(xrows, D, 0, nrows, r0, N, D, size, chs, alpha, k,
                       beta, static_cast<const T*>(nullptr), out);
}

template <typename T, int SIZE>
static cudaError_t launch_tail_sized(int grid, size_t smem, cudaStream_t st,
                                     const T* x, const float* lg, T* out,
                                     int N, int D, int size, float alpha,
                                     float k, float beta, int rpc,
                                     int in_smem, int vec) {
  static bool attr = false;                // set once per process
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        abby_tail_tile<T, SIZE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * TL_MAX_RPC + TL_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  abby_tail_tile<T, SIZE><<<grid, AB_THREADS, smem, st>>>(
      x, lg, out, N, D, size, alpha, k, beta, rpc, in_smem, vec);
  return cudaGetLastError();
}

template <typename T>
static int launch_abby_tail(const void* x, const void* logits, void* out,
                            int N, int D, int size, float alpha, float k,
                            float beta, int vec, cudaStream_t st) {
  const int rpc = tl_rows_per_cta(N);
  const int in_smem = tl_rows_in_smem(rpc, D, sizeof(T));
  const size_t smem =
      4 * TL_MAX_RPC + (in_smem ? tl_rows_bytes(rpc, D, sizeof(T)) : 0);
  const int grid = (N + rpc - 1) / rpc;
  const T* xt = (const T*)x;
  const float* lg = (const float*)logits;
  cudaError_t e;
  if (size == 25)         // window_size(512)
    e = launch_tail_sized<T, 25>(grid, smem, st, xt, lg, (T*)out, N, D, size,
                                 alpha, k, beta, rpc, in_smem, vec);
  else if (size == 7)     // window_size(128)
    e = launch_tail_sized<T, 7>(grid, smem, st, xt, lg, (T*)out, N, D, size,
                                alpha, k, beta, rpc, in_smem, vec);
  else
    e = launch_tail_sized<T, 0>(grid, smem, st, xt, lg, (T*)out, N, D, size,
                                alpha, k, beta, rpc, in_smem, vec);
  return (int)e;
}

// vec: x 16-byte aligned and D sizeof(T) a multiple of 16 (16-byte
// copies); any D >= 2, any window size >= 1.
ASR_API int asr_fused_abby_tail(int dtype, const void* x, const void* logits,
                                void* out, int N, int D, int size,
                                float alpha, float k, float beta, int vec,
                                void* stream) {
  if (D < 2 || size < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_abby_tail<float>(x, logits, out, N, D, size, alpha, k,
                                   beta, vec, st);
  return launch_abby_tail<bf16>(x, logits, out, N, D, size, alpha, k, beta,
                                vec, st);
}

// the tail's plan: rows a CTA, and whether they are copied to shared
// memory (else read from L2)
ASR_API int asr_abby_tail_rows_per_cta(int N) { return tl_rows_per_cta(N); }
ASR_API int asr_abby_tail_rows_in_smem(int N, int D, int dtype) {
  return tl_rows_in_smem(tl_rows_per_cta(N), D, dtype == ASR_F32 ? 4 : 2);
}

ASR_API const char* asr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
