// The residual-MLP tail of a decoder block, x + ln(W_out gelu(W_in
// tgate(ln(x)))), for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/mlp_kernel.py:fused_mlp_residual.
//
// Per row x (D values), with one AbbyNormal `ln` (router weights shared
// by both positions) and nt TGate gates:
//   h0 = ln(x)                          rounded to the storage type
//   types = softmax(h0 cs^T + cs_b)     (nt values)
//   h1 = sum_i sigmoid(h0 G_i^T + g_i) * types_i, rounded
//   h2 = gelu(h1 W_in^T + b_in)         (3D wide, exact erf), rounded
//   h3 = h2 W_out^T + b_out, rounded
//   out = x + ln(h3)                    in f32, cast to the storage type
// Products take storage-type operands with f32 sums; everything between
// them is f32, rounded where the reference rounds (before each product).
//
// What bounds it: 11 D^2 multiply-adds a row (two router products, nt = 3
// gates, W_in, W_out) against ~5 MB of bf16 weights at D = 512: at decode
// widths (N = 8 x 9 .. 8 x 65 rows) the weights dominate the bytes and
// the card is bound by operations only above ~300 rows on tensor cores;
// on the CUDA cores this version uses, by operations.  The weights do not
// fit in shared memory, so every product streams them through a shared
// tile (gemm_rows16).  Each product needs whole rows of its input, so
// the call is the chain of launches those dependencies force, each split
// over (16-row tile, 64-column slice) blocks to fill the card:
//   1 router of ln on x -> partial logits      (abby_router_tile)
//   2 tail of ln + cs + the gates -> h1        (mlp_gates)
//   3 W_in + gelu -> h2                        (linear_rows)
//   4 W_out -> h3                              (linear_rows)
//   5 router of ln on h3 -> partial logits     (abby_router_tile)
//   6 tail of ln on h3 + the residual -> out   (mlp_tail)
// Six launches a call, against about a dozen PyTorch dispatches on the
// module route.  Intermediates h1, h2, h3 (N x 5D values) stay in the L2.
#include "abby_tail.cuh"

constexpr int MLP_MAX_NT = 4;
constexpr int MLP_WARPS = 8;               // rows per mlp_tail block

struct MlpGates {
  const void* w[MLP_MAX_NT];               // (D, D) torch layout
  const void* b[MLP_MAX_NT];               // (D,)
};

template <typename T>
__global__ void __launch_bounds__(256)
mlp_norm_router(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2,
                float* __restrict__ plog, int N, int D) {
  extern __shared__ float smem[];
  abby_router_tile<T>(x, w1, b1, w2, plog, N, D, blockIdx.x * GEMM_ROWS,
                      blockIdx.y, smem);
}

template <typename T>
__global__ void __launch_bounds__(256)
mlp_gates(const T* __restrict__ x, const float* __restrict__ plog,
          const T* __restrict__ ln_b2, const T* __restrict__ cs_w,
          const T* __restrict__ cs_b, MlpGates gates, T* __restrict__ h1,
          int N, int D, int nt, int size, float alpha, float k, float beta) {
  extern __shared__ float smem[];
  float* xs = smem;                          // [16][D]: x, then h0
  float* wt = xs + GEMM_ROWS * D;
  float* tys = wt + GEMM_WT_FLOATS;          // [16][MLP_MAX_NT]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  const int slices = (D + GEMM_NT - 1) / GEMM_NT;

  for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
    const int r = e / D, j = e % D;
    xs[e] = (r0 + r < N) ? to_f32(x[(size_t)(r0 + r) * D + j]) : 0.0f;
  }
  __syncthreads();
  // h0 = ln(x), rounded; every slice's block runs the (cheap) tail of
  // its rows again rather than wait on another launch
  for (int r = warp; r < GEMM_ROWS && r0 + r < N; r += blockDim.x / 32) {
    float lg[3];
    abby_logits<T>(plog, N, slices, r0 + r, ln_b2, lg);
    abby_row_tail_inplace<T, true>(xs + r * D, D, lg, size, alpha, k, beta,
                                   lane);
  }
  __syncthreads();
  // types = softmax(h0 cs^T + cs_b), one warp per (row, type)
  for (int o = warp; o < GEMM_ROWS * nt; o += blockDim.x / 32) {
    const int r = o / nt, c = o % nt;
    float s = 0.0f;
    for (int j = lane; j < D; j += 32)
      s += xs[r * D + j] * to_f32(cs_w[(size_t)c * D + j]);
    s = warp_sum(s);
    if (lane == 0) tys[r * MLP_MAX_NT + c] = s + to_f32(cs_b[c]);
  }
  __syncthreads();
  if (t < GEMM_ROWS) {
    float* ty = tys + t * MLP_MAX_NT;
    float mx = ty[0];
    for (int c = 1; c < nt; ++c) mx = fmaxf(mx, ty[c]);
    float z = 0.0f;
    for (int c = 0; c < nt; ++c) {
      ty[c] = expf(ty[c] - mx);
      z += ty[c];
    }
    for (int c = 0; c < nt; ++c) ty[c] = ty[c] / z;
  }
  __syncthreads();
  // h1 = sum_i sigmoid(h0 G_i^T + g_i) * types_i for this column slice
  const int n = n0 + t % GEMM_NT;
  float hsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < nt; ++i) {
    float acc[4];
    gemm_rows16<T, false>(xs, D, D, (const T*)gates.w[i], D, n0, D, wt, acc);
    const float gb = n < D ? to_f32(((const T*)gates.b[i])[n]) : 0.0f;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = 4 * (t / GEMM_NT) + ii;
      hsum[ii] += sigmoidf_(acc[ii] + gb) * tys[r * MLP_MAX_NT + i];
    }
  }
  if (n >= D) return;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = r0 + 4 * (t / GEMM_NT) + ii;
    if (r < N) h1[(size_t)r * D + n] = from_f32<T>(hsum[ii]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
mlp_tail(const T* __restrict__ x, const T* __restrict__ h3,
         const float* __restrict__ plog, const T* __restrict__ ln_b2,
         T* __restrict__ out, int N, int D, int size, float alpha, float k,
         float beta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = blockIdx.x * MLP_WARPS + warp;
  if (r >= N) return;                        // no block-wide sync below
  float* hr = smem + warp * D;
  for (int j = lane; j < D; j += 32) hr[j] = to_f32(h3[(size_t)r * D + j]);
  float lg[3];
  abby_logits<T>(plog, N, (D + GEMM_NT - 1) / GEMM_NT, r, ln_b2, lg);
  __syncwarp();
  abby_row_tail_inplace<T, false>(hr, D, lg, size, alpha, k, beta, lane);
  for (int j = lane; j < D; j += 32)
    out[(size_t)r * D + j] = from_f32<T>(to_f32(x[(size_t)r * D + j]) + hr[j]);
}

template <typename T>
static int launch_mlp(const void* x, const void* ln_w1, const void* ln_b1,
                      const void* ln_w2, const void* ln_b2, const void* cs_w,
                      const void* cs_b, const MlpGates& gates, int nt,
                      const void* in_w, const void* in_b, const void* out_w,
                      const void* out_b, void* out, void* plog1, void* plog2,
                      void* h1, void* h2, void* h3, int N, int D, int H,
                      int size, float alpha, float k, float beta,
                      cudaStream_t st) {
  const int slices = (D + GEMM_NT - 1) / GEMM_NT;
  const dim3 grid_d((N + GEMM_ROWS - 1) / GEMM_ROWS, slices);
  const size_t smem_r = sizeof(float) * abby_router_smem_floats(D);
  cudaFuncSetAttribute(mlp_norm_router<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_r);
  mlp_norm_router<T><<<grid_d, 256, smem_r, st>>>(
      (const T*)x, (const T*)ln_w1, (const T*)ln_b1, (const T*)ln_w2,
      (float*)plog1, N, D);

  const size_t smem_g =
      sizeof(float) * (GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * MLP_MAX_NT);
  cudaFuncSetAttribute(mlp_gates<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_g);
  mlp_gates<T><<<grid_d, 256, smem_g, st>>>(
      (const T*)x, (const float*)plog1, (const T*)ln_b2, (const T*)cs_w,
      (const T*)cs_b, gates, (T*)h1, N, D, nt, size, alpha, k, beta);

  launch_linear_rows<T, LIN_GELU>(h1, in_w, in_b, h2, N, D, H, st);
  launch_linear_rows<T, LIN_NONE>(h2, out_w, out_b, h3, N, H, D, st);

  mlp_norm_router<T><<<grid_d, 256, smem_r, st>>>(
      (const T*)h3, (const T*)ln_w1, (const T*)ln_b1, (const T*)ln_w2,
      (float*)plog2, N, D);

  const size_t smem_t = sizeof(float) * MLP_WARPS * D;
  mlp_tail<T><<<(N + MLP_WARPS - 1) / MLP_WARPS, 32 * MLP_WARPS, smem_t,
                st>>>((const T*)x, (const T*)h3, (const float*)plog2,
                      (const T*)ln_b2, (T*)out, N, D, size, alpha, k, beta);
  return (int)cudaGetLastError();
}

// x, out: (N, D); ln_w1 (D, D), ln_b1 (D,), ln_w2 (3, D), ln_b2 (3,): the
// shared AbbyNormal router; cs_w (nt, D), cs_b (nt,); gate_w[i] (D, D),
// gate_b[i] (D,) for i < nt; in_w (H, D), in_b (H,); out_w (D, H),
// out_b (D,) -- torch (out, in) layouts, all of one dtype (0 = f32,
// 1 = bf16).  Workspace from the caller: plog1, plog2 f32 of
// ceil(D / 64) * N * 3 each; h1 (N, D), h2 (N, H), h3 (N, D) of the dtype.
// D <= 1024, H <= 3072, nt <= 4.  Six launches.
ASR_API int asr_fused_mlp_residual(
    int dtype, const void* x, const void* ln_w1, const void* ln_b1,
    const void* ln_w2, const void* ln_b2, const void* cs_w, const void* cs_b,
    const void* const* gate_w, const void* const* gate_b, int nt,
    const void* in_w, const void* in_b, const void* out_w, const void* out_b,
    void* out, void* plog1, void* plog2, void* h1, void* h2, void* h3, int N,
    int D, int H, int size, float alpha, float k, float beta, void* stream) {
  if (D < 2 || D > ABBY_MAX_D || H < 1 || H > 3 * ABBY_MAX_D || nt < 1 ||
      nt > MLP_MAX_NT)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  MlpGates gates = {};
  for (int i = 0; i < nt; ++i) {
    gates.w[i] = gate_w[i];
    gates.b[i] = gate_b[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_mlp<float>(x, ln_w1, ln_b1, ln_w2, ln_b2, cs_w, cs_b, gates,
                             nt, in_w, in_b, out_w, out_b, out, plog1, plog2,
                             h1, h2, h3, N, D, H, size, alpha, k, beta, st);
  return launch_mlp<__nv_bfloat16>(x, ln_w1, ln_b1, ln_w2, ln_b2, cs_w, cs_b,
                                   gates, nt, in_w, in_b, out_w, out_b, out,
                                   plog1, plog2, h1, h2, h3, N, D, H, size,
                                   alpha, k, beta, st);
}
