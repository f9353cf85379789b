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
// gates, W_in, W_out) against ~5.8 MB of bf16 weights at D = 512: at
// decode widths (N = 8 x 9 .. 8 x 65 rows) the weights set the bytes, and
// a CTA's time is the bytes it streams into its SM.  Each product needs
// whole rows of its input, so a call is the chain of launches those
// dependencies force, each spreading the weights over many CTAs:
//   1 h0 = ln(x)            a cluster per 32-row tile (abby_cluster.cuh):
//                           router slices on the CTAs, the tail once a row
//   2 types and the gates   (32-row tile, 40 columns of each of 3 gates
//                           and the 3 rows of cs in one product) -> h1
//   3 W_in + gelu           (32-row tile, 64-column slice) -> h2
//   4 W_out                 (32-row tile, 64-column slice) -> h3
//   5 out = x + ln(h3)      as 1, the residual added in the tail
// Five launches a call.  bf16 rows of 16-byte multiples take the tensor
// cores (mma.sync.m16n8k16, f32 sums: the reference's own contraction)
// through a cp.async ring (tc_gemm); f32, and bf16 rows of other widths,
// take the same launches with CUDA-core products (gemm_rows16, full f32:
// TF32 would not hold the f32 route's 1e-4).  h0 .. h3 (N x 6D values)
// stay in the L2.
// Past the kernels' shared-memory plans, two more routes (either dtype):
//   more than MLP_MAX_NT gates: the types in a launch of their own (a
//   block a row, logits and softmax in device memory), then the gates on
//   the CUDA cores with the gates' pointers and the types read from
//   device memory (mlp_gates_many): six launches;
//   a D whose norms' staged slices do not fit a block (past 59,392 in
//   bf16): each norm as asr_abby_global's three launches (abby.cu), the
//   second adding the residual.
#include "abby_cluster.cuh"

ASR_API int asr_abby_global(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* res, void* out, void* hbuf,
                            void* choice, int N, int D, int size,
                            float alpha, float k, float beta, void* stream);

// TGate types: 8 columns of each gate a tensor-core CTA at 12
// (mlp_gate_cols)
constexpr int MLP_MAX_NT = 12;
constexpr int MLP_ROWS = 32;               // tensor-core tile: 32 x 64
constexpr int MLP_COLS = 64;
constexpr int MLP_ST = 3;                  // k chunks in flight

struct MlpGates {
  const void* w[MLP_MAX_NT];               // (D, D) torch layout
  const void* b[MLP_MAX_NT];               // (D,)
};

// launches 1 and 5: out = [res +] ln(x) over the cluster's 32-row tile
// (WIDE past AB_STREAM_D, abby_cluster.cuh)
template <typename T, bool WIDE>
__global__ void __launch_bounds__(AB_THREADS)
mlp_norm(const T* __restrict__ x, const T* __restrict__ w1,
         const T* __restrict__ b1, const T* __restrict__ w2,
         const T* __restrict__ b2, const T* __restrict__ res,
         T* __restrict__ out, int N, int D, int size, float alpha, float k,
         float beta, int vec) {
  extern __shared__ __align__(128) unsigned char ab_smem[];
  abby_cluster_tile<T, WIDE>(x, w1, b1, w2, b2, res, out, N, D, size, alpha,
                             k, beta, vec, blockIdx.y * AB_ROWS, ab_smem);
}

// the softmax of each of `rows` rows of type logits tys [rows][MLP_MAX_NT]
// in place; synchronises
__device__ void mlp_softmax_types(float* tys, int rows, int nt) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t < rows) {
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
}

// types = softmax(h0 cs^T + cs_b) of `rows` rows held in shared memory
// (f32, row stride ld) into tys [rows][MLP_MAX_NT]; synchronises
template <typename T>
__device__ void mlp_types(const float* hs, int ld, int rows, int D, int nt,
                          const T* __restrict__ cs_w,
                          const T* __restrict__ cs_b, float* tys) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int o = warp; o < rows * nt; o += blockDim.x / 32) {
    const int r = o / nt, c = o % nt;
    float s = 0.0f;
    for (int j = lane; j < D; j += 32)
      s += hs[r * ld + j] * to_f32(cs_w[(size_t)c * D + j]);
    s = warp_sum(s);
    if (lane == 0) tys[r * MLP_MAX_NT + c] = s + to_f32(cs_b[c]);
  }
  mlp_softmax_types(tys, rows, nt);
}

// the columns of each gate a CTA takes: nt slices of that width and the
// nt rows of cs fill one 128-column tile (nt 3: 40 columns a gate)
__host__ __device__ constexpr int mlp_gate_cols(int nt) {
  return (128 - nt) / nt / 8 * 8;
}

// the ring, the gates' values [32][128] and the types [32][MLP_MAX_NT]
__host__ __device__ constexpr size_t mlp_gates_tc_smem() {
  return sizeof(bf16) * tc_ring_elems(2, 4, false, false, MLP_ST) +
         sizeof(float) * MLP_ROWS * (128 + MLP_MAX_NT);
}

// launch 2, tensor cores: one product over the 32-row tile of h0 and 128
// rows gathered from the gates (this CTA's mlp_gate_cols(nt) columns of
// each) and cs, so that the type logits come with the gates; then types
// = softmax(logits + cs_b) and h1 = sum_i sigmoid(gate_i) types_i, in
// gate order
__global__ void __launch_bounds__(256)
mlp_gates_tc(const bf16* __restrict__ h0, const bf16* __restrict__ cs_w,
             const bf16* __restrict__ cs_b, MlpGates gates,
             bf16* __restrict__ h1, int N, int D, int nt) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* ring = reinterpret_cast<bf16*>(sm);
  float* gv = reinterpret_cast<float*>(
      ring + tc_ring_elems(2, 4, false, false, MLP_ST));
  float* tys = gv + MLP_ROWS * 128;
  const int t = threadIdx.x, sw = mlp_gate_cols(nt), ng = nt * sw;
  const int r0 = blockIdx.x * MLP_ROWS, n0 = blockIdx.y * sw;
  float acc[4][4];
  tc_gemm_rows<2, 4, false, MLP_ST>(
      h0 + (size_t)r0 * D, D, min(MLP_ROWS, N - r0),
      [&](int n) -> const bf16* {
        if (n < ng) {
          const int col = n0 + n % sw;
          return col < D ? (const bf16*)gates.w[n / sw] + (size_t)col * D
                         : nullptr;
        }
        return n - ng < nt ? cs_w + (size_t)(n - ng) * D : nullptr;
      },
      cs_w, D, ring, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tc_row<2>(e), c = tc_col<2, 4>(j, e);
      if (c < ng) {
        const int col = n0 + c % sw;
        const float b =
            col < D ? to_f32(((const bf16*)gates.b[c / sw])[col]) : 0.0f;
        gv[r * 128 + c] = sigmoidf_(acc[j][e] + b);
      } else if (c - ng < nt) {
        tys[r * MLP_MAX_NT + c - ng] = acc[j][e] + to_f32(cs_b[c - ng]);
      }
    }
  mlp_softmax_types(tys, MLP_ROWS, nt);
  for (int e = t; e < MLP_ROWS * sw; e += 256) {
    const int r = e / sw, cc = e % sw, col = n0 + cc;
    if (r0 + r >= N || col >= D) continue;
    float h = 0.0f;
    for (int g = 0; g < nt; ++g)
      h += gv[r * 128 + g * sw + cc] * tys[r * MLP_MAX_NT + g];
    h1[(size_t)(r0 + r) * D + col] = from_f32<bf16>(h);
  }
}

// launches 3 and 4, tensor cores: out = epi(a W^T + bias) for one
// (32-row tile, 64-column slice), a and W streamed together
template <int EPI>
__global__ void __launch_bounds__(256)
mlp_linear_tc(const bf16* __restrict__ a, const bf16* __restrict__ w,
              const bf16* __restrict__ bias, bf16* __restrict__ out, int N,
              int K, int Nout) {
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* ring = reinterpret_cast<bf16*>(sm);
  const int r0 = blockIdx.x * MLP_ROWS, n0 = blockIdx.y * MLP_COLS;
  float acc[2][4];
  tc_gemm<2, 2, false, false, MLP_ST>(a + (size_t)r0 * K, K, min(MLP_ROWS, N - r0),
                              w + (size_t)n0 * K, K,
                              min(MLP_COLS, Nout - n0), K, ring, acc);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + tc_row<2>(e), n = n0 + tc_col<2, 2>(j, e);
      if (r >= N || n >= Nout) continue;
      float v = acc[j][e] + to_f32(bias[n]);
      if (EPI == LIN_GELU) v = gelu_erf(v);
      out[(size_t)r * Nout + n] = from_f32<bf16>(v);
    }
}

// h0 columns a CUDA-core gates CTA holds: all of them up to this width,
// else chunks of it (the types then from device memory)
constexpr int MLP_GKCH = 2048;

// launch 2 on the CUDA cores, past MLP_GKCH: the types a warp a (row,
// type) from device memory, the gates' products MLP_GKCH columns of h0
// at a time
template <typename T>
__device__ void mlp_gates_wide(const T* __restrict__ h0,
                               const T* __restrict__ cs_w,
                               const T* __restrict__ cs_b, MlpGates gates,
                               T* __restrict__ h1, int N, int D, int nt,
                               float* xs, float* wt, float* tys) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  for (int o = warp; o < GEMM_ROWS * nt; o += blockDim.x / 32) {
    const int r = o / nt, c = o % nt;
    float s = 0.0f;
    if (r0 + r < N)
      for (int j = lane; j < D; j += 32)
        s += to_f32(h0[(size_t)(r0 + r) * D + j]) *
             to_f32(cs_w[(size_t)c * D + j]);
    s = warp_sum(s);
    if (lane == 0) tys[r * MLP_MAX_NT + c] = s + to_f32(cs_b[c]);
  }
  mlp_softmax_types(tys, GEMM_ROWS, nt);
  const int n = n0 + t % GEMM_NT;
  float hsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < nt; ++i) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < D; k0 += MLP_GKCH) {
      const int kc = min(MLP_GKCH, D - k0);
      for (int e = t; e < GEMM_ROWS * kc; e += blockDim.x) {
        const int r = e / kc, j = e % kc;
        xs[e] = (r0 + r < N) ? to_f32(h0[(size_t)(r0 + r) * D + k0 + j])
                             : 0.0f;
      }
      __syncthreads();
      float part[4];
      gemm_rows16<T, false>(xs, kc, kc, (const T*)gates.w[i] + k0, D, n0, D,
                            wt, part);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[ii] += part[ii];
    }
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

// launch 2 on the CUDA cores: one (16-row tile, 64-column slice)
template <typename T>
__global__ void __launch_bounds__(256)
mlp_gates(const T* __restrict__ h0, const T* __restrict__ cs_w,
          const T* __restrict__ cs_b, MlpGates gates, T* __restrict__ h1,
          int N, int D, int nt) {
  extern __shared__ float smem[];
  const int kch = min(D, MLP_GKCH);
  float* xs = smem;                          // [16][kch]: h0
  float* wt = xs + GEMM_ROWS * kch;
  float* tys = wt + GEMM_WT_FLOATS;          // [16][MLP_MAX_NT]
  if (D > MLP_GKCH) {
    mlp_gates_wide<T>(h0, cs_w, cs_b, gates, h1, N, D, nt, xs, wt, tys);
    return;
  }
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
    const int r = e / D, j = e % D;
    xs[e] = (r0 + r < N) ? to_f32(h0[(size_t)(r0 + r) * D + j]) : 0.0f;
  }
  __syncthreads();
  mlp_types(xs, D, GEMM_ROWS, D, nt, cs_w, cs_b, tys);
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

// past MLP_MAX_NT gates: types = softmax(h0 cs^T + cs_b) of one row a
// block, in device memory (tys: N x nt f32), a warp a type's logit
template <typename T>
__global__ void __launch_bounds__(256)
mlp_types_many(const T* __restrict__ h0, const T* __restrict__ cs_w,
               const T* __restrict__ cs_b, float* __restrict__ tys, int D,
               int nt) {
  __shared__ float red[8];
  const int r = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const T* hr = h0 + (size_t)r * D;
  float* ty = tys + (size_t)r * nt;
  for (int c = warp; c < nt; c += 8) {
    float s = 0.0f;
    for (int j = lane; j < D; j += 32)
      s += to_f32(hr[j]) * to_f32(cs_w[(size_t)c * D + j]);
    s = warp_sum(s);
    if (lane == 0) ty[c] = s + to_f32(cs_b[c]);
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int c = t; c < nt; c += 256) mx = fmaxf(mx, ty[c]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < 8; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  float z = 0.0f;
  for (int c = t; c < nt; c += 256) {
    const float e = expf(ty[c] - mx);
    ty[c] = e;
    z += e;
  }
  z = warp_sum(z);
  if (lane == 0) red[warp] = z;
  __syncthreads();
  z = 0.0f;
  for (int w = 0; w < 8; ++w) z += red[w];
  for (int c = t; c < nt; c += 256) ty[c] = ty[c] / z;
}

// past MLP_MAX_NT gates, one (16-row tile, 64-column slice) on the CUDA
// cores: h1 = sum_i sigmoid(h0 G_i^T + g_i) * types_i with the gates'
// pointers in device memory (gw[i], gw[nt + i]) and the types from
// mlp_types_many, h0 MLP_GKCH columns at a time
template <typename T>
__global__ void __launch_bounds__(256)
mlp_gates_many(const T* __restrict__ h0, const void* const* __restrict__ gw,
               const float* __restrict__ tys, T* __restrict__ h1, int N,
               int D, int nt) {
  extern __shared__ float smem[];
  const int kch = min(D, MLP_GKCH);
  float* xs = smem;                          // [16][kch]: h0
  float* wt = xs + GEMM_ROWS * kch;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * GEMM_ROWS, n0 = blockIdx.y * GEMM_NT;
  const int n = n0 + t % GEMM_NT;
  auto stage = [&](int k0, int kc) {
    for (int e = t; e < GEMM_ROWS * kc; e += blockDim.x) {
      const int r = e / kc, j = e % kc;
      xs[e] = (r0 + r < N) ? to_f32(h0[(size_t)(r0 + r) * D + k0 + j])
                           : 0.0f;
    }
    __syncthreads();
  };
  if (D <= MLP_GKCH) stage(0, D);
  float hsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < nt; ++i) {
    const T* w = (const T*)gw[i];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < D; k0 += MLP_GKCH) {
      const int kc = min(MLP_GKCH, D - k0);
      if (D > MLP_GKCH) stage(k0, kc);
      float part[4];
      gemm_rows16<T, false>(xs, kc, kc, w + k0, D, n0, D, wt, part);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[ii] += part[ii];
    }
    const float gb = n < D ? to_f32(((const T*)gw[nt + i])[n]) : 0.0f;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = r0 + 4 * (t / GEMM_NT) + ii;
      const float ty = r < N ? tys[(size_t)r * nt + i] : 0.0f;
      hsum[ii] += sigmoidf_(acc[ii] + gb) * ty;
    }
  }
  if (n >= D) return;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = r0 + 4 * (t / GEMM_NT) + ii;
    if (r < N) h1[(size_t)r * D + n] = from_f32<T>(hsum[ii]);
  }
}

// the norms' launches: the cluster kernel where its plan fits a block,
// else asr_abby_global (hbuf (N, D) of the dtype, choice N ints)
template <typename T>
static int mlp_norm_launch(int dtype, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* res, void* out, void* hbuf,
                           void* choice, int N, int D, int size, float alpha,
                           float k, float beta, int vec, cudaStream_t st) {
  if (abby_smem_bytes(dtype, D) > 232448)
    return asr_abby_global(dtype, x, w1, b1, w2, b2, res, out, hbuf, choice,
                           N, D, size, alpha, k, beta, st);
  const int S = abby_cluster_size(D);
  void (*norm)(const T*, const T*, const T*, const T*, const T*, const T*,
               T*, int, int, int, float, float, float, int) =
      abby_wide(D) ? mlp_norm<T, true> : mlp_norm<T, false>;
  return (int)launch_clusters(
      norm, dim3(S, (N + AB_ROWS - 1) / AB_ROWS, 1), S,
      abby_smem_bytes(dtype, D), st, (const T*)x, (const T*)w1,
      (const T*)b1, (const T*)w2, (const T*)b2, (const T*)res, (T*)out, N,
      D, size, alpha, k, beta, vec);
}

template <typename T>
static int launch_mlp(int dtype, const void* x, const void* ln_w1,
                      const void* ln_b1, const void* ln_w2,
                      const void* ln_b2, const void* cs_w, const void* cs_b,
                      const MlpGates& gates, int nt, const void* in_w,
                      const void* in_b, const void* out_w, const void* out_b,
                      void* out, void* h0, void* h1, void* h2, void* h3,
                      const void* const* dev_gates, float* tys, void* choice,
                      bool tc, int N, int D, int H, int size, float alpha,
                      float k, float beta, cudaStream_t st) {
  const int vx = D % 8 == 0 && ((uintptr_t)x | (uintptr_t)ln_w1) % 16 == 0;
  const int vh = D % 8 == 0 && ((uintptr_t)h3 | (uintptr_t)ln_w1) % 16 == 0;
  // h1 is free until the gates write it: the global norm's hidden
  int rc = mlp_norm_launch<T>(dtype, x, ln_w1, ln_b1, ln_w2, ln_b2, nullptr,
                              h0, h1, choice, N, D, size, alpha, k, beta, vx,
                              st);
  if (rc) return rc;

  if (nt > MLP_MAX_NT) {
    mlp_types_many<T><<<N, 256, 0, st>>>((const T*)h0, (const T*)cs_w,
                                         (const T*)cs_b, tys, D, nt);
    const size_t smem_g =
        sizeof(float) * (GEMM_ROWS * (D < MLP_GKCH ? D : MLP_GKCH) +
                         GEMM_WT_FLOATS);
    cudaFuncSetAttribute(mlp_gates_many<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_g);
    mlp_gates_many<T><<<dim3((N + GEMM_ROWS - 1) / GEMM_ROWS,
                             (D + GEMM_NT - 1) / GEMM_NT), 256, smem_g, st>>>(
        (const T*)h0, dev_gates, tys, (T*)h1, N, D, nt);
  } else if (tc) {
    const int rt = (N + MLP_ROWS - 1) / MLP_ROWS;
    const size_t smem_g = mlp_gates_tc_smem();
    const int sw = mlp_gate_cols(nt);
    cudaFuncSetAttribute(mlp_gates_tc,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_g);
    mlp_gates_tc<<<dim3(rt, (D + sw - 1) / sw), 256, smem_g, st>>>((const bf16*)h0, (const bf16*)cs_w,
                         (const bf16*)cs_b, gates, (bf16*)h1, N, D, nt);
  } else {
    const size_t smem_g =
        sizeof(float) * (GEMM_ROWS * (D < MLP_GKCH ? D : MLP_GKCH) +
                         GEMM_WT_FLOATS + GEMM_ROWS * MLP_MAX_NT);
    cudaFuncSetAttribute(mlp_gates<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_g);
    mlp_gates<T><<<dim3((N + GEMM_ROWS - 1) / GEMM_ROWS,
                        (D + GEMM_NT - 1) / GEMM_NT), 256, smem_g, st>>>(
        (const T*)h0, (const T*)cs_w, (const T*)cs_b, gates, (T*)h1, N, D,
        nt);
  }
  if (tc) {
    const int rt = (N + MLP_ROWS - 1) / MLP_ROWS;
    const size_t smem_l =
        sizeof(bf16) * tc_ring_elems(2, 2, false, false, MLP_ST);
    cudaFuncSetAttribute(mlp_linear_tc<LIN_GELU>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_l);
    cudaFuncSetAttribute(mlp_linear_tc<LIN_NONE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_l);
    mlp_linear_tc<LIN_GELU>
        <<<dim3(rt, (H + MLP_COLS - 1) / MLP_COLS), 256, smem_l, st>>>(
            (const bf16*)h1, (const bf16*)in_w, (const bf16*)in_b,
            (bf16*)h2, N, D, H);
    mlp_linear_tc<LIN_NONE>
        <<<dim3(rt, (D + MLP_COLS - 1) / MLP_COLS), 256, smem_l, st>>>(
            (const bf16*)h2, (const bf16*)out_w, (const bf16*)out_b,
            (bf16*)h3, N, H, D);
  } else {
    launch_linear_rows<T, LIN_GELU>(h1, in_w, in_b, h2, N, D, H, st);
    launch_linear_rows<T, LIN_NONE>(h2, out_w, out_b, h3, N, H, D, st);
  }

  // h1 is free again after W_in
  rc = mlp_norm_launch<T>(dtype, h3, ln_w1, ln_b1, ln_w2, ln_b2, x, out, h1,
                          choice, N, D, size, alpha, k, beta, vh, st);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// whether a bf16 call takes the tensor cores: rows of 16-byte multiples
// and 16-byte aligned operands for the cp.async ring
static bool mlp_tc_ok(const void* const* ptrs, int n, int D, int H) {
  uintptr_t a = 0;
  for (int i = 0; i < n; ++i) a |= (uintptr_t)ptrs[i];
  return D % 8 == 0 && H % 8 == 0 && a % 16 == 0;
}

// x, out: (N, D); ln_w1 (D, D), ln_b1 (D,), ln_w2 (3, D), ln_b2 (3,): the
// shared AbbyNormal; cs_w (nt, D), cs_b (nt,); gate_w[i] (D, D),
// gate_b[i] (D,) for i < nt; in_w (H, D), in_b (H,); out_w (D, H),
// out_b (D,) -- torch (out, in) layouts, all of one dtype (0 = f32,
// 1 = bf16).  Workspace from the caller: h0, h1, h3 (N, D) and h2 (N, H)
// of the dtype.  Past MLP_MAX_NT gates also dev_gates (device memory: the
// nt gate_w pointers, then the nt gate_b pointers; gate_w / gate_b are
// not read) and tys (N x nt f32); where the norms' plan does not fit a
// block (abby_smem_bytes), choice (N ints).  D >= 2, any nt >= 1, any
// window size, N <= 65535 * 32.  Five launches up to MLP_MAX_NT gates,
// six past them; each norm past the plan three launches, not one.
ASR_API int asr_fused_mlp_residual(
    int dtype, const void* x, const void* ln_w1, const void* ln_b1,
    const void* ln_w2, const void* ln_b2, const void* cs_w, const void* cs_b,
    const void* const* gate_w, const void* const* gate_b, int nt,
    const void* in_w, const void* in_b, const void* out_w, const void* out_b,
    void* out, void* h0, void* h1, void* h2, void* h3,
    const void* const* dev_gates, void* tys, void* choice, int N, int D,
    int H, int size, float alpha, float k, float beta, void* stream) {
  const bool many = nt > MLP_MAX_NT;
  const bool global = abby_smem_bytes(dtype, D) > 232448;
  if (D < 2 || H < 1 || nt < 1 || size < 1 || N > 65535 * AB_ROWS ||
      (many && (!dev_gates || !tys)) || (global && !choice))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  MlpGates gates = {};
  const void* ptrs[4 + 2 * MLP_MAX_NT] = {in_w, out_w, h0, h1};
  const int ng = many ? 0 : nt;      // the gates the tensor cores read
  for (int i = 0; i < ng; ++i) {
    gates.w[i] = gate_w[i];
    gates.b[i] = gate_b[i];
    ptrs[4 + i] = gate_w[i];
  }
  ptrs[4 + ng] = h2;
  ptrs[5 + ng] = h3;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_mlp<float>(dtype, x, ln_w1, ln_b1, ln_w2, ln_b2, cs_w,
                             cs_b, gates, nt, in_w, in_b, out_w, out_b, out,
                             h0, h1, h2, h3, dev_gates, (float*)tys, choice,
                             false, N, D, H, size, alpha, k, beta, st);
  return launch_mlp<bf16>(dtype, x, ln_w1, ln_b1, ln_w2, ln_b2, cs_w, cs_b,
                          gates, nt, in_w, in_b, out_w, out_b, out, h0, h1,
                          h2, h3, dev_gates, (float*)tys, choice,
                          mlp_tc_ok(ptrs, 6 + ng, D, H), N, D, H, size, alpha,
                          k, beta, st);
}

// the dynamic shared memory of the tensor-core gates launch, and the
// columns of each gate its CTAs take
ASR_API int asr_mlp_gates_tc_smem() { return (int)mlp_gates_tc_smem(); }
ASR_API int asr_mlp_gate_cols(int nt) { return mlp_gate_cols(nt); }
