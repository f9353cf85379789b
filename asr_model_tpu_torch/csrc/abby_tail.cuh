// The eval AbbyNormal as device helpers, shared by the kernels that
// normalise rows held in shared memory: abby.cu, and the whole-call
// attention (xattn.cu) and residual-MLP (mlp.cu) kernels.
#pragma once

#include "common.cuh"

constexpr int ABBY_MAX_D = 2048;  // widest row the in-block helpers take

// The normalising tail on one row of a tile, shared with later fused
// kernels: `xr` is the row in shared memory (f32), `j` the channel.
__device__ __forceinline__ float abby_tail_at(const float* xr, int j, int D,
                                              int size, int choice,
                                              float alpha, float k,
                                              float beta) {
  const int pad = size / 2;
  float s = 0.0f, mx = -INFINITY;
  for (int o = -pad; o <= pad; ++o) {
    const int jj = j + o;
    if (jj >= 0 && jj < D) {
      const float v = xr[jj] * xr[jj];
      s += v;
      mx = fmaxf(mx, v);
    }
  }
  const float avg = s / (float)size;
  const float div2 = mx > 2.0f * avg ? mx : avg;
  const float mix = choice == 1 ? div2 : avg;
  return xr[j] / expf(beta * logf(mix * alpha + k));
}

// Row statistics of the tail: the routing choice argmax(logits + cv).
__device__ __forceinline__ int abby_choice(const float* xr, int D,
                                           const float* logits, int lane) {
  float sa = 0.0f, s = 0.0f;
  for (int j = lane; j < D; j += 32) {
    sa += fabsf(xr[j]);
    s += xr[j];
  }
  sa = warp_sum(sa);
  s = warp_sum(s);
  const float mu = s / (float)D;
  float q = 0.0f;
  for (int j = lane; j < D; j += 32) {
    const float c = xr[j] - mu;
    q += c * c;
  }
  q = warp_sum(q);
  const float cv = sqrtf(q / (float)(D - 1)) / (sa / (float)D + 1e-6f);
  int best = 0;
  float bv = logits[0] + cv;
  for (int c = 1; c < 3; ++c) {
    const float v = logits[c] + cv;
    if (v > bv) {
      bv = v;
      best = c;
    }
  }
  return best;
}

// Router logits of row r: the slices' partial logits summed in a fixed
// order (deterministic), plus the bias b2 (none when b2 is null).
template <typename T>
__device__ __forceinline__ void abby_logits(const float* plog, int N,
                                            int slices, int r, const T* b2,
                                            float lg[3]) {
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
    for (int sl = 0; sl < slices; ++sl)
      s += plog[((size_t)sl * N + r) * 3 + c];
    lg[c] = s + (b2 ? to_f32(b2[c]) : 0.0f);
  }
}

// The tail of one row in shared memory, written back in place by the
// warp that owns the row (D <= ABBY_MAX_D); ROUND rounds each value to
// the storage type, as the reference does before a product.
template <typename T, bool ROUND>
__device__ __forceinline__ void abby_row_tail_inplace(float* xr, int D,
                                                      const float lg[3],
                                                      int size, float alpha,
                                                      float k, float beta,
                                                      int lane) {
  const int choice = abby_choice(xr, D, lg, lane);
  float v[ABBY_MAX_D / 32];
#pragma unroll
  for (int i = 0; i < ABBY_MAX_D / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < D) {
      const float y = abby_tail_at(xr, j, D, size, choice, alpha, k, beta);
      v[i] = ROUND ? to_f32(from_f32<T>(y)) : y;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ABBY_MAX_D / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < D) xr[j] = v[i];
  }
  __syncwarp();
}

// Shared floats abby_router_tile needs.
__host__ __device__ constexpr int abby_router_smem_floats(int D) {
  return GEMM_ROWS * D + GEMM_WT_FLOATS + GEMM_ROWS * GEMM_NT;
}

// The router half of the eval AbbyNormal for one (16-row tile, 64-column
// slice) of x (N, D): h = silu(x W1^T + b1) for columns 64 * slice ..
// + 63, rounded to the storage type as the reference rounds it before
// the second product, and the slice's partial logits h W2^T, written to
// plog[slice][row][0..2].  W1 (D, D) and W2 (3, D) are in torch (out, in)
// layout.  All 256 threads of the block call it.
template <typename T>
__device__ void abby_router_tile(const T* __restrict__ x,
                                 const T* __restrict__ w1,
                                 const T* __restrict__ b1,
                                 const T* __restrict__ w2,
                                 float* __restrict__ plog, int N, int D,
                                 int r0, int slice, float* smem) {
  float* xs = smem;                          // [16][D]
  float* wt = xs + GEMM_ROWS * D;            // gemm weight tile
  float* hs = wt + GEMM_WT_FLOATS;           // [16][64] h slice
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int n0 = slice * GEMM_NT;

  for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
    const int r = e / D, j = e % D;
    xs[e] = (r0 + r < N) ? to_f32(x[(size_t)(r0 + r) * D + j]) : 0.0f;
  }
  __syncthreads();

  float acc[4];
  gemm_rows16<T, false>(xs, D, D, w1, D, n0, D, wt, acc);
  const int c = t % GEMM_NT, n = n0 + c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = n < D ? siluf_(acc[i] + to_f32(b1[n])) : 0.0f;
    hs[(4 * (t / GEMM_NT) + i) * GEMM_NT + c] = to_f32(from_f32<T>(h));
  }
  __syncthreads();

  // partial logits of the slice: 16 rows x 3, one warp per dot product
  for (int o = warp; o < GEMM_ROWS * 3; o += blockDim.x / 32) {
    const int r = o / 3, kk = o % 3;
    float s = 0.0f;
    for (int j = lane; j < GEMM_NT; j += 32)
      if (n0 + j < D) s += hs[r * GEMM_NT + j] * to_f32(w2[(size_t)kk * D + n0 + j]);
    s = warp_sum(s);
    if (lane == 0 && r0 + r < N)
      plog[((size_t)slice * N + r0 + r) * 3 + kk] = s;
  }
}

// The whole eval AbbyNormal of the 16 rows of a tile held in shared
// memory (xs, f32 values of the storage type, row stride ld, D <= 1024
// channels), router product included, written back in place and rounded
// to the storage type.  hs: [16][D] scratch for the hidden; lgs: [16][3];
// wt: a gemm weight tile.  Rows at or past `rows` are left as they are.
// All 256 threads of the block call it.
template <typename T>
__device__ void abby_tile_inblock(float* xs, int ld, int D,
                                  const T* __restrict__ w1,
                                  const T* __restrict__ b1,
                                  const T* __restrict__ w2,
                                  const T* __restrict__ b2, float* hs,
                                  float* lgs, float* wt, int rows, int size,
                                  float alpha, float k, float beta) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (int n0 = 0; n0 < D; n0 += GEMM_NT) {
    float acc[4];
    gemm_rows16<T, false>(xs, ld, D, w1, D, n0, D, wt, acc);
    const int c = t % GEMM_NT, n = n0 + c;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n < D)
        hs[(4 * (t / GEMM_NT) + i) * D + n] =
            to_f32(from_f32<T>(siluf_(acc[i] + to_f32(b1[n]))));
  }
  __syncthreads();
  for (int o = warp; o < GEMM_ROWS * 3; o += blockDim.x / 32) {
    const int r = o / 3, kk = o % 3;
    float s = 0.0f;
    for (int j = lane; j < D; j += 32)
      s += hs[r * D + j] * to_f32(w2[(size_t)kk * D + j]);
    s = warp_sum(s);
    if (lane == 0) lgs[r * 3 + kk] = s + to_f32(b2[kk]);
  }
  __syncthreads();
  for (int r = warp; r < rows; r += blockDim.x / 32)
    abby_row_tail_inplace<T, true>(xs + r * ld, D, lgs + r * 3, size, alpha,
                                   k, beta, lane);
  __syncthreads();
}
