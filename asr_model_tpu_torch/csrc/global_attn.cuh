// Masked softmax attention over device memory, for head widths past the
// shared-memory kernels' (flash_attention.cu past FA_WIDE_HD, the whole
// calls' wide route in xattn.cu past XW_MAX_HD).
//
// The function is flash's: softmax(scale q k^T, masked logits -1e30,
// the causal mask aligned bottom-right, kv_valid a (B, Tk) byte mask) v,
// so a row whose keys are all masked takes the uniform mean of V.
//
// What bounds it: at these widths (hd > 1024) a head's row no longer
// fits beside a key tile in a block's shared memory, and the operations
// (4 Tq Tk hd a head) over few rows stay far below the card's rate; the
// score matrix (B H Tq Tk f32) is the extra traffic.  Design: three
// launches through that matrix in device memory (L2 while it fits):
//   1 gl_scores   S = scale q k^T, masked: a (16-query, 16-key) tile a
//                 block, a thread a dot product, q and k staged 64 head
//                 columns at a time
//   2 gl_softmax  each row of S in place, a block a row: max, exp, sum,
//                 divide (in f32, as the plain version)
//   3 gl_pv       o = P v: a (16-query, 64-column) tile a block over
//                 16-key tiles, P rounded to the storage type for the
//                 product (as the Pallas kernel rounds it), f32 sums
// Operands are strided: element (b, h, i, c) of an operand lives at
// base + b * s.b + h * s.h + i * s.r + c, so flash's (B, H, T, hd) and
// the whole calls' (B, T, H, hd) rows take the same kernels.
#pragma once

#include "common.cuh"

struct GlStrides {
  long b, h, r;
};

constexpr int GL_T = 16;          // queries (and keys) a tile
constexpr int GL_KC = 64;         // head columns a chunk
constexpr float GL_MASKED = -1e30f;

template <typename T>
__global__ void __launch_bounds__(256)
gl_scores(const T* __restrict__ q, GlStrides qs, const T* __restrict__ k,
          GlStrides ks, const uint8_t* __restrict__ valid,
          float* __restrict__ S, int H, int Tq, int Tk, int hd, float scale,
          int causal) {
  __shared__ float qt[GL_T][GL_KC + 1], kt[GL_T][GL_KC + 1];
  const int t = threadIdx.x, ty = t / GL_T, tx = t % GL_T;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * GL_T, j0 = blockIdx.x * GL_T;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  float s = 0.0f;
  for (int c0 = 0; c0 < hd; c0 += GL_KC) {
    for (int e = t; e < GL_T * GL_KC; e += 256) {
      const int r = e / GL_KC, cc = e % GL_KC, c = c0 + cc;
      qt[r][cc] = i0 + r < Tq && c < hd ? to_f32(qb[(i0 + r) * qs.r + c])
                                        : 0.0f;
      kt[r][cc] = j0 + r < Tk && c < hd ? to_f32(kb[(j0 + r) * ks.r + c])
                                        : 0.0f;
    }
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < GL_KC; ++c) s = fmaf(qt[ty][c], kt[tx][c], s);
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i >= Tq || j >= Tk) return;
  bool masked = causal && j > i + Tk - Tq;
  if (valid && !valid[(size_t)b * Tk + j]) masked = true;
  S[((size_t)bh * Tq + i) * Tk + j] = masked ? GL_MASKED : s * scale;
}

// the block's sum (SUM) or max of v; red: 8 floats of shared memory;
// synchronises
template <bool SUM>
__device__ __forceinline__ float gl_block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = SUM ? warp_sum(v) : warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w)
    r = SUM ? r + red[w] : fmaxf(r, red[w]);
  return r;
}

// (a template, so the two sources that include this header each hold
// their own instantiation)
template <int BLOCK = 256>
__global__ void __launch_bounds__(BLOCK)
gl_softmax(float* __restrict__ S, int Tk) {
  __shared__ float red[BLOCK / 32];
  float* row = S + (size_t)blockIdx.x * Tk;
  const int t = threadIdx.x;
  float m = -INFINITY;
  for (int j = t; j < Tk; j += BLOCK) m = fmaxf(m, row[j]);
  m = gl_block_reduce<false>(m, red);
  float z = 0.0f;
  for (int j = t; j < Tk; j += BLOCK) {
    const float e = expf(row[j] - m);
    row[j] = e;
    z += e;
  }
  z = gl_block_reduce<true>(z, red);
  for (int j = t; j < Tk; j += BLOCK) row[j] = row[j] / z;
}

template <typename T>
__global__ void __launch_bounds__(256)
gl_pv(const float* __restrict__ P, const T* __restrict__ v, GlStrides vs,
      T* __restrict__ o, GlStrides os, int H, int Tq, int Tk, int hd) {
  __shared__ float pt[GL_T][GL_T + 1], vt[GL_T][GL_KC];
  const int t = threadIdx.x, col = t % GL_KC, rg = t / GL_KC;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * GL_T, c0 = blockIdx.x * GL_KC;
  const float* pb = P + (size_t)bh * Tq * Tk;
  const T* vb = v + b * vs.b + h * vs.h;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = 0; j0 < Tk; j0 += GL_T) {
    {
      const int r = t / GL_T, j = t % GL_T;
      const float p = i0 + r < Tq && j0 + j < Tk
                          ? pb[(size_t)(i0 + r) * Tk + j0 + j]
                          : 0.0f;
      pt[r][j] = to_f32(from_f32<T>(p));
    }
    for (int e = t; e < GL_T * GL_KC; e += 256) {
      const int j = e / GL_KC, c = c0 + e % GL_KC;
      vt[j][e % GL_KC] = j0 + j < Tk && c < hd
                             ? to_f32(vb[(j0 + j) * vs.r + c])
                             : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < GL_T; ++j) {
      const float vv = vt[j][col];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = fmaf(pt[4 * rg + u][j], vv, acc[u]);
    }
    __syncthreads();
  }
  const int c = c0 + col;
  if (c >= hd) return;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + 4 * rg + u;
    if (i < Tq) o[b * os.b + h * os.h + i * os.r + c] = from_f32<T>(acc[u]);
  }
}

// The three launches; S: B H Tq Tk f32 of device memory.  B H <= 65535,
// ceil(Tq / 16) <= 65535.
template <typename T>
static cudaError_t gl_attention(const void* q, GlStrides qs, const void* k,
                                GlStrides ks, const void* v, GlStrides vs,
                                const void* valid, void* o, GlStrides os,
                                float* S, int B, int H, int Tq, int Tk,
                                int hd, float scale, int causal,
                                cudaStream_t st) {
  const int qt = (Tq + GL_T - 1) / GL_T;
  gl_scores<T><<<dim3((Tk + GL_T - 1) / GL_T, qt, B * H), 256, 0, st>>>(
      (const T*)q, qs, (const T*)k, ks, (const uint8_t*)valid, S, H, Tq, Tk,
      hd, scale, causal);
  gl_softmax<256><<<(unsigned)((size_t)B * H * Tq), 256, 0, st>>>(S, Tk);
  gl_pv<T><<<dim3((hd + GL_KC - 1) / GL_KC, qt, B * H), 256, 0, st>>>(
      S, (const T*)v, vs, (T*)o, os, H, Tq, Tk, hd);
  return cudaGetLastError();
}
