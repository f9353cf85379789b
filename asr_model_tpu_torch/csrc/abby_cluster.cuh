// The eval AbbyNormal of a 32-row tile by a thread-block cluster, as
// device code shared by the kernels that norm whole rows on the tensor
// cores: fused_abby (abby.cu, whose header comment gives the design), the
// residual MLP's two norms (mlp.cu) and the full attention call's q and
// kv norms (xattn.cu).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "abby_tail.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

constexpr int AB_ROWS = 32;       // rows of a cluster's tile
constexpr int AB_THREADS = 256;
// the widest window the kernel takes: window_size(ABBY_MAX_D); windows of
// up to ABBY_REG_TAPS (window_size(1024)) run from registers
constexpr int ABBY_MAX_TAPS = 103;
constexpr int ABBY_REG_TAPS = 51;
// W1's 64-column chunks of a pass held at once: every chunk up to D 1024,
// past that a ring of this many
constexpr int AB_WRING = 8;
// f32 rows a CTA holds in shared memory at once past D 1024: half a tile
constexpr int AB_F32_WIDE_D = 1024;
// past this width the tile's rows are not held at all (the WIDE variant
// of abby_cluster_tile): bf16 streams x's chunks through the W1 ring
// beside W1's, f32 takes the product AB_KCH columns of x at a time, the
// partial logits are summed a 64-column pass at a time, and the cv and
// the tail read the rows from device memory (L2)
constexpr int AB_STREAM_D = 2048;
constexpr int AB_KCH = 512;       // f32 x columns a CTA holds, WIDE
constexpr int AB_SLD = 72;        // bf16 row stride of a ring slot

// columns of W1 a CTA owns, and the CTAs of a cluster (at most 8 up to
// D 4096: 64-column multiples of D / 8 past D 1024)
__host__ __device__ constexpr int abby_slice_cols(int D) {
  return D <= 512 ? 64 : D <= 1024 ? 128 : 64 * ((D + 511) / 512);
}
__host__ __device__ constexpr int abby_cluster_size(int D) {
  return (D + abby_slice_cols(D) - 1) / abby_slice_cols(D);
}
// bf16 shared rows: the channels padded to whole 64-column chunks, plus
// 16 bytes so that ldmatrix rows fall in different banks
__host__ __device__ constexpr int abby_chunks(int D) { return (D + 63) / 64; }
__host__ __device__ constexpr int abby_ld(int D) {
  return 64 * abby_chunks(D) + 8;
}
// W1's chunks of a pass in shared memory: all of them, [64][abby_ld] (up
// to 16 chunks, D 1024), else a ring of AB_WRING slots [64][72]
__host__ __device__ constexpr int abby_wbuf_elems(int D) {
  return abby_chunks(D) <= 16 ? 64 * abby_ld(D) : AB_WRING * 64 * 72;
}
// f32 x rows held at once: the tile, or half of it past AB_F32_WIDE_D
__host__ __device__ constexpr int abby_f32_rows(int D) {
  return D <= AB_F32_WIDE_D ? AB_ROWS : AB_ROWS / 2;
}

// dynamic shared memory of abby_cluster_kernel<T>: the x tile (bf16 rows
// or f32 rows) and W1's chunks of a pass (bf16) or gemm_rows16's weight
// tile (f32), then f32: the router's partial logits [4][32][3] (bf16) or
// h of the slice [32][cols] (f32), the slices of W2 [3][cols] and b1
// [cols], the partial logits its rows receive [32 + 8][3], their cv [32]
// and routes [32]
// (WIDE, past AB_STREAM_D: the ring of AB_WRING slots [96][72], x's 32
// rows and W1's 64 (bf16), or x's columns [16][AB_KCH], gemm_rows16's
// tile and h of a pass [16][64] (f32), then the partial logits [4][32][3]
// and the rest as above)
__host__ __device__ constexpr bool abby_wide(int D) { return D > AB_STREAM_D; }
__host__ __device__ constexpr size_t abby_smem_bytes(int dtype, int D) {
  return abby_wide(D)
             ? (dtype == ASR_BF16
                    ? sizeof(bf16) * AB_WRING * 96 * AB_SLD
                    : sizeof(float) * (GEMM_ROWS * AB_KCH + GEMM_WT_FLOATS +
                                       GEMM_ROWS * 64)) +
                   sizeof(float) * (4 * AB_ROWS * 3 + 4 * abby_slice_cols(D) +
                                    (AB_ROWS + 8) * 3 + 2 * AB_ROWS)
         : (dtype == ASR_BF16
              ? sizeof(bf16) * (AB_ROWS * abby_ld(D) + abby_wbuf_elems(D))
              : sizeof(float) * (abby_f32_rows(D) * D + GEMM_WT_FLOATS)) +
         sizeof(float) * ((dtype == ASR_BF16 ? 4 * AB_ROWS * 3
                                             : AB_ROWS * abby_slice_cols(D)) +
                          4 * abby_slice_cols(D) + (AB_ROWS + 8) * 3 +
                          2 * AB_ROWS);
}

// h = silu(x W1^T + b1) for the tile's 32 rows and the columns [c0, c0 +
// ncols) on the tensor cores, rounded to bf16, and its partial router
// logits h W2^T, per quarter of each pass's 64 columns, into pl [4][32][3];
// b1s [ldh] and w2s [3][ldh] hold the slice of b1 and W2, written by
// `stage()`, which runs once the first pass's copies are issued.  xs
// [32][ld] and ws [64][ld] bf16 in shared memory; x, w1 16-byte aligned
// with D % 8 == 0 when `vec` (16-byte cp.async copies).  Warp w owns rows
// 16 (w % 2) .. + 15 and columns 16 (w / 2) .. + 15 of each 64-column
// pass.
template <typename Stage>
__device__ void abby_router_tc(const bf16* __restrict__ x,
                               const bf16* __restrict__ w1, const float* b1s,
                               const float* w2s, Stage stage, int N, int D,
                               int r0, int c0, int ncols, int ldh, bool vec,
                               bf16* xs, bf16* ws, float* pl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int nch = abby_chunks(D), ld = abby_ld(D);
  const int mt = warp & 1, nq = warp >> 1;
  for (int n0 = c0; n0 < c0 + ncols; n0 += 64) {
    // chunk ch: columns [64 ch, 64 ch + 64) of the x tile (first pass
    // only) and of W1's rows n0 .. n0 + 63, one commit group
    for (int ch = 0; ch < nch; ++ch) {
      for (int e = t; e < (n0 == c0 ? AB_ROWS + 64 : 64) * 8;
           e += AB_THREADS) {
        const bool is_w = n0 != c0 || e >= AB_ROWS * 8;
        const int ee = (n0 == c0 && is_w) ? e - AB_ROWS * 8 : e;
        const int r = ee >> 3, col = ch * 64 + (ee & 7) * 8;
        const int grow = is_w ? n0 + r : r0 + r;
        const bool row_in = is_w ? grow < D : grow < N;
        const bf16* src = (is_w ? w1 : x) + (size_t)grow * D + col;
        bf16* dst = (is_w ? ws : xs) + r * ld + col;
        if (vec) {
          const bool in = row_in && col < D;
          cp_async16(dst, in ? src : (is_w ? w1 : x), in);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = (row_in && col + i < D) ? src[i]
                                             : __float2bfloat16(0.0f);
        }
      }
      cp_async_commit();
    }
    if (n0 == c0) stage();                // b1s is read after a barrier
    // two accumulator chains a column tile (even and odd k16 steps)
    float acc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait_upto(nch - 1 - ch);   // chunk ch has landed ...
      __syncthreads();                    // ... for every thread
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = ch * 64 + kk * 16;
        uint32_t af[4], bf[4];
        ldsm_x4(af, xs + (16 * mt + (lane & 15)) * ld + k + (lane >> 4) * 8);
        ldsm_x4(bf, ws + (16 * nq + (lm >> 1) * 8 + lr) * ld + k +
                        (lm & 1) * 8);
        mma_bf16(acc[kk & 1][0], af, bf[0], bf[1]);
        mma_bf16(acc[kk & 1][1], af, bf[2], bf[3]);
      }
    }
    // h (rounded to bf16) times this slice of W2, summed over the
    // thread's columns, then over the 4 lanes of a row; pl [4][32][3]
    // holds each column quarter's partial logits, added over the passes
    float p[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * nq + 8 * j + 2 * tg + (e & 1);
        const float v = acc[0][j][e] + acc[1][j][e];
        const float h =
            n < D ? to_f32(from_f32<bf16>(siluf_(v + b1s[n - c0]))) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) p[e >> 1][c] += h * w2s[c * ldh + n - c0];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = p[h][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tg == 0) {
          float* o = pl + (nq * AB_ROWS + 16 * mt + g + 8 * h) * 3 + c;
          *o = n0 == c0 ? v : *o + v;
        }
      }
    __syncthreads();                      // ws is free for the next pass
  }
}

// The same past D 1024 (more than 16 chunks), where 64 rows of W1 no
// longer fit beside the x tile: a pass's chunks of W1 stream through a
// ring of AB_WRING slots ws [AB_WRING][64][72], each refilled once every
// warp is done with it.
template <typename Stage>
__device__ void abby_router_tc_ring(const bf16* __restrict__ x,
                                    const bf16* __restrict__ w1,
                                    const float* b1s, const float* w2s,
                                    Stage stage, int N, int D, int r0,
                                    int c0, int ncols, int ldh, bool vec,
                                    bf16* xs, bf16* ws, float* pl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int nch = abby_chunks(D), ld = abby_ld(D);
  constexpr int nslot = AB_WRING, wld = 72, soff = 64 * wld;
  const int mt = warp & 1, nq = warp >> 1;
  for (int n0 = c0; n0 < c0 + ncols; n0 += 64) {
    // chunk ch: columns [64 ch, 64 ch + 64) of the x tile (first pass
    // only) and of W1's rows n0 .. n0 + 63, one commit group
    auto load = [&](int ch) {
      bf16* wsl = ws + (ch % nslot) * soff;
      for (int e = t; e < (n0 == c0 ? AB_ROWS + 64 : 64) * 8;
           e += AB_THREADS) {
        const bool is_w = n0 != c0 || e >= AB_ROWS * 8;
        const int ee = (n0 == c0 && is_w) ? e - AB_ROWS * 8 : e;
        const int r = ee >> 3, col = ch * 64 + (ee & 7) * 8;
        const int grow = is_w ? n0 + r : r0 + r;
        const bool row_in = is_w ? grow < D : grow < N;
        const bf16* src = (is_w ? w1 : x) + (size_t)grow * D + col;
        bf16* dst = is_w ? wsl + r * wld + (ee & 7) * 8 : xs + r * ld + col;
        if (vec) {
          const bool in = row_in && col < D;
          cp_async16(dst, in ? src : (is_w ? w1 : x), in);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = (row_in && col + i < D) ? src[i]
                                             : __float2bfloat16(0.0f);
        }
      }
      cp_async_commit();
    };
    for (int ch = 0; ch < nslot; ++ch) load(ch);
    if (n0 == c0) stage();                // b1s is read after a barrier
    // two accumulator chains a column tile (even and odd k16 steps)
    float acc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      // chunk ch has landed (groups issued: min(nch, ch + nslot) before
      // this chunk's wait) ...
      cp_async_wait_upto(min(nch, ch + nslot) - 1 - ch);
      __syncthreads();                    // ... for every thread
      const bf16* wsl = ws + (ch % nslot) * soff;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = ch * 64 + kk * 16;
        uint32_t af[4], bf[4];
        ldsm_x4(af, xs + (16 * mt + (lane & 15)) * ld + k + (lane >> 4) * 8);
        ldsm_x4(bf, wsl + (16 * nq + (lm >> 1) * 8 + lr) * wld + kk * 16 +
                        (lm & 1) * 8);
        mma_bf16(acc[kk & 1][0], af, bf[0], bf[1]);
        mma_bf16(acc[kk & 1][1], af, bf[2], bf[3]);
      }
      if (ch + nslot < nch) {             // the ring: the slot is free
        __syncthreads();
        load(ch + nslot);
      }
    }
    // h (rounded to bf16) times this slice of W2, summed over the
    // thread's columns, then over the 4 lanes of a row; pl [4][32][3]
    // holds each column quarter's partial logits, added over the passes
    float p[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * nq + 8 * j + 2 * tg + (e & 1);
        const float v = acc[0][j][e] + acc[1][j][e];
        const float h =
            n < D ? to_f32(from_f32<bf16>(siluf_(v + b1s[n - c0]))) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) p[e >> 1][c] += h * w2s[c * ldh + n - c0];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = p[h][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tg == 0) {
          float* o = pl + (nq * AB_ROWS + 16 * mt + g + 8 * h) * 3 + c;
          *o = n0 == c0 ? v : *o + v;
        }
      }
    __syncthreads();                      // ws is free for the next pass
  }
}

// The same past AB_STREAM_D, where not even the x tile fits beside the
// ring: each ring slot ws [AB_WRING][96][72] holds a 64-column chunk of
// the tile's 32 rows (rows 0..31, read again from L2 every pass) and of
// W1's 64 rows of the pass (rows 32..95).
template <typename Stage>
__device__ void abby_router_tc_stream(const bf16* __restrict__ x,
                                      const bf16* __restrict__ w1,
                                      const float* b1s, const float* w2s,
                                      Stage stage, int N, int D, int r0,
                                      int c0, int ncols, int ldh, bool vec,
                                      bf16* ws, float* pl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int nch = abby_chunks(D);
  constexpr int nslot = AB_WRING, soff = 96 * AB_SLD;
  const int mt = warp & 1, nq = warp >> 1;
  for (int n0 = c0; n0 < c0 + ncols; n0 += 64) {
    auto load = [&](int ch) {
      bf16* sl = ws + (ch % nslot) * soff;
      for (int e = t; e < 96 * 8; e += AB_THREADS) {
        const int r = e >> 3, col = ch * 64 + (e & 7) * 8;
        const bool is_w = r >= AB_ROWS;
        const int grow = is_w ? n0 + r - AB_ROWS : r0 + r;
        const bool row_in = is_w ? grow < D : grow < N;
        const bf16* src = (is_w ? w1 : x) + (size_t)grow * D + col;
        bf16* dst = sl + r * AB_SLD + (e & 7) * 8;
        if (vec) {
          const bool in = row_in && col < D;
          cp_async16(dst, in ? src : (is_w ? w1 : x), in);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dst[i] = (row_in && col + i < D) ? src[i]
                                             : __float2bfloat16(0.0f);
        }
      }
      cp_async_commit();
    };
    for (int ch = 0; ch < min(nslot, nch); ++ch) load(ch);
    if (n0 == c0) stage();                // b1s is read after a barrier
    float acc[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait_upto(min(nch, ch + nslot) - 1 - ch);
      __syncthreads();
      const bf16* sl = ws + (ch % nslot) * soff;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, sl + (16 * mt + (lane & 15)) * AB_SLD + kk * 16 +
                        (lane >> 4) * 8);
        ldsm_x4(bf, sl + (AB_ROWS + 16 * nq + (lm >> 1) * 8 + lr) * AB_SLD +
                        kk * 16 + (lm & 1) * 8);
        mma_bf16(acc[kk & 1][0], af, bf[0], bf[1]);
        mma_bf16(acc[kk & 1][1], af, bf[2], bf[3]);
      }
      if (ch + nslot < nch) {             // the ring: the slot is free
        __syncthreads();
        load(ch + nslot);
      }
    }
    float p[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * nq + 8 * j + 2 * tg + (e & 1);
        const float v = acc[0][j][e] + acc[1][j][e];
        const float h =
            n < D ? to_f32(from_f32<bf16>(siluf_(v + b1s[n - c0]))) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) p[e >> 1][c] += h * w2s[c * ldh + n - c0];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v = p[h][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tg == 0) {
          float* o = pl + (nq * AB_ROWS + 16 * mt + g + 8 * h) * 3 + c;
          *o = n0 == c0 ? v : *o + v;
        }
      }
    __syncthreads();                      // the ring is free for the next pass
  }
}

// The f32 product past AB_STREAM_D: x's columns AB_KCH at a time into xc
// [16][AB_KCH] (read again from L2 for every 64-column pass), W1 through
// gemm_rows16's tile wt, h of a pass [16][64] in ht, and the pass's
// partial logits added into pl [32][3] (pl's other quarters [1..3][32][3]
// zeroed, as the push sums four).
static __device__ void abby_router_f32_stream(const float* __restrict__ x,
                                              const float* __restrict__ w1,
                                              const float* b1s,
                                              const float* w2s, int N, int D,
                                              int r0, int c0, int ncols,
                                              int ldh, float* xc, float* wt,
                                              float* ht, float* pl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int e = t; e < 3 * AB_ROWS * 3; e += AB_THREADS)
    pl[AB_ROWS * 3 + e] = 0.0f;
  for (int half = 0; half < 2; ++half) {
    for (int n0 = c0; n0 < c0 + ncols; n0 += GEMM_NT) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k0 = 0; k0 < D; k0 += AB_KCH) {
        const int kc = min(AB_KCH, D - k0);
        for (int e = t; e < GEMM_ROWS * kc; e += AB_THREADS) {
          const int r = e / kc, j = e % kc;
          const int row = r0 + half * GEMM_ROWS + r;
          xc[e] = row < N ? x[(size_t)row * D + k0 + j] : 0.0f;
        }
        __syncthreads();
        float part[4];
        gemm_rows16<float, false>(xc, kc, kc, w1 + k0, D, n0, D, wt, part);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += part[i];
      }
      const int c = t % GEMM_NT, n = n0 + c;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ht[(4 * (t / GEMM_NT) + i) * GEMM_NT + c] =
            n < D ? siluf_(acc[i] + b1s[n - c0]) : 0.0f;
      __syncthreads();
      // the pass's partial logits: 16 rows x 3, a warp a dot product
      for (int o = warp; o < GEMM_ROWS * 3; o += AB_THREADS / 32) {
        const int r = o / 3, cc = o % 3;
        float s = 0.0f;
        for (int j = lane; j < GEMM_NT; j += 32)
          s += ht[r * GEMM_NT + j] * w2s[cc * ldh + n0 - c0 + j];
        s = warp_sum(s);
        if (lane == 0) {
          float* d = pl + (half * GEMM_ROWS + r) * 3 + cc;
          *d = n0 == c0 ? s : *d + s;
        }
      }
      __syncthreads();
    }
  }
}

// the same product in full f32 on the CUDA cores: the x tile's rows to xf
// (abby_f32_rows(D) of them at once: [32][D], or [16][D] a half at a time
// past AB_F32_WIDE_D), W1 through gemm_rows16's tile
static __device__ void abby_router_f32(const float* __restrict__ x,
                                const float* __restrict__ w1,
                                const float* b1s, int N, int D,
                                int r0, int c0, int ncols, int ldh, float* xf,
                                float* wt, float* hs) {
  const int t = threadIdx.x, xr = abby_f32_rows(D);
  for (int half = 0; half < 2; ++half) {
    const int xr0 = xr == AB_ROWS ? 0 : half * GEMM_ROWS;
    if (half == 0 || xr < AB_ROWS) {
      for (int e = t; e < xr * D; e += AB_THREADS) {
        const int r = e / D, j = e % D, row = r0 + xr0 + r;
        xf[e] = row < N ? x[(size_t)row * D + j] : 0.0f;
      }
      __syncthreads();
    }
    const float* xa = xf + (half * GEMM_ROWS - xr0) * D;
    for (int n0 = c0; n0 < c0 + ncols; n0 += GEMM_NT) {
      float acc[4];
      gemm_rows16<float, false>(xa, D, D, w1, D, n0, D, wt, acc);
      const int n = n0 + t % GEMM_NT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = half * GEMM_ROWS + 4 * (t / GEMM_NT) + i;
        hs[row * ldh + n - c0] = n < D ? siluf_(acc[i] + b1s[n - c0]) : 0.0f;
      }
    }
  }
}

// cv = unbiased std / (mean |x| + 1e-6) of a row in shared memory (bf16
// or f32 values), as abby_choice computes it; every lane gets it
template <typename TS>
__device__ float abby_row_cv(const TS* xr, int D, int lane) {
  float sa = 0.0f, s = 0.0f;
  for (int j = lane; j < D; j += 32) {
    const float v = to_f32(xr[j]);
    sa += fabsf(v);
    s += v;
  }
  sa = warp_sum(sa);
  s = warp_sum(s);
  const float mu = s / (float)D;
  float q = 0.0f;
  for (int j = lane; j < D; j += 32) {
    const float c = to_f32(xr[j]) - mu;
    q += c * c;
  }
  q = warp_sum(q);
  return sqrtf(q / (float)(D - 1)) / (sa / (float)D + 1e-6f);
}

// The tail of channels j0 .. j0 + 7 of a row in shared memory, from
// registers: the squares of the 8 + size - 1 channels around them (-1
// outside the row: no weight in the sum, below every square in the max),
// then each window summed and maxed in channel order as abby_tail_at
// does.  size <= MAXT.
template <int MAXT, typename TS, typename T>
__device__ __forceinline__ void abby_tail8(const TS* xr, int j0, int D,
                                           int size, int choice, float alpha,
                                           float k, float beta, T* orow,
                                           const T* rrow) {
  const int pad = size / 2;
  float v[8 + MAXT - 1];
#pragma unroll
  for (int i = 0; i < 8 + MAXT - 1; ++i) {
    const int jj = j0 - pad + i;
    float sq = -1.0f;
    if (i < 8 + size - 1 && jj >= 0 && jj < D) {
      const float xv = to_f32(xr[jj]);
      sq = xv * xv;
    }
    v[i] = sq;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (j0 + q < D) {
      float s = 0.0f, mx = -1.0f;
#pragma unroll
      for (int o = 0; o < MAXT; ++o)
        if (o < size) {
          s += fmaxf(v[q + o], 0.0f);
          mx = fmaxf(mx, v[q + o]);
        }
      const float avg = s / (float)size;
      const float div2 = mx > 2.0f * avg ? mx : avg;
      const float mix = choice == 1 ? div2 : avg;
      const float y =
          to_f32(xr[j0 + q]) / expf(beta * logf(mix * alpha + k));
      orow[j0 + q] = from_f32<T>(rrow ? to_f32(rrow[j0 + q]) + y : y);
    }
  }
}

// The same for windows wider than ABBY_REG_TAPS, from the row itself
// (each window summed and maxed in channel order, as abby_tail8 does)
template <typename TS, typename T>
__device__ __forceinline__ void abby_tail8_wide(const TS* xr, int j0, int D,
                                                int size, int choice,
                                                float alpha, float k,
                                                float beta, T* orow,
                                                const T* rrow) {
  const int pad = size / 2;
  for (int q = 0; q < 8 && j0 + q < D; ++q) {
    float s = 0.0f, mx = -1.0f;
    for (int o = 0; o < size; ++o) {
      const int jj = j0 + q - pad + o;
      float sq = -1.0f;
      if (jj >= 0 && jj < D) {
        const float xv = to_f32(xr[jj]);
        sq = xv * xv;
      }
      s += fmaxf(sq, 0.0f);
      mx = fmaxf(mx, sq);
    }
    const float avg = s / (float)size;
    const float div2 = mx > 2.0f * avg ? mx : avg;
    const float mix = choice == 1 ? div2 : avg;
    const float y = to_f32(xr[j0 + q]) / expf(beta * logf(mix * alpha + k));
    orow[j0 + q] = from_f32<T>(rrow ? to_f32(rrow[j0 + q]) + y : y);
  }
}

// The same for a window of exactly SIZE taps, with less arithmetic: the
// windows' maxima share the taps all eight windows hold (the sums keep
// the tap order, and so abby_tail_at's rounding).
template <int SIZE, typename TS, typename T>
__device__ __forceinline__ void abby_tail8_sized(const TS* xr, int j0, int D,
                                                 int choice, float alpha,
                                                 float k, float beta,
                                                 T* orow, const T* rrow) {
  constexpr int PAD = SIZE / 2, NV = 8 + SIZE - 1;
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int jj = j0 - PAD + i;
    float sq = -1.0f;
    if (jj >= 0 && jj < D) {
      const float xv = to_f32(xr[jj]);
      sq = xv * xv;
    }
    v[i] = sq;
  }
  float mx[8];
  if constexpr (SIZE >= 8) {
    // window q is [q, q + SIZE): all hold [7, SIZE); the rest is a suffix
    // of [q, 7) and a prefix of [SIZE, q + SIZE)
    float mid = v[7];
#pragma unroll
    for (int i = 8; i < SIZE; ++i) mid = fmaxf(mid, v[i]);
    float left[8], right[8];
    left[7] = -1.0f;
#pragma unroll
    for (int q = 6; q >= 0; --q) left[q] = fmaxf(left[q + 1], v[q]);
    right[0] = -1.0f;
#pragma unroll
    for (int q = 1; q < 8; ++q) right[q] = fmaxf(right[q - 1], v[SIZE + q - 1]);
#pragma unroll
    for (int q = 0; q < 8; ++q) mx[q] = fmaxf(fmaxf(left[q], mid), right[q]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      mx[q] = v[q];
#pragma unroll
      for (int o = 1; o < SIZE; ++o) mx[q] = fmaxf(mx[q], v[q + o]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (j0 + q < D) {
      float s = 0.0f;               // in tap order, as abby_tail_at sums
#pragma unroll
      for (int o = 0; o < SIZE; ++o) s += fmaxf(v[q + o], 0.0f);
      const float avg = s / (float)SIZE;
      const float div2 = mx[q] > 2.0f * avg ? mx[q] : avg;
      const float mix = choice == 1 ? div2 : avg;
      const float y =
          to_f32(xr[j0 + q]) / expf(beta * logf(mix * alpha + k));
      orow[j0 + q] = from_f32<T>(rrow ? to_f32(rrow[j0 + q]) + y : y);
    }
  }
}

// the tail of `nrows` rows of the tile (row stride ld, rows lr0 ..; in
// shared memory, or f32 rows in device memory), one thread per 8 channels
// of a row (SIZE > 0: windows of exactly SIZE taps, else up to
// ABBY_MAX_TAPS); with `res`, out = res + the tail (in f32, rounded once)
template <int SIZE, typename TS, typename T>
__device__ void abby_tail_rows(const TS* xs, int ld, int lr0, int nrows,
                               int r0, int N, int D, int size,
                               const int* choice, float alpha, float k,
                               float beta, const T* __restrict__ res,
                               T* __restrict__ out) {
  const int n8 = (D + 7) / 8;
  for (int it = threadIdx.x; it < nrows * n8; it += AB_THREADS) {
    const int rr = it / n8, j0 = (it % n8) * 8, row = r0 + lr0 + rr;
    if (row >= N) continue;
    if constexpr (SIZE > 0)
      abby_tail8_sized<SIZE>(xs + (lr0 + rr) * ld, j0, D, choice[rr], alpha,
                             k, beta, out + (size_t)row * D,
                             res ? res + (size_t)row * D : nullptr);
    else if (size <= ABBY_REG_TAPS)
      abby_tail8<ABBY_REG_TAPS>(xs + (lr0 + rr) * ld, j0, D, size,
                                choice[rr], alpha, k, beta,
                                out + (size_t)row * D,
                                res ? res + (size_t)row * D : nullptr);
    else
      abby_tail8_wide(xs + (lr0 + rr) * ld, j0, D, size, choice[rr], alpha,
                      k, beta, out + (size_t)row * D,
                      res ? res + (size_t)row * D : nullptr);
  }
}

// The whole eval AbbyNormal of the 32-row tile at row r0 of x (N, D) by
// one thread-block cluster of abby_cluster_size(D) CTAs (the design at
// the top of abby.cu), written to out; with `res`, out = res + the norm
// (in f32, rounded once).  ab_smem: abby_smem_bytes of dynamic shared
// memory.  Every thread of the cluster calls it; it leaves the cluster
// between barriers (a caller that synchronises the cluster again may
// rewrite ab_smem after that).
template <typename T, bool WIDE = false>
__device__ void abby_cluster_tile(const T* __restrict__ x,
                                  const T* __restrict__ w1,
                                  const T* __restrict__ b1,
                                  const T* __restrict__ w2,
                                  const T* __restrict__ b2,
                                  const T* __restrict__ res,
                                  T* __restrict__ out, int N, int D,
                                  int size, float alpha, float k, float beta,
                                  int vec, int r0, unsigned char* ab_smem) {
  cg::cluster_group cl = cg::this_cluster();
  const int S = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  cluster_arrive_relaxed();             // waited on before the first push
  const float b2v[3] = {to_f32(b2[0]), to_f32(b2[1]), to_f32(b2[2])};
  const int sc = abby_slice_cols(D), c0 = rank * sc;
  const int scw = min(sc, D - c0);      // this CTA's columns
  using TS = typename std::conditional<sizeof(T) == 2, bf16, float>::type;
  const TS* xrows;                      // the tile's rows, storage values
  int ldx;
  float* hs;  // f32: h of the slice [32][sc]; bf16: partial logits [4][32][3]
  float* w2s;                           // [3][sc] this slice of W2
  if constexpr (WIDE) {
    // the rows stay in device memory: the cv and the tail read them there
    const size_t ring = sizeof(T) == 2
                            ? sizeof(bf16) * AB_WRING * 96 * AB_SLD
                            : sizeof(float) * (GEMM_ROWS * AB_KCH +
                                               GEMM_WT_FLOATS + GEMM_ROWS * 64);
    hs = reinterpret_cast<float*>(ab_smem + ring);
    w2s = hs + 4 * AB_ROWS * 3;
    xrows = reinterpret_cast<const TS*>(x) + (size_t)r0 * D;
    ldx = D;
  } else if constexpr (sizeof(T) == 2) {
    bf16* xs = reinterpret_cast<bf16*>(ab_smem);
    bf16* ws = xs + AB_ROWS * abby_ld(D);
    hs = reinterpret_cast<float*>(ws + abby_wbuf_elems(D));
    w2s = hs + 4 * AB_ROWS * 3;
    xrows = xs;
    ldx = abby_ld(D);
  } else {
    // past AB_F32_WIDE_D the tile is not held whole: the tail reads the
    // rows from device memory
    float* xf = reinterpret_cast<float*>(ab_smem);
    hs = xf + abby_f32_rows(D) * D + GEMM_WT_FLOATS;
    w2s = hs + AB_ROWS * sc;
    const bool whole = abby_f32_rows(D) == AB_ROWS;
    xrows = whole ? xf : reinterpret_cast<const float*>(x) + (size_t)r0 * D;
    ldx = D;
  }
  float* b1s = w2s + 3 * sc;            // [sc] this slice of b1
  // [S][rows of this CTA][3]: the partial logits of this CTA's rows, as
  // each CTA of the cluster pushed them
  float* recv = b1s + sc;
  float* cvs = recv + (AB_ROWS + 8) * 3;  // [32] cv of its rows
  int* chs = reinterpret_cast<int*>(cvs + AB_ROWS);  // [32] their routes

  // this slice of W2 and b1 to shared memory (bf16: once the first
  // loads of the product are in flight)
  auto stage = [&]() {
    for (int e = t; e < 4 * sc; e += AB_THREADS) {
      const int c = e / sc, j = e % sc;
      w2s[e] = j >= scw ? 0.0f : c < 3 ? to_f32(w2[(size_t)c * D + c0 + j])
                                       : to_f32(b1[c0 + j]);
    }
  };
  if constexpr (WIDE && sizeof(T) == 2) {
    abby_router_tc_stream(reinterpret_cast<const bf16*>(x),
                          reinterpret_cast<const bf16*>(w1), b1s, w2s, stage,
                          N, D, r0, c0, scw, sc, vec != 0,
                          reinterpret_cast<bf16*>(ab_smem), hs);
  } else if constexpr (WIDE) {
    float* xc = reinterpret_cast<float*>(ab_smem);
    stage();
    __syncthreads();
    abby_router_f32_stream(reinterpret_cast<const float*>(x),
                           reinterpret_cast<const float*>(w1), b1s, w2s, N,
                           D, r0, c0, scw, sc, xc, xc + GEMM_ROWS * AB_KCH,
                           xc + GEMM_ROWS * AB_KCH + GEMM_WT_FLOATS, hs);
  } else if constexpr (sizeof(T) == 2) {
    bf16* xs = reinterpret_cast<bf16*>(ab_smem);
    if (abby_chunks(D) <= 16)
      abby_router_tc(reinterpret_cast<const bf16*>(x),
                     reinterpret_cast<const bf16*>(w1), b1s, w2s, stage, N,
                     D, r0, c0, scw, sc, vec != 0, xs,
                     xs + AB_ROWS * abby_ld(D), hs);
    else
      abby_router_tc_ring(reinterpret_cast<const bf16*>(x),
                          reinterpret_cast<const bf16*>(w1), b1s, w2s, stage,
                          N, D, r0, c0, scw, sc, vec != 0, xs,
                          xs + AB_ROWS * abby_ld(D), hs);
  } else {
    float* xf = reinterpret_cast<float*>(ab_smem);
    stage();
    abby_router_f32(reinterpret_cast<const float*>(x),
                    reinterpret_cast<const float*>(w1), b1s, N, D, r0, c0,
                    scw, sc, xf, xf + abby_f32_rows(D) * D, hs);
  }
  __syncthreads();

  // the slice's partial logits of each row, pushed into the shared memory
  // of the CTA that owns the row: bf16 sums the router's column quarters
  // (in hs as [4][32][3]), f32 takes the 3 dot products of a row in a warp
  const int per = (AB_ROWS + S - 1) / S;
  cluster_wait();                       // every CTA has started
  auto push = [&](int r, int c, float v) {
    const int q = r / per;
    cl.map_shared_rank(recv, q)[(rank * per + r - q * per) * 3 + c] = v;
  };
  if constexpr (sizeof(T) == 2 || WIDE) {
    for (int e = t; e < AB_ROWS * 3; e += AB_THREADS) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v += hs[q * AB_ROWS * 3 + e];
      push(e / 3, e % 3, v);
    }
  } else {
    for (int r = warp; r < AB_ROWS; r += AB_THREADS / 32) {
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
      for (int j = lane; j < scw; j += 32) {
        const float h = hs[r * sc + j];
        p0 += h * w2s[j];
        p1 += h * w2s[sc + j];
        p2 += h * w2s[2 * sc + j];
      }
      p0 = warp_sum(p0);
      p1 = warp_sum(p1);
      p2 = warp_sum(p2);
      if (lane == 0) {
        push(r, 0, p0);
        push(r, 1, p1);
        push(r, 2, p2);
      }
    }
  }

  // arrive at the cluster barrier, and while the other CTAs push their
  // partials, take the cv of this CTA's rows of the tile
  const int lr0 = rank * per, nrows = max(0, min(per, AB_ROWS - lr0));
  cluster_arrive();
  for (int rr = warp; rr < nrows; rr += AB_THREADS / 32)
    if (r0 + lr0 + rr < N) {
      const float cv = abby_row_cv(xrows + (lr0 + rr) * ldx, D, lane);
      if (lane == 0) cvs[rr] = cv;
    }
  cluster_wait();
  __syncthreads();

  // each row's logits (the partials of every CTA in rank order, + b2) and
  // its route: argmax(logits + cv), the first maximum on ties
  for (int rr = t; rr < nrows; rr += AB_THREADS) {
    int best = 0;
    float bv = 0.0f;
    for (int c = 0; c < 3; ++c) {
      float s = 0.0f;
      for (int q = 0; q < S; ++q) s += recv[q * per * 3 + rr * 3 + c];
      const float v = (s + b2v[c]) + cvs[rr];
      if (c == 0 || v > bv) {
        bv = v;
        best = c;
      }
    }
    chs[rr] = best;
  }
  __syncthreads();
#define AB_TAIL(m)                                                          \
  abby_tail_rows<m>(xrows, ldx, lr0, nrows, r0, N, D, size, chs, alpha, k, \
                    beta, res, out)
  if (size == 25)         // window_size(512)
    AB_TAIL(25);
  else if (size == 7)     // window_size(128)
    AB_TAIL(7);
  else
    AB_TAIL(0);
#undef AB_TAIL
}

// Launch `kern` over `grid` in clusters of S CTAs along x, with `smem`
// bytes of dynamic shared memory, on stream st.
template <typename... KArgs, typename... Args>
static cudaError_t launch_clusters(void (*kern)(KArgs...), dim3 grid, int S,
                                   size_t smem, cudaStream_t st,
                                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(AB_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, ((KArgs)args)...);
}
