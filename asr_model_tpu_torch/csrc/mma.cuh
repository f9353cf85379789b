// Tensor-core and async-copy helpers for the port's Hopper kernels
// (sm_90a): cp.async into shared memory, ldmatrix, mma.sync in bf16 and
// in TF32, and the 3xTF32 split that keeps f32 accuracy on the tensor
// cores, and the tile product tc_gemm.  Used by flash_attention.cu,
// abby.cu, sheath.cu, xattn.cu and mlp.cu.
#pragma once

#include "common.cuh"

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; `in` false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most `n` commit groups are pending (n past 7 waits for 7:
// stricter, so still correct)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col).  Fragments
// (g = lane / 4, q = lane % 4): a0 (row g, k q), a1 (row g + 8, k q), a2
// (row g, k q + 4), a3 (row g + 8, k q + 4); b0 (k q, col g), b1 (k q + 4,
// col g); c0, c1 (row g, cols 2q, 2q + 1), c2, c3 (row g + 8, the same)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 -> TF32 (10 mantissa bits), rounded half away from zero by integer
// arithmetic
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// the 3xTF32 split: v = hi + lo with hi = tf32(v) and lo = tf32(v - hi)
// (v - hi is exact in f32), so hi * b_hi + lo * b_hi + hi * b_lo keeps
// the product to about f32 accuracy: what is dropped (lo * b_lo, lo's
// rounding) is ~2^-22 of it
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// The thread-block cluster's barrier in two halves, so that work can run
// between arriving and waiting.  A CTA may write another CTA's shared
// memory only after a barrier that CTA has arrived at (it has started).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// Tensor-core tile product of 8 warps (256 threads), bf16 in, f32 sums:
// acc = A W^T over k < K for a tile of 16 MT rows and NC = 64 NJ / MT
// columns.  Warp w owns rows 16 (w % MT) .. + 15 and the NJ column tiles
// of 8 from (w / MT) 8 NJ; acc[j][e] is the element (row, col) of
// tc_row(e), tc_col(j, e).
//   A: A_SMEM, the tile's rows in shared memory (row stride lda elements,
//   zero past K up to the next multiple of 64); else in device memory
//   (row stride lda, `a_rows` valid rows, the rest read as 0), streamed
//   with W.
//   W: W_KN false, W(k, n) = w[n * ldw + k] (torch (out, in) layout,
//   `n_valid` valid rows); W_KN true, W(k, n) = w[k * ldw + n] (rows k of
//   n_valid valid columns, as V is stored).  Past K and past n_valid it
//   reads 0.  tc_gemm_rows takes W's rows from `wrow(n)` instead (the
//   row's device pointer, null for a row of zeros), so that one product
//   can gather rows of several matrices.
// Operands arrive through a ring of ST 64-deep k chunks in flight
// (cp.async; `ring`, tc_ring_elems bf16); device pointers and row strides
// must be 16-byte multiples (K % 8 == 0).  All 256 threads call it; it
// synchronises on entry and before it returns, so the ring and A may be
// rewritten after it.
constexpr int TC_KC = 64;

__host__ __device__ constexpr int tc_cols(int MT, int NJ) {
  return 64 * NJ / MT;
}
__host__ __device__ constexpr int tc_stage_elems(int MT, int NJ, bool a_smem,
                                                 bool w_kn) {
  return (a_smem ? 0 : 16 * MT * (TC_KC + 8)) +
         (w_kn ? TC_KC * (tc_cols(MT, NJ) + 8)
               : tc_cols(MT, NJ) * (TC_KC + 8));
}
__host__ __device__ constexpr int tc_ring_elems(int MT, int NJ, bool a_smem,
                                                bool w_kn, int ST) {
  return ST * tc_stage_elems(MT, NJ, a_smem, w_kn);
}
template <int MT>
__device__ __forceinline__ int tc_row(int e) {
  return 16 * ((threadIdx.x >> 5) % MT) + ((threadIdx.x & 31) >> 2) +
         8 * (e >> 1);
}
template <int MT, int NJ>
__device__ __forceinline__ int tc_col(int j, int e) {
  return ((threadIdx.x >> 5) / MT) * 8 * NJ + 8 * j +
         2 * (threadIdx.x & 3) + (e & 1);
}

template <int MT, int NJ, bool A_SMEM, bool W_KN, int ST, typename WRow>
__device__ void tc_gemm_core(const bf16* a, int lda, int a_rows, WRow wrow,
                             const bf16* __restrict__ w, int ldw, int n_valid,
                             int K, bf16* ring, float acc[NJ][4]) {
  constexpr int ROWS = 16 * MT, NC = tc_cols(MT, NJ);
  constexpr int LDA = TC_KC + 8;
  constexpr int LDW = W_KN ? NC + 8 : TC_KC + 8;
  constexpr int A_ELEMS = A_SMEM ? 0 : ROWS * LDA;
  constexpr int STAGE = tc_stage_elems(MT, NJ, A_SMEM, W_KN);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mi = warp % MT, n0w = (warp / MT) * 8 * NJ;
  const int lm = lane >> 3, lr = lane & 7;
  const int nk = (K + TC_KC - 1) / TC_KC;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  auto load = [&](int c) {
    bf16* st = ring + (c % ST) * STAGE;
    const int k0 = c * TC_KC;
    if constexpr (!A_SMEM) {
      for (int e = t; e < ROWS * 8; e += 256) {
        const int r = e >> 3, kk = k0 + (e & 7) * 8;
        const bool in = r < a_rows && kk < K;
        cp_async16(st + r * LDA + (e & 7) * 8,
                   in ? a + (size_t)r * lda + kk : a, in);
      }
    }
    bf16* ws = st + A_ELEMS;
    if constexpr (W_KN) {
      for (int e = t; e < TC_KC * (NC / 8); e += 256) {
        const int r = e / (NC / 8), n = (e % (NC / 8)) * 8;
        const bool in = k0 + r < K && n < n_valid;
        cp_async16(ws + r * LDW + n, in ? w + (size_t)(k0 + r) * ldw + n : w,
                   in);
      }
    } else {
      for (int e = t; e < NC * 8; e += 256) {
        const int n = e >> 3, kk = k0 + (e & 7) * 8;
        const bf16* src = wrow(n);
        const bool in = src != nullptr && kk < K;
        cp_async16(ws + n * LDW + (e & 7) * 8, in ? src + kk : w, in);
      }
    }
  };

  __syncthreads();                      // the ring is free, A is written
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<ST - 2>();            // chunk c has landed ...
    __syncthreads();                    // ... for every thread, and the
                                        // stage of chunk c - 1 is free
    if (c + ST - 1 < nk) load(c + ST - 1);
    cp_async_commit();
    const bf16* st = ring + (c % ST) * STAGE;
    const bf16* ws = st + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_KC; kk += 16) {
      uint32_t af[4];
      if constexpr (A_SMEM)
        ldsm_x4(af, a + (16 * mi + (lane & 15)) * lda + c * TC_KC + kk +
                        (lane >> 4) * 8);
      else
        ldsm_x4(af, st + (16 * mi + (lane & 15)) * LDA + kk +
                        (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t bfr[4];
        const int nb = n0w + 16 * jj;
        if constexpr (W_KN)
          ldsm_x4_t(bfr, ws + (kk + (lm & 1) * 8 + lr) * LDW + nb +
                             (lm >> 1) * 8);
        else
          ldsm_x4(bfr, ws + (nb + (lm >> 1) * 8 + lr) * LDW + kk +
                           (lm & 1) * 8);
        mma_bf16(acc[2 * jj], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * jj + 1], af, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring may be reused
}

template <int MT, int NJ, bool A_SMEM, bool W_KN, int ST>
__device__ __forceinline__ void tc_gemm(const bf16* a, int lda, int a_rows,
                                        const bf16* __restrict__ w, int ldw,
                                        int n_valid, int K, bf16* ring,
                                        float acc[NJ][4]) {
  tc_gemm_core<MT, NJ, A_SMEM, W_KN, ST>(
      a, lda, a_rows,
      [=](int n) { return n < n_valid ? w + (size_t)n * ldw : nullptr; }, w,
      ldw, n_valid, K, ring, acc);
}

// the same with W's rows gathered by wrow(n); w: any valid device
// address (read by no copy)
template <int MT, int NJ, bool A_SMEM, int ST, typename WRow>
__device__ __forceinline__ void tc_gemm_rows(const bf16* a, int lda,
                                             int a_rows, WRow wrow,
                                             const bf16* w, int K,
                                             bf16* ring, float acc[NJ][4]) {
  tc_gemm_core<MT, NJ, A_SMEM, false, ST>(a, lda, a_rows, wrow, w, 0, 0, K,
                                          ring, acc);
}
