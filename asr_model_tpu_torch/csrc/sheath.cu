// MSheath eval layer-slot recurrence for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/sheath_kernel.py:fused_sheath_scan.
//
// Each of the L scan steps runs the slot i (a device scalar; the jump
// policy moves it by 1..3): v_gate (softmax over the l2-normalised
// memory keys dotted with mval, plus the silu scoring MLP, thresholded
// to ion in {0, 1}); LayerNorm; the even-slot adapter; the sigmoid skip
// gate; x_new = x + g * (apx * ion); the working-memory EMA over the
// per-batch masked mean of x_new; and the scalar jump policy (forced
// skip when the global masked mean of ion < 0.1, else the caller's
// sampled action, none on the last slot).  Outputs x, actions (L,) and
// jstat (3,).  Everything inside is f32.
//
// What bounds it: at encoder length (N = 8 * 1001 rows, D = 512) each
// slot's row products (N x 512 by 512 x (64 + 256 + 512)) are ~0.85
// GFLOP on 8 MB of activations -- operations, not bytes -- and each slot
// needs two reductions over all rows before the next slot may start.
// At decode widths (8 * 9 .. 8 * 65 rows) the rows alone cannot fill 132
// SMs, and a block that streams all of a slot's weights (1.7 MB) for 16
// rows is bound by that stream: on the H100 one SM reads about 10-15
// bytes a cycle this way, so the weight bytes per CTA set its time.
//
// Design: per scan step two launches, plus one at the end, with no host
// synchronisation (each reads the slot index from device memory and
// returns at once when the slot is past L):
//   sheath_rows  -- a thread-block cluster per row tile (16 rows when
//                   the clusters all fit on the card at once, two CTAs an
//                   SM, else 64), one CTA per 64-column slice: CTA q takes
//                   columns [64 q, 64 q + 64) of the slot's [mkey^T |
//                   vmlp1_w] (64 + 256 columns: 5 CTAs) and of adapt_w
//                   (512: 8 CTAs), and streams only those slices of the
//                   weights (32-row chunks through a cp.async ring).
//                   Past 8 slices (D > 512, or M + D2 > 512) a cluster
//                   stays at 8 CTAs and CTA q takes slices q, q + 8, ...
//                   one pass each over the same x tile.
//                   Every CTA loads the tile's rows (the previous step's
//                   jump term folded into the load), takes the LayerNorm
//                   statistics and the skip gate, and runs its two
//                   products on the tensor cores at f32 accuracy:
//                   mma.sync.m16n8k8 in TF32 with the f32 activations
//                   split as hi + lo, the 3xTF32 scheme (LayerNorm(x),
//                   the adapter's input, is formed in the fragments).
//                   Weights exact in bf16 (the bf16 model's upcast ones)
//                   stream as bf16, half the bytes, and are exact TF32
//                   values: 2 products; other weights stream as f32 and
//                   are split too: 3 products.  A CTA that holds memory
//                   logits (CTA 0 alone when M <= 64) takes their
//                   softmax terms (max, sum of exponentials, and their
//                   sum weighted by mval); every CTA its share of the
//                   scoring MLP's dot product.  Each pushes its scores
//                   into every CTA's shared memory (distributed shared
//                   memory); after one cluster barrier each merges them
//                   in rank order (so all agree on ion, the hard
//                   threshold) and writes its columns of x_new into the
//                   f32 state.
//   sheath_mem_ctl -- the per-batch masked mean of x_new (a block per
//                   (batch, 32 channels), rows summed in a fixed order),
//                   and in the last block to finish (a counter, after
//                   __threadfence) the step's scalar control: the global
//                   masked mean of ion, the EMA, the jump action, the
//                   next slot index, actions, jstat.
//   sheath_finish -- the last pending jump term, and x cast back to its
//                   storage type.
// Past D = 2048 (sheath_rows' WIDE variant) the tile's 16 rows would not
// fit in shared memory beside the ring: each CTA applies the pending jump
// term to its share of the rows' columns in the f32 state, in place, and
// after a cluster barrier every CTA reads the rows from there (L2) for
// the statistics, the products' A fragments and the update.
// Step 0 reads x in its storage type and ignores the device control,
// which it leaves to its sheath_mem_ctl to set up, so no launch
// initialises anything.  The TPU kernel's pooling matrices (which only
// existed to turn the reductions into matmuls) are gone: the reductions
// read the mask.
#include <algorithm>

#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

struct SheathArgs {
  const void* x_in;        // (N, D) storage dtype: the scan's input
  void* out;               // (N, D) storage dtype
  const uint8_t* valid;    // (B, C) or null
  const float* mem0;       // (D,)
  const int* sampled;      // device scalar: argmax of the mean policy
  const float* jump_s;     // (3,)
  const float* ln_scale;   // (L, D)
  const float* ln_bias;    // (L, D)
  const float* gate_w;     // (L, D)
  const float* gate_b;     // (L,)
  const float* mkinv;      // (L, M) 1 / max(||mkey[m]||, 1e-12)
  const float* mval;       // (L, M)
  const void* wsc;         // (L, D, SCP): [mkey^T | vmlp1_w | 0]
  const float* vmlp1_b;    // (L, D2)
  const float* vmlp2_w;    // (L, D2)
  const float* vmlp2_b;    // (L,)
  const float* vcat_w;     // (L, 2)
  const float* vcat_b;     // (L,)
  const void* wad;         // ((L + 1) / 2, D, DP): [adapt_w | 0]
  const float* adapt_b;    // ((L + 1) / 2, D)
  const float* memgate_w;  // (D,)
  const float* memgate_b;  // (1,)
  float* xs;               // (N, D) f32 state
  float* ion;              // (N,)
  float* mem;              // (B, D)
  float* mem_w;            // (B, D)
  int* ctl;                // [slot i, jump pending]
  int* counter;            // blocks of sheath_mem_ctl done (0 between)
  float* jump_w;           // (1,)
  int* actions;            // (L,)
  int* jstat;              // (3,)
  float* aog;              // the GL rows' adapter outputs, or null
  int N, B, C, D, D2, M, L, SCP, DP;
  float thresh;
};

constexpr int SH_THREADS = 256;
constexpr int SH_KC = 32;         // weight rows (k) a ring stage
constexpr int SH_NST = 3;         // ring stages
constexpr int SH_LDW = 72;        // ring row stride: 64 columns + 8
constexpr int SH_MAX_CLUSTER = 8;
constexpr int SH_MEM_GROUP = 64;  // batch rows a pass of the memory EMA
// past this width the tile's rows are not held in shared memory (19 f32
// rows of D + 4 and the ring would pass it): the WIDE row kernel applies
// the pending jump term to them in the f32 state in place, and reads
// them from there (L2) for the statistics, the products' A fragments and
// the update
constexpr int SH_WIDE_D = 2048;
__host__ __device__ constexpr bool sh_wide(int D) { return D > SH_WIDE_D; }

// row stride of the x tile: k padded to whole KC chunks, + 4 so that a
// fragment's 8 rows x 4 columns fall in 32 banks
__host__ __device__ constexpr int sh_lda(int D) {
  return (D + SH_KC - 1) / SH_KC * SH_KC + 4;
}

// the 64-column slices of a slot's products, the CTAs of a cluster (one
// a slice, at most 8) and the passes a CTA makes over its slices
__host__ __device__ constexpr int sh_slices(int SCP, int DP) {
  return (SCP > DP ? SCP : DP) / 64;
}
__host__ __device__ constexpr int sh_cluster_size(int SCP, int DP) {
  return sh_slices(SCP, DP) < SH_MAX_CLUSTER ? sh_slices(SCP, DP)
                                             : SH_MAX_CLUSTER;
}
__host__ __device__ constexpr int sh_passes(int SCP, int DP) {
  return (sh_slices(SCP, DP) + SH_MAX_CLUSTER - 1) / SH_MAX_CLUSTER;
}

// dynamic shared memory of sheath_rows at R rows a tile and NP passes: the
// x tile (none past SH_WIDE_D), the slot's LayerNorm scale and bias and
// gate weights, the weight
// ring (then the two products' outputs), five values a row and the four
// scores each CTA pushes to it (5 + 4 * 8 a row), two values for each of
// the pass's 64 score columns, and the adapter outputs of the passes
// before the last
__host__ __device__ constexpr size_t sh_smem_bytes(int R, int D, int NP) {
  return sizeof(float) * (((sh_wide(D) ? 0 : R) + 3) * sh_lda(D) +
                          SH_NST * 2 * SH_KC * SH_LDW +
                          (5 + 4 * SH_MAX_CLUSTER) * R + 128 +
                          (NP - 1) * R * SH_LDW);
}

// whether the row kernel keeps its slot vectors and adapter outputs in
// device memory (GL): past the width where a 16-row tile's shared memory
// (sh_smem_bytes) passes a block's
__host__ __device__ constexpr bool sh_gl(int D, int SCP, int DP) {
  return sh_wide(D) && sh_smem_bytes(16, D, sh_passes(SCP, DP)) > 232448;
}

// the GL row kernel's shared memory: the ring and the per-row values
// alone (the slot vectors and the earlier passes' adapter outputs stay in
// device memory), and its device-memory scratch of adapter outputs, in
// floats, for one CTA
__host__ __device__ constexpr size_t sh_smem_bytes_gl(int R) {
  return sizeof(float) * (SH_NST * 2 * SH_KC * SH_LDW +
                          (5 + 4 * SH_MAX_CLUSTER) * R + 128);
}
__host__ __device__ constexpr size_t sh_aog_floats(int R, int NP) {
  return (size_t)(NP - 1) * R * SH_LDW;
}

// LayerNorm of one value, in the order the plain version computes it
__device__ __forceinline__ float sh_ln(float x, float mu, float rstd,
                                       float s, float b) {
  return (x - mu) * rstd * s + b;
}

// sum / max over aligned groups of W lanes (a fixed order)
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// c += a b at f32 accuracy: lo * b_hi and (f32 weights) hi * b_lo first,
// then hi * b_hi
template <typename TW>
__device__ __forceinline__ void sh_mma3(float c[4], const uint32_t ahi[4],
                                        const uint32_t alo[4],
                                        const uint32_t bhi[2],
                                        const uint32_t blo[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  if constexpr (sizeof(TW) == 4) mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

// a B fragment from a ring chunk (row stride SH_LDW elements): f32
// weights split into TF32 hi and lo; bf16 weights are TF32 values as they
// are (their bits in the top half)
__device__ __forceinline__ void sh_frag_b(const float* w, int kr, int n,
                                          int tg, uint32_t hi[2],
                                          uint32_t lo[2]) {
  split_tf32(w[(kr + tg) * SH_LDW + n], hi[0], lo[0]);
  split_tf32(w[(kr + tg + 4) * SH_LDW + n], hi[1], lo[1]);
}
__device__ __forceinline__ void sh_frag_b(const bf16* w, int kr, int n,
                                          int tg, uint32_t hi[2],
                                          uint32_t lo[2]) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(w);
  hi[0] = (uint32_t)u[(kr + tg) * SH_LDW + n] << 16;
  hi[1] = (uint32_t)u[(kr + tg + 4) * SH_LDW + n] << 16;
  lo[0] = lo[1] = 0u;
}

// four values of a row tile's x (T in device memory) as f32
__device__ __forceinline__ float4 sh_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 sh_load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// The tile's rows (R of them) into xt: x in its storage type (step 0), or
// the f32 state, plus the previous step's jump term when one is pending.
// Branch-free bodies, so that the loads of several iterations are in
// flight together; four values at a time when D % 4 == 0.
template <typename T, int R>
__device__ __forceinline__ void sh_load_rows(const SheathArgs& a, int step,
                                             bool pend, float jw, int r0,
                                             int lda, float* xt) {
  const int D = a.D, d4 = D / 4;
  const T* x0 = (const T*)a.x_in;
  if (D % 4) {
    for (int e = threadIdx.x; e < R * D; e += SH_THREADS) {
      const int r = e / D, j = e - r * D, row = min(r0 + r, a.N - 1);
      const size_t o = (size_t)row * D + j;
      float v = step == 0 ? to_f32(x0[o]) : a.xs[o];
      if (pend)
        v = v + (jw * to_f32(x0[o]) +
                 (1.0f - jw) * a.mem_w[(size_t)(row / a.C) * D + j]);
      xt[r * lda + j] = r0 + r < a.N ? v : 0.0f;
    }
  } else if (step == 0) {
#pragma unroll 8
    for (int e = threadIdx.x; e < R * d4; e += SH_THREADS) {
      const int r = e / d4, j = (e - r * d4) * 4, row = min(r0 + r, a.N - 1);
      float4 v = sh_load4(x0 + (size_t)row * D + j);
      if (r0 + r >= a.N) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(xt + r * lda + j) = v;
    }
  } else if (!pend) {
#pragma unroll 8
    for (int e = threadIdx.x; e < R * d4; e += SH_THREADS) {
      const int r = e / d4, j = (e - r * d4) * 4, row = min(r0 + r, a.N - 1);
      float4 v = sh_load4(a.xs + (size_t)row * D + j);
      if (r0 + r >= a.N) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(xt + r * lda + j) = v;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * d4; e += SH_THREADS) {
      const int r = e / d4, j = (e - r * d4) * 4, row = min(r0 + r, a.N - 1);
      const size_t o = (size_t)row * D + j;
      float4 v = sh_load4(a.xs + o);
      const float4 u = sh_load4(x0 + o);
      const float4 mw = sh_load4(a.mem_w + (size_t)(row / a.C) * D + j);
      v.x = v.x + (jw * u.x + (1.0f - jw) * mw.x);
      v.y = v.y + (jw * u.y + (1.0f - jw) * mw.y);
      v.z = v.z + (jw * u.z + (1.0f - jw) * mw.z);
      v.w = v.w + (jw * u.w + (1.0f - jw) * mw.w);
      if (r0 + r >= a.N) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(xt + r * lda + j) = v;
    }
  }
  for (int e = threadIdx.x; e < R * (lda - D); e += SH_THREADS)
    xt[(e / (lda - D)) * lda + D + e % (lda - D)] = 0.0f;
}

// Warp w takes the k8 step w % 4 of every 32-row chunk (a k-group) and
// the n-tiles 4 (w / 4) .. + 3 of the slice, for every m-tile of the
// tile: each A fragment is split by two warps and serves 4 n-tiles, and
// the k-groups' partial sums are added in a fixed order at the end.  The
// row passes (LayerNorm, scores) give each row TPR = 256 / R threads.
// CTA q of a cluster of cs takes the slices q, q + cs, ..., one pass
// each; MP (more than 8 slices, 16-row tiles only) builds the pass loop,
// else the one pass is compiled alone (the loop cost the 64-row tiles
// 11-15% at D 512).
// WIDE (past SH_WIDE_D; MP, 16-row tiles): the tile's rows stay in the
// f32 state, where each CTA first writes its share of their columns with
// the pending jump term (step 0: x converted), a cluster barrier later
// read by every CTA from L2.
// GL (WIDE, past the width whose slot vectors and adapter outputs fit
// beside the ring, sh_smem_bytes > 232448: D past 8,320): the slot's
// LayerNorm scale and bias and skip-gate weights are read from device
// memory where they are used, and the adapter outputs of the passes
// before the last go to the CTA's share of a.aog (device memory, L2).
template <typename T, int R, typename TW, bool MP, bool WIDE = false,
          bool GL = false>
__global__ void __launch_bounds__(SH_THREADS, R == 16 ? 2 : 1)
sheath_rows(SheathArgs a, int step) {
  constexpr int MW = R / 16, KG = SH_KC / 8;
  constexpr int NTW = 8 * KG / (SH_THREADS / 32);
  constexpr int TPR = SH_THREADS / R, CPT = 64 / TPR;
  const int i = step == 0 ? 0 : a.ctl[0];
  if (i >= a.L) return;             // the whole grid returns together
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  cluster_arrive_relaxed();         // waited on before the first push
  const int D = a.D, lda = sh_lda(D), M = a.M, D2 = a.D2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int kg = warp % KG, nt0 = (warp / KG) * NTW;
  const int r0 = blockIdx.y * R;
  // this CTA's last pass
  const int plast = MP ? (sh_slices(a.SCP, a.DP) - 1 - rank) / cs : 0;
  extern __shared__ __align__(128) float sh_smem[];
  float* xt = sh_smem;                          // [R][lda]  x (not WIDE)
  float* lns = xt + (WIDE ? 0 : R * lda);       // [lda] LayerNorm scale
  float* lnb = lns + (GL ? 0 : lda);            // [lda] LayerNorm bias
  float* gw = lnb + (GL ? 0 : lda);             // [lda] skip-gate weights
  float* ring = gw + (GL ? 0 : lda);            // [NST][2][KC][LDW]
  float* so = ring;                             // [R][LDW] score product
  float* mu = ring + SH_NST * 2 * SH_KC * SH_LDW;   // [R] row mean
  float* rstd = mu + R;                         // [R] 1 / row std
  float* xinv = rstd + R;                       // [R] 1 / ||x||
  float* gv = xinv + R;                         // [R] skip gate
  float* ionr = gv + R;                         // [R] ion
  // the scores each CTA of the cluster pushed here, [8][R] each: over its
  // memory columns the softmax's max, sum of exponentials and their sum
  // weighted by mval; its share of the scoring MLP's dot product
  float* rmm = ionr + R;
  float* rse = rmm + SH_MAX_CLUSTER * R;
  float* rsv = rse + SH_MAX_CLUSTER * R;
  float* rmlp = rsv + SH_MAX_CLUSTER * R;
  float* colw = rmlp + SH_MAX_CLUSTER * R;      // [64] key norm or MLP w2
  float* colb = colw + 64;                      // [64] mval or MLP bias
  // [passes - 1][R][LDW] adapter products
  float* aosave =
      GL ? a.aog + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                       sh_aog_floats(R, sh_passes(a.SCP, a.DP))
         : colb + 64;
  // the adapter product of pass p: the last pass's stays in the ring
  auto ao_of = [&](int p) {
    return p == plast ? ring + R * SH_LDW : aosave + p * R * SH_LDW;
  };
  if (step == 0 && blockIdx.x == 0 && blockIdx.y == 0 && t == 0)
    *a.counter = 0;

  const TW* wsc = (const TW*)a.wsc + (size_t)i * D * a.SCP;
  const TW* wad = (const TW*)a.wad + (size_t)(i / 2) * D * a.DP;
  TW* wring = reinterpret_cast<TW*>(ring);      // [NST][2][KC][LDW] of TW
  constexpr int SEGS = 64 * sizeof(TW) / 16;    // 16-byte pieces a row
  const int nkc = (D + SH_KC - 1) / SH_KC;
  // stage kc % NST <- rows [KC kc, KC kc + KC) of pass p's slices
  auto load_stage = [&](int p, int kc) {
    const int c0 = 64 * (rank + p * cs);
    const bool has_sc = c0 < a.SCP, has_ad = i % 2 == 0 && c0 < a.DP;
    if (kc < nkc && (has_sc || has_ad)) {
      const int k0 = kc * SH_KC;
#pragma unroll
      for (int h = 0; h < SH_KC * SEGS / SH_THREADS; ++h) {
        const int e = t + h * SH_THREADS;
        const int kr = e / SEGS, c = c0 + (e % SEGS) * (16 / sizeof(TW));
        const int k = k0 + kr;
        TW* st = wring + (kc % SH_NST) * 2 * SH_KC * SH_LDW + kr * SH_LDW +
                 c - c0;
        if (has_sc)
          cp_async16(st, k < D ? wsc + (size_t)k * a.SCP + c : wsc, k < D);
        if (has_ad)
          cp_async16(st + SH_KC * SH_LDW,
                     k < D ? wad + (size_t)k * a.DP + c : wad, k < D);
      }
    }
    cp_async_commit();
  };
  // pass p's score-column constants
  auto load_cols = [&](int p) {
    if (t < 64) {
      const int n = 64 * (rank + p * cs) + t;
      const float inv_sqrt_d = 1.0f / sqrtf((float)D);
      colw[t] = n < M ? a.mkinv[(size_t)i * M + n] * inv_sqrt_d
                : n < M + D2 ? a.vmlp2_w[(size_t)i * D2 + n - M] : 0.0f;
      colb[t] = n < M ? a.mval[(size_t)i * M + n]
                : n < M + D2 ? a.vmlp1_b[(size_t)i * D2 + n - M] : 0.0f;
    }
  };
#pragma unroll
  for (int st = 0; st < SH_NST - 1; ++st) load_stage(0, st);

  // the slot's vectors (GL: read where used, 0 past D)
  if constexpr (!GL)
    for (int j = t; j < lda; j += SH_THREADS) {
      const bool in = j < D;
      lns[j] = in ? a.ln_scale[(size_t)i * D + j] : 0.0f;
      lnb[j] = in ? a.ln_bias[(size_t)i * D + j] : 0.0f;
      gw[j] = in ? a.gate_w[(size_t)i * D + j] : 0.0f;
    }
  auto slot_vec = [&](const float* sv, const float* dv, int j) -> float {
    if constexpr (GL)
      return j < D ? __ldg(dv + (size_t)i * D + j) : 0.0f;
    else
      return sv[j];
  };
  auto lns_at = [&](int j) { return slot_vec(lns, a.ln_scale, j); };
  auto lnb_at = [&](int j) { return slot_vec(lnb, a.ln_bias, j); };
  auto gw_at = [&](int j) { return slot_vec(gw, a.gate_w, j); };
  load_cols(0);
  const bool pend = step > 0 && a.ctl[1] != 0;
  // x of the tile's row r, column j (0 outside the tile's rows and D)
  auto xval = [&](int r, int j) -> float {
    if constexpr (WIDE)
      return r0 + r < a.N && j < D ? __ldcg(a.xs + (size_t)(r0 + r) * D + j)
                                   : 0.0f;
    else
      return xt[r * lda + j];
  };
  if constexpr (WIDE) {
    // this CTA's share of the columns, in place in the f32 state
    const T* x0 = (const T*)a.x_in;
    const float jw = pend ? a.jump_w[0] : 0.0f;
    const int share = (D + cs - 1) / cs, j0 = rank * share;
    const int nj = max(0, min(share, D - j0));
    for (int e = t; e < R * nj; e += SH_THREADS) {
      const int r = e / nj, j = j0 + e % nj, row = r0 + r;
      if (row >= a.N) continue;
      const size_t o = (size_t)row * D + j;
      float v = step == 0 ? to_f32(x0[o]) : a.xs[o];
      if (pend)
        v = v + (jw * to_f32(x0[o]) +
                 (1.0f - jw) * a.mem_w[(size_t)(row / a.C) * D + j]);
      a.xs[o] = v;
    }
    __threadfence();
    cluster_wait();                 // the start's arrive
    cluster_arrive();               // release the rows ...
    cluster_wait();                 // ... and see every CTA's
    cluster_arrive_relaxed();       // waited on before the first push
  } else {
    sh_load_rows<T, R>(a, step, pend, pend ? a.jump_w[0] : 0.0f, r0, lda,
                       xt);
  }
  __syncthreads();

  // per-row norm, LayerNorm statistics (two-pass variance, eps 1e-5) and
  // skip gate: TPR threads a row
  {
    const int r = t / TPR, q = t % TPR;
    float s = 0.0f, sq = 0.0f;
    for (int j = q; j < D; j += TPR) {
      const float xj = xval(r, j);
      s += xj;
      sq += xj * xj;
    }
    s = group_sum<TPR>(s);
    sq = group_sum<TPR>(sq);
    const float m = s / (float)D;
    float v = 0.0f;
    for (int j = q; j < D; j += TPR) {
      const float c = xval(r, j) - m;
      v += c * c;
    }
    const float rs = rsqrtf(group_sum<TPR>(v) / (float)D + 1e-5f);
    float gs = 0.0f;
    for (int j = q; j < D; j += TPR)
      gs += sh_ln(xval(r, j), m, rs, lns_at(j), lnb_at(j)) * gw_at(j);
    gs = group_sum<TPR>(gs);
    if (q == 0) {
      mu[r] = m;
      rstd[r] = rs;
      xinv[r] = rsqrtf(fmaxf(sq, 1e-24f));
      gv[r] = sigmoidf_(gs + a.gate_b[i]);
    }
  }
  __syncthreads();

  float mur[MW][2], rsr[MW][2];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mur[m][h] = mu[16 * m + g + 8 * h];
      rsr[m][h] = rstd[16 * m + g + 8 * h];
    }
  // this CTA's scores of its row (r = t / TPR), over its passes: the
  // memory softmax's running max, sum of exponentials, their sum weighted
  // by mval, and the scoring MLP's partial dot product
  float run_m = -INFINITY, run_se = 0.0f, run_sv = 0.0f, run_hp = 0.0f;
  for (int p = 0; p <= plast; ++p) {
    const int c0 = 64 * (rank + p * cs);
    const bool has_sc = c0 < a.SCP, has_ad = i % 2 == 0 && c0 < a.DP;
    if (p > 0) {
#pragma unroll
      for (int st = 0; st < SH_NST - 1; ++st) load_stage(p, st);
      load_cols(p);                 // read after the barriers below
    }
    float* ao = ao_of(p);
    if (has_sc || has_ad) {
      // the two products; LayerNorm(x), the adapter's A, is formed in
      // the fragments from x and the row statistics
      float acc_s[MW][NTW][4], acc_a[MW][NTW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_s[m][n][e] = acc_a[m][n][e] = 0.0f;
      for (int kc = 0; kc < nkc; ++kc) {
        cp_async_wait<SH_NST - 2>();    // chunk kc has landed ...
        __syncthreads();                // ... for every thread
        load_stage(p, kc + SH_NST - 1); // streams in while this chunk runs
        const TW* ws = wring + (kc % SH_NST) * 2 * SH_KC * SH_LDW;
        const int kr = kg * 8, k = kc * SH_KC + kr + tg;
        uint32_t bsh[NTW][2], bsl[NTW][2], bah[NTW][2], bal[NTW][2];
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          if (has_sc)
            sh_frag_b(ws, kr, 8 * (nt0 + n) + g, tg, bsh[n], bsl[n]);
          if (has_ad)
            sh_frag_b(ws + SH_KC * SH_LDW, kr, 8 * (nt0 + n) + g, tg, bah[n],
                      bal[n]);
        }
        const float s0 = lns_at(k), s1 = lns_at(k + 4), b0 = lnb_at(k),
                    b1 = lnb_at(k + 4);
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          float xv[4];
          if constexpr (WIDE) {
            xv[0] = xval(16 * m + g, k);
            xv[1] = xval(16 * m + g + 8, k);
            xv[2] = xval(16 * m + g, k + 4);
            xv[3] = xval(16 * m + g + 8, k + 4);
          } else {
            const float* xa = xt + (16 * m + g) * lda + k;
            xv[0] = xa[0];
            xv[1] = xa[8 * lda];
            xv[2] = xa[4];
            xv[3] = xa[8 * lda + 4];
          }
          uint32_t ahi[4], alo[4];
          if (has_sc) {
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(xv[e], ahi[e], alo[e]);
#pragma unroll
            for (int n = 0; n < NTW; ++n)
              sh_mma3<TW>(acc_s[m][n], ahi, alo, bsh[n], bsl[n]);
          }
          if (has_ad) {
            split_tf32(sh_ln(xv[0], mur[m][0], rsr[m][0], s0, b0), ahi[0],
                       alo[0]);
            split_tf32(sh_ln(xv[1], mur[m][1], rsr[m][1], s0, b0), ahi[1],
                       alo[1]);
            split_tf32(sh_ln(xv[2], mur[m][0], rsr[m][0], s1, b1), ahi[2],
                       alo[2]);
            split_tf32(sh_ln(xv[3], mur[m][1], rsr[m][1], s1, b1), ahi[3],
                       alo[3]);
#pragma unroll
            for (int n = 0; n < NTW; ++n)
              sh_mma3<TW>(acc_a[m][n], ahi, alo, bah[n], bal[n]);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();              // the ring is free: outputs go there
      // the k-groups' partial products, added in k-group order
      for (int q = 0; q < KG; ++q) {
        if (kg == q) {
#pragma unroll
          for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int n = 0; n < NTW; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int o = (16 * m + g + 8 * (e >> 1)) * SH_LDW +
                              8 * (nt0 + n) + 2 * tg + (e & 1);
                so[o] = q == 0 ? acc_s[m][n][e] : so[o] + acc_s[m][n][e];
                ao[o] = q == 0 ? acc_a[m][n][e] : ao[o] + acc_a[m][n][e];
              }
        }
        __syncthreads();
      }
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }

    // this slice's scores, TPR threads a row: its memory logits' softmax
    // terms and its share of the scoring MLP's dot product
    if (has_sc) {
      const int r = t / TPR, q = t % TPR;
      float lg[CPT], hp = 0.0f, mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int c = q + TPR * u, n = c0 + c;
        const float v = so[r * SH_LDW + c];
        lg[u] = n < M ? v * xinv[r] * colw[c] : -INFINITY;
        mx = fmaxf(mx, lg[u]);
        if (n >= M && n < M + D2) hp += siluf_(v + colb[c]) * colw[c];
      }
      run_hp += group_sum<TPR>(hp);
      if (c0 < M) {
        mx = group_max<TPR>(mx);
        float se = 0.0f, sv = 0.0f;
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const int c = q + TPR * u;
          if (c0 + c < M) {
            const float pe = expf(lg[u] - mx);
            se += pe;
            sv += pe * colb[c];
          }
        }
        se = group_sum<TPR>(se);
        sv = group_sum<TPR>(sv);
        if (p == 0) {
          run_m = mx;
          run_se = se;
          run_sv = sv;
        } else {
          const float nm = fmaxf(run_m, mx);
          const float f0 = expf(run_m - nm), f1 = expf(mx - nm);
          run_se = run_se * f0 + se * f1;
          run_sv = run_sv * f0 + sv * f1;
          run_m = nm;
        }
      }
    }
    __syncthreads();                // so and colw are free for pass p + 1
  }

  // push the scores to every CTA of the cluster
  const int ss = min(cs, a.SCP / 64), qm = min(cs, (M + 63) / 64);
  cluster_wait();                   // every CTA has started
  {
    const int r = t / TPR, q = t % TPR;
    for (int d = q; d < cs; d += TPR) {
      if (rank < ss) cl.map_shared_rank(rmlp, d)[rank * R + r] = run_hp;
      if (rank < qm) {
        cl.map_shared_rank(rmm, d)[rank * R + r] = run_m;
        cl.map_shared_rank(rse, d)[rank * R + r] = run_se;
        cl.map_shared_rank(rsv, d)[rank * R + r] = run_sv;
      }
    }
  }
  cl.sync();        // every push has landed; nothing remote follows

  // ion: every CTA sums the same scores in the same order
  for (int r = t; r < R; r += SH_THREADS) {
    float mm = -INFINITY;
    for (int q = 0; q < qm; ++q) mm = fmaxf(mm, rmm[q * R + r]);
    float se = 0.0f, sv = 0.0f;
    for (int q = 0; q < qm; ++q) {
      const float f = expf(rmm[q * R + r] - mm);
      se += rse[q * R + r] * f;
      sv += rsv[q * R + r] * f;
    }
    const float ms = sv / se;
    float s = 0.0f;
    for (int q = 0; q < ss; ++q) s += rmlp[q * R + r];
    const float mlp = s + a.vmlp2_b[i];
    const float xv = ms * a.vcat_w[2 * i] + mlp * a.vcat_w[2 * i + 1] +
                     a.vcat_b[i];
    const float io = xv > a.thresh ? 1.0f : 0.0f;
    ionr[r] = io;
    if (rank == 0 && r0 + r < a.N) a.ion[r0 + r] = io;
  }
  __syncthreads();

  // x_new = x + g * (apx * ion) for this CTA's columns, in place
  const float* ab = a.adapt_b + (size_t)(i / 2) * D;
  for (int p = 0; p <= plast; ++p) {
    const int c0 = 64 * (rank + p * cs);
    const float* ao = ao_of(p);
    for (int e = t; e < R * 64; e += SH_THREADS) {
      const int r = e >> 6, c = e & 63, n = c0 + c, row = r0 + r;
      if (row >= a.N || n >= D) continue;
      const float xv = xval(r, n);
      const float apx = i % 2 == 0 ? ao[r * SH_LDW + c] + ab[n]
                                   : sh_ln(xv, mu[r], rstd[r], lns_at(n),
                                           lnb_at(n));
      a.xs[(size_t)row * D + n] = xv + gv[r] * (apx * ionr[r]);
    }
  }
}

// per-batch masked mean of x_new (a block per (batch, 32 channels)), then
// in the last block to finish the step's scalar control and the working
// memory's EMA (any batch: SH_MEM_GROUP rows a pass)
__global__ void __launch_bounds__(256) sheath_mem_ctl(SheathArgs a,
                                                      int step) {
  __shared__ float ps[8][32], pn[8][32];
  __shared__ float red_s[8], red_n[8];
  __shared__ float mem_v[SH_MEM_GROUP];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int i = step == 0 ? 0 : a.ctl[0];
  if (i >= a.L) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && t == 0) a.actions[step] = 0;
    return;
  }
  {
    const int b = blockIdx.x, j = blockIdx.y * 32 + lane;
    float s = 0.0f, n = 0.0f;
    if (j < a.D) {
      const float* xb = a.xs + (size_t)b * a.C * a.D + j;
      const uint8_t* vb = a.valid ? a.valid + (size_t)b * a.C : nullptr;
      for (int c = warp; c < a.C; c += 8) {
        const float m = vb ? (vb[c] ? 1.0f : 0.0f) : 1.0f;
        s += m * xb[(size_t)c * a.D];
        n += m;
      }
    }
    ps[warp][lane] = s;
    pn[warp][lane] = n;
    __syncthreads();
    if (warp == 0 && j < a.D) {
      float ss = 0.0f, nn = 0.0f;
      for (int w = 0; w < 8; ++w) {
        ss += ps[w][lane];
        nn += pn[w][lane];
      }
      a.mem[(size_t)b * a.D + j] = ss / fmaxf(nn, 1.0f);
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(a.counter, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // potential: global masked mean of ion (rows summed in a fixed order)
  float s = 0.0f, n = 0.0f;
  for (int r = t; r < a.N; r += blockDim.x) {
    const float m = a.valid ? (a.valid[r] ? 1.0f : 0.0f) : 1.0f;
    s += m * a.ion[r];
    n += m;
  }
  s = warp_sum(s);
  n = warp_sum(n);
  if (lane == 0) {
    red_s[warp] = s;
    red_n[warp] = n;
  }
  // the working memory's EMA, SH_MEM_GROUP batch rows at a time: the gate
  // per batch row, sigmoid(mem . memgate_w + b), then its rows; thread 0
  // takes the step's scalar control while the first group's rows run
  for (int g0 = 0; g0 < a.B; g0 += SH_MEM_GROUP) {
    const int nbg = min(SH_MEM_GROUP, a.B - g0);
    for (int bb = warp; bb < nbg; bb += 8) {
      float d = 0.0f;
      for (int j = lane; j < a.D; j += 32)
        d += __ldcg(a.mem + (size_t)(g0 + bb) * a.D + j) * a.memgate_w[j];
      d = warp_sum(d);
      if (lane == 0) mem_v[bb] = sigmoidf_(d + a.memgate_b[0]);
    }
    __syncthreads();
    if (g0 == 0 && t == 0) {
      float ss = 0.0f, nn = 0.0f;
      for (int w = 0; w < 8; ++w) {
        ss += red_s[w];
        nn += red_n[w];
      }
      const float potential = ss / fmaxf(nn, 1.0f);
      const bool last = i >= a.L - 1;
      const bool forced = potential < 0.1f && !last;
      const int action = last ? 0 : (forced ? 1 : a.sampled[0]);
      const int widx = min(max(action - 1, 0), 2);
      a.jump_w[0] = a.jump_s[widx];
      a.ctl[0] = action > 0 ? min(i + action + 1, a.L) : i + 1;
      a.ctl[1] = action > 0;
      a.actions[step] = action;
      if (step == 0)
        for (int c = 0; c < 3; ++c) a.jstat[c] = 0;
      a.jstat[action] += a.B;
      *a.counter = 0;               // ready for the next step
    }
    for (int e = t; e < nbg * a.D; e += blockDim.x) {
      const size_t o = (size_t)g0 * a.D + e;
      const float v = mem_v[e / a.D];
      const float prev = step == 0 ? a.mem0[e % a.D] : a.mem_w[o];
      a.mem_w[o] = v * prev + (1.0f - v) * __ldcg(a.mem + o);
    }
    __syncthreads();                // mem_v is free for the next group
  }
}

// out = x (+ the last step's jump term, when one is pending), cast to T
template <typename T>
__global__ void sheath_finish(SheathArgs a) {
  const bool pend = a.ctl[1] != 0;
  const float jw = a.jump_w[0];
  const size_t nd = (size_t)a.N * a.D;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nd;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = a.xs[e];
    if (pend) {
      const size_t r = e / a.D;
      const int j = (int)(e % a.D), b = (int)(r / a.C);
      v = v + (jw * to_f32(((const T*)a.x_in)[e]) +
               (1.0f - jw) * a.mem_w[(size_t)b * a.D + j]);
    }
    ((T*)a.out)[e] = from_f32<T>(v);
  }
}

template <typename T, int R, typename TW, bool MP, bool WIDE = false,
          bool GL = false>
static int launch_rows(const SheathArgs& a, int step, cudaStream_t st) {
  const size_t smem = GL ? sh_smem_bytes_gl(R)
                         : sh_smem_bytes(R, a.D, sh_passes(a.SCP, a.DP));
  cudaError_t e = cudaFuncSetAttribute(
      sheath_rows<T, R, TW, MP, WIDE, GL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cs = sh_cluster_size(a.SCP, a.DP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (a.N + R - 1) / R, 1);
  cfg.blockDim = dim3(SH_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sheath_rows<T, R, TW, MP, WIDE, GL>,
                                 a, step);
}

template <typename T, typename TW>
static int launch_sheath(const SheathArgs& a, int rows, cudaStream_t st) {
  const size_t nd = (size_t)a.N * a.D;
  const int ew_grid = (int)std::min<size_t>((nd + 255) / 256, 4096);
  const dim3 mem_grid(a.B, (a.D + 31) / 32);
  for (int step = 0; step < a.L; ++step) {
    const int rc = sh_gl(a.D, a.SCP, a.DP)
                       ? launch_rows<T, 16, TW, true, true, true>(a, step, st)
                   : sh_wide(a.D) ? launch_rows<T, 16, TW, true, true>(a, step,
                                                                      st)
                   : sh_passes(a.SCP, a.DP) > 1
                       ? launch_rows<T, 16, TW, true>(a, step, st)
                   : rows == 16 ? launch_rows<T, 16, TW, false>(a, step, st)
                                : launch_rows<T, 64, TW, false>(a, step, st);
    if (rc) return rc;
    sheath_mem_ctl<<<mem_grid, 256, 0, st>>>(a, step);
  }
  sheath_finish<T><<<ew_grid, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Pointers in the order of SheathArgs; weights f32 and contiguous,
// x_in/out of `dtype` (0 = f32, 1 = bf16), workspace f32/int32 (ctl 2
// ints, counter 1).  wsc (L, D, SCP) and wad ((L + 1) / 2, D, DP) hold
// the slot products' weights in (in, out) layout with zero columns up to
// SCP and DP, multiples of 64, in f32 (wdtype 0) or, when every value is
// exact in bf16, bf16 (wdtype 1); rows 16 or 64 a tile, 16 past 8
// slices (the shared memory of sh_smem_bytes must fit, or past it (GL)
// aog holds sh_aog_floats(16, passes) f32 for each CTA of the row
// launch: cluster size x row tiles).  Launches 2 L + 1 kernels.
ASR_API int asr_fused_sheath_scan(
    int dtype, const void* x_in, void* out, const void* valid,
    const void* mem0, const void* sampled, const void* jump_s,
    const void* ln_scale, const void* ln_bias, const void* gate_w,
    const void* gate_b, const void* mkinv, const void* mval,
    const void* wsc, const void* vmlp1_b, const void* vmlp2_w,
    const void* vmlp2_b, const void* vcat_w, const void* vcat_b,
    const void* wad, const void* adapt_b, const void* memgate_w,
    const void* memgate_b, void* xs, void* ion, void* mem, void* mem_w,
    void* ctl, void* counter, void* jump_w, void* actions, void* jstat,
    void* aog, int N, int B, int C, int D, int D2, int M, int L, int SCP,
    int DP, int wdtype, int rows, float thresh, void* stream) {
  if (B < 1 || M < 1 || SCP % 64 || DP % 64 ||
      (SCP % 64 == 0 && DP % 64 == 0 && sh_gl(D, SCP, DP) && !aog) ||
      SCP < M + D2 || DP < D || L < 1 || D < 1 || (rows != 16 && rows != 64) ||
      (sh_passes(SCP, DP) > 1 && rows != 16))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  SheathArgs a;
  a.x_in = x_in;
  a.out = out;
  a.valid = (const uint8_t*)valid;
  a.mem0 = (const float*)mem0;
  a.sampled = (const int*)sampled;
  a.jump_s = (const float*)jump_s;
  a.ln_scale = (const float*)ln_scale;
  a.ln_bias = (const float*)ln_bias;
  a.gate_w = (const float*)gate_w;
  a.gate_b = (const float*)gate_b;
  a.mkinv = (const float*)mkinv;
  a.mval = (const float*)mval;
  a.wsc = wsc;
  a.vmlp1_b = (const float*)vmlp1_b;
  a.vmlp2_w = (const float*)vmlp2_w;
  a.vmlp2_b = (const float*)vmlp2_b;
  a.vcat_w = (const float*)vcat_w;
  a.vcat_b = (const float*)vcat_b;
  a.wad = wad;
  a.adapt_b = (const float*)adapt_b;
  a.memgate_w = (const float*)memgate_w;
  a.memgate_b = (const float*)memgate_b;
  a.xs = (float*)xs;
  a.ion = (float*)ion;
  a.mem = (float*)mem;
  a.mem_w = (float*)mem_w;
  a.ctl = (int*)ctl;
  a.counter = (int*)counter;
  a.jump_w = (float*)jump_w;
  a.actions = (int*)actions;
  a.jstat = (int*)jstat;
  a.aog = (float*)aog;
  a.N = N;
  a.B = B;
  a.C = C;
  a.D = D;
  a.D2 = D2;
  a.M = M;
  a.L = L;
  a.SCP = SCP;
  a.DP = DP;
  a.thresh = thresh;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return wdtype == ASR_BF16 ? launch_sheath<float, bf16>(a, rows, st)
                              : launch_sheath<float, float>(a, rows, st);
  return wdtype == ASR_BF16 ? launch_sheath<bf16, bf16>(a, rows, st)
                            : launch_sheath<bf16, float>(a, rows, st);
}

// the dynamic shared memory of sheath_rows at `rows` a tile and `passes`
// passes
ASR_API int asr_sheath_smem_bytes(int rows, int D, int passes) {
  return (int)sh_smem_bytes(rows, D, passes);
}

template <int R>
static int max_clusters(int D, int cs) {
  const size_t smem = sh_smem_bytes(R, D, 1);
  cudaError_t e = cudaFuncSetAttribute(
      sheath_rows<bf16, R, bf16, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();             // not left for a later launch's check
    return -(int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1, 1);
  cfg.blockDim = dim3(SH_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, sheath_rows<bf16, R, bf16, false>,
                                     &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
}

// clusters of `cs` CTAs of sheath_rows at `rows` a tile (one pass) that
// the current device runs at once (negative: a CUDA error)
ASR_API int asr_sheath_max_clusters(int rows, int D, int cs) {
  return rows == 16 ? max_clusters<16>(D, cs) : max_clusters<64>(D, cs);
}
