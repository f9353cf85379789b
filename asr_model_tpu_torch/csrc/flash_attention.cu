// Online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/attention_kernel.py:flash_attention.
//
// out = softmax(q k^T * scale + mask) v over (B, H, Tq, hd) x (B, H, Tk,
// hd), f32 or bf16 in, f32 running max / sum / accumulator, output in
// the input dtype.  Masking follows the JAX package's plain route
// (attention._sdpa_xla): a masked logit is set to -1e30 -- it is not
// dropped -- so a row whose keys are all masked averages V uniformly;
// keys past Tk in the ragged last tile get zero weight; the causal mask
// is aligned bottom-right (key j is visible to query i when j <= i + Tk
// - Tq); kv_valid is a (B, Tk) byte mask.
//
// What bounds it: at the encoder shape (8, 4, 1001, 128) the two
// products are 4 * B * H * Tq * Tk * hd = 16.4 GFLOP on 33 MB, ~500
// operations per byte -- the tensor cores' rate; at the decode shapes
// (65 queries against up to 1001 keys) reading K and V once -- bytes.
//
// bf16 (what the model runs): flash_tc_kernel, tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; HMMA in the SASS) with
// ldmatrix and cp.async -- not wgmma and TMA, which would need
// cuTensorMapEncodeTiled (-lcuda) and a warp-specialised pipeline.  A block
// is 4 warps (64 query rows) or, when Tq is 65..80, 5 warps (80 rows:
// the decode width 65 in one tile), each warp owning 16 rows.  Q is read
// once from device memory straight into A fragments in registers; 64-key
// tiles of K and V come in through cp.async into a ring of 3 stages (4
// for the 5-warp blocks), the next tiles' copies in flight while one is
// multiplied, one barrier a tile.  S = Q K^T leaves the accumulator as
// f32, is scaled by scale * log2(e) and masked, the running max and sum
// stay in f32 registers (exp2f), and P is rounded to bf16 in registers,
// straight into the A fragments of O += P V (V is read with
// ldmatrix.trans); the row sum takes the f32 P, as the Pallas kernel
// does (p.astype(v.dtype) only for the product).  Shared rows are padded
// by 16 bytes so ldmatrix reads are free of bank conflicts; the head dim
// is zero-padded to 64, 128 or 256 (exact; 256 takes 64-row tiles only,
// one block an SM by its 203 KB ring).  No register cap: 220 registers
// and no spills fit two 4-warp blocks an SM, which measured faster than
// three blocks at a 168-register cap with spills.  Causal key tiles
// wholly above the diagonal are skipped unless a row of the query tile is
// fully masked (then every key counts, as the -1e30 rule says).
// Decode shapes give too few (batch * head, query tile) blocks for 132
// SMs, so the wrapper may split the keys over `nsplit` blocks: each
// writes its unnormalised O, max and sum to a workspace, and the last
// block of a tile to finish (a counter, after __threadfence) merges
// them in the same launch -- one launch per call either way.  (A
// thread-block cluster merging over distributed shared memory measured
// slower at the decode width 65: four one-per-SM blocks a cluster do not
// all fit in one wave of the GPCs.)
//
// Head widths past 256 (both dtypes): flash_wide_kernel, the CUDA cores
// with 64 query rows (16 past hd 512) and 16 keys a tile, a thread 4 rows
// (1) and a key of the tile, and hd / 16 output channels of each of its
// rows in registers (NJ 24 .. 64: up to hd 1024), K and V a 16-key tile
// at a time in shared memory (201 KB at hd 512); in bf16 P is rounded for
// the PV product as above; causal key tiles past a block's last row are
// skipped unless a row of it sees no valid key.  One launch.
// Past hd 1024 (either dtype): global_attn.cuh, three launches through an
// f32 score matrix in device memory (asr_flash_attention_global).
// f32: flash_fwd_kernel keeps the CUDA cores.  TF32 would keep about
// three digits, and the f32 route is held at 1e-4 (kernel tests) and at
// 6e-5 of the largest logit (the first decode step), so the products
// stay in full f32: one block per (b * h, 64-query tile) looping over
// 32-key tiles, 4 rows x 8 channels of the output per thread.
#include "mma.cuh"
#include "global_attn.cuh"

constexpr int FA_BQ = 64;   // query rows per block
constexpr int FA_BK = 32;   // keys per tile (f32)
constexpr int FA_HD = 256;  // largest head dim
constexpr float FA_MASKED = -1e30f;

// NJ: output channels a thread holds (tx + 16 j): 8 up to hd 128, 16 up
// to 256
template <typename T, int NJ>
__global__ void __launch_bounds__(256)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ kv_valid,
                 T* __restrict__ out, int H, int Tq, int Tk, int hd,
                 float scale, int causal) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;                  // padded row: no bank conflicts
  float* qs = smem;                        // [BQ][hdp]
  float* ks = qs + FA_BQ * hdp;            // [BK][hdp]
  float* vs = ks + FA_BK * hdp;            // [BK][hd]
  float* ps = vs + FA_BK * hd;             // [BQ][BK + 1]

  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * FA_BQ;
  const size_t qbase = (size_t)bh * Tq * hd;
  const size_t kbase = (size_t)bh * Tk * hd;
  const uint8_t* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;

  for (int e = t; e < FA_BQ * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    qs[r * hdp + d] =
        (q0 + r < Tq) ? to_f32(q[qbase + (size_t)(q0 + r) * hd + d]) : 0.0f;
  }

  float acc[4][NJ];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  const int shift = Tk - Tq;  // bottom-right causal alignment

  for (int k0 = 0; k0 < Tk; k0 += FA_BK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    for (int e = t; e < FA_BK * hd; e += blockDim.x) {
      const int r = e / hd, d = e % hd;
      const bool in = k0 + r < Tk;
      const size_t off = kbase + (size_t)(k0 + r) * hd + d;
      ks[r * hdp + d] = in ? to_f32(k[off]) : 0.0f;
      vs[r * hd + d] = in ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float k0v = ks[tx * hdp + d];
      const float k1v = ks[(tx + 16) * hdp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty + 16 * i) * hdp + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= Tk) {
          s[i][j] = -INFINITY;  // past the end: no weight at all
        } else {
          bool masked = causal && kj > qi + shift;
          if (valid && !valid[kj]) masked = true;
          s[i][j] = masked ? FA_MASKED : s[i][j] * scale;
        }
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m_run[i], rmax);  // finite: key k0 exists
      const float alpha = expf(m_run[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * (FA_BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l_run[i] = l_run[i] * alpha + rsum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kmax = min(FA_BK, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < hd ? vs[c * hd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (FA_BK + 1) + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const float inv = 1.0f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd)
        out[qbase + (size_t)qi * hd + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------
// head widths past FA_HD, either dtype (the design at the top)
constexpr int FA_WK = 16;        // keys a tile
constexpr int FA_WIDE_HD = 1024; // the widest head
constexpr int FA_WIDE_RI4 = 512; // 4 rows a thread up to this width

// query rows a block: 16 RI (RI rows a thread)
__host__ __device__ constexpr int fa_wide_ri(int hd) {
  return hd <= FA_WIDE_RI4 ? 4 : 1;
}
__host__ __device__ constexpr size_t fa_wide_smem(int hd) {
  return sizeof(float) *
         ((size_t)(16 * fa_wide_ri(hd) + FA_WK) * (hd + 1) + FA_WK * hd +
          16 * fa_wide_ri(hd) * (FA_WK + 1));
}

// rows [0, rows) of a (., hd) head slice into dst (row stride ld) as f32,
// zero past `valid` rows; 16-byte loads when `vec` (hd % 8 == 0 and the
// slice 16-byte aligned)
template <typename T>
__device__ __forceinline__ void fa_stage(const T* __restrict__ src, int rows,
                                         int valid, int hd, float* dst,
                                         int ld, bool vec) {
  if (vec) {
    constexpr int EPV = 16 / sizeof(T);
    const int per = hd / EPV;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, d = (e - r * per) * EPV;
      float* o = dst + r * ld + d;
      if (r < valid) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * hd +
                                                        d);
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < EPV; ++i) o[i] = to_f32(v[i]);
      } else {
#pragma unroll
        for (int i = 0; i < EPV; ++i) o[i] = 0.0f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      dst[r * ld + d] = r < valid ? to_f32(src[(size_t)r * hd + d]) : 0.0f;
    }
  }
}

// RI rows a thread (rows ty + 16 i), 16 keys a tile (key tx), NJ output
// channels (tx + 16 j) of each row in registers
template <typename T, int NJ, int RI>
__global__ void __launch_bounds__(256)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v,
                  const uint8_t* __restrict__ kv_valid, T* __restrict__ out,
                  int H, int Tq, int Tk, int hd, float scale, int causal,
                  int vec) {
  extern __shared__ float smem[];
  constexpr int WQ = 16 * RI;
  const int hdp = hd + 1;
  float* qs = smem;                        // [WQ][hdp]
  float* ks = qs + WQ * hdp;               // [WK][hdp]
  float* vs = ks + FA_WK * hdp;            // [WK][hd]
  float* ps = vs + FA_WK * hd;             // [WQ][WK + 1]
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * WQ;
  const size_t qbase = (size_t)bh * Tq * hd, kbase = (size_t)bh * Tk * hd;
  const uint8_t* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;
  fa_stage(q + qbase + (size_t)q0 * hd, WQ, Tq - q0, hd, qs, hdp, vec != 0);
  float acc[RI][NJ], m_run[RI], l_run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  const int shift = Tk - Tq;
  // causal: keys past the last row's diagonal weigh exactly 0 for every
  // row that sees a valid key, so they are skipped when the first row
  // (and so every row) does; a fully masked row keeps them all (-1e30)
  int kend = Tk;
  if (causal) {
    __shared__ int first_valid;
    if (t == 0) first_valid = Tk;
    __syncthreads();
    if (valid) {
      for (int j = t; j < Tk; j += blockDim.x)
        if (valid[j]) {
          atomicMin(&first_valid, j);
          break;
        }
    } else if (t == 0) {
      first_valid = 0;
    }
    __syncthreads();
    if (q0 + shift >= first_valid)
      kend = min(Tk, min(q0 + WQ, Tq) - 1 + shift + 1);
  }
  for (int k0 = 0; k0 < kend; k0 += FA_WK) {
    __syncthreads();                       // the last tile is consumed
    fa_stage(k + kbase + (size_t)k0 * hd, FA_WK, Tk - k0, hd, ks, hdp,
             vec != 0);
    fa_stage(v + kbase + (size_t)k0 * hd, FA_WK, Tk - k0, hd, vs, hd,
             vec != 0);
    __syncthreads();
    float s[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) s[i] = 0.0f;
    const float* kr = ks + tx * hdp;
    for (int d = 0; d < hd; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        s[i] = fmaf(qs[(ty + 16 * i) * hdp + d], kv, s[i]);
    }
    const int kj = k0 + tx;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (kj >= Tk) {
        s[i] = -INFINITY;                  // past the end: no weight at all
      } else {
        bool masked = causal && kj > qi + shift;
        if (valid && !valid[kj]) masked = true;
        s[i] = masked ? FA_MASKED : s[i] * scale;
      }
      float rmax = s[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m_run[i], rmax);  // finite: key k0 exists
      const float alpha = expf(m_run[i] - m_new);
      const float p = s[i] == -INFINITY ? 0.0f : expf(s[i] - m_new);
      float rsum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l_run[i] = l_run[i] * alpha + rsum;
      m_run[i] = m_new;
      // P as the product takes it (bf16 rounds it, f32 keeps it)
      ps[(ty + 16 * i) * (FA_WK + 1) + tx] = to_f32(from_f32<T>(p));
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                          // a row's P: its 16 lanes
    const int kmax = min(FA_WK, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      float pc[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pc[i] = ps[(ty + 16 * i) * (FA_WK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? vs[c * hd + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pc[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const float inv = 1.0f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd)
        out[qbase + (size_t)qi * hd + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ, int RI>
static int launch_flash_wide(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* out, int B, int H,
                             int Tq, int Tk, int hd, float scale, int causal,
                             cudaStream_t st) {
  const size_t smem = fa_wide_smem(hd);
  cudaFuncSetAttribute(flash_wide_kernel<T, NJ, RI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int vec = hd % (16 / sizeof(T)) == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid((Tq + 16 * RI - 1) / (16 * RI), B * H);
  flash_wide_kernel<T, NJ, RI><<<grid, 256, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kv_valid,
      (T*)out, H, Tq, Tk, hd, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_flash_wide_hd(const void* q, const void* k, const void* v,
                                const void* kv_valid, void* out, int B,
                                int H, int Tq, int Tk, int hd, float scale,
                                int causal, cudaStream_t st) {
#define FA_W(nj, ri)                                                        \
  return launch_flash_wide<T, nj, ri>(q, k, v, kv_valid, out, B, H, Tq, Tk, \
                                      hd, scale, causal, st)
  if (hd <= 384) FA_W(24, 4);
  if (hd <= 512) FA_W(32, 4);
  if (hd <= 768) FA_W(48, 1);
  FA_W(64, 1);
#undef FA_W
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
constexpr int TC_BK = 64;        // keys per tile
constexpr int TC_MAX_SPLIT = 16;

// warps a block (16 query rows each): 5 when Tq is 65..80, the decode
// width 65 in one query tile; else 4 (64-row tiles).  On the H100 the
// 80-row tile read 0.0187 ms at the width-65 cached cross against 0.024
// for two 64-row tiles (asr_model_tpu_torch/bench_flash.py)
__host__ __device__ constexpr int tc_warps(int Tq) {
  return Tq > 64 && Tq <= 80 ? 5 : 4;
}

// K/V ring stages: 3 for 4-warp blocks (two blocks an SM), 4 for the
// 5-warp decode blocks (one an SM, so more tiles in flight each; 5
// stages measured slower on the H100)
__host__ __device__ constexpr int tc_stages(int warps) {
  return warps == 5 ? 4 : 3;
}

__host__ __device__ constexpr int tc_lds(int hdp) { return hdp + 8; }

__host__ __device__ constexpr size_t tc_smem_bytes(int hdp, int stages) {
  // a K and a V tile (bf16, padded rows) and a key-state tile a stage
  return (sizeof(bf16) * 2 * TC_BK * tc_lds(hdp) + TC_BK) * stages;
}

// rows [0, 64) x channels [0, HDP) of a (rows_valid, hd) bf16 tile into
// shared memory (row stride tc_lds(HDP)), zero past rows_valid and hd.
// `vec`: hd % 8 == 0 and 16-byte aligned rows, so 16-byte async copies.
template <int HDP, int NT>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int rows_valid, int hd,
                                             bool vec) {
  constexpr int CH = HDP / 8, LDS = tc_lds(HDP);
  for (int e = threadIdx.x; e < TC_BK * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    bf16* d = dst + r * LDS + c * 8;
    if (vec) {
      const bool in = r < rows_valid && c * 8 < hd;
      cp_async16(d, in ? src + (size_t)r * hd + c * 8 : src, in);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c * 8 + i;
        d[i] = (r < rows_valid && col < hd) ? src[(size_t)r * hd + col]
                                            : __float2bfloat16(0.0f);
      }
    }
  }
}

// channels d and d + 1 of a bf16 Q row packed as one register of an A
// fragment, zero for a row past Tq (`live` false) and past hd; `vec`: one
// 4-byte load
__device__ __forceinline__ uint32_t tc_q_pair(const bf16* qrow, bool live,
                                              int d, int hd, bool vec) {
  if (!live || d >= hd) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(qrow + d);
  const bf16 hi = d + 1 < hd ? qrow[d + 1] : __float2bfloat16(0.0f);
  __nv_bfloat162 h;
  h.x = qrow[d];
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// key states of a tile: 1 visible, 0 masked by kv_valid, 2 past Tk
__device__ __forceinline__ void tc_load_state(uint8_t* dst,
                                              const uint8_t* valid, int k0,
                                              int Tk) {
  const int t = threadIdx.x;
  if (t < TC_BK) {
    const int key = k0 + t;
    dst[t] = key >= Tk ? 2 : (valid && !valid[key]) ? 0 : 1;
  }
}

template <int HDP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, WARPS == 4 ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v,
                const uint8_t* __restrict__ kv_valid, bf16* __restrict__ out,
                float* __restrict__ part_o, float* __restrict__ part_ml,
                int* __restrict__ counters, int H, int Tq, int Tk, int hd,
                float scale_log2, int causal, int nsplit, int vec) {
  constexpr int LDS = tc_lds(HDP), NKK = HDP / 16, NDT = HDP / 8;
  constexpr int BQ = 16 * WARPS, NT = 32 * WARPS, NS = tc_stages(WARPS);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* ks = reinterpret_cast<bf16*>(fa_smem);   // [NS][64][LDS]
  bf16* vs = ks + NS * TC_BK * LDS;              // [NS][64][LDS]
  uint8_t* st = reinterpret_cast<uint8_t*>(vs + NS * TC_BK * LDS);  // [NS][64]
  __shared__ int s_red[WARPS];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int split = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H;
  const int q0 = qt * BQ;
  const int shift = Tk - Tq;  // bottom-right causal alignment
  const bf16* qb = q + (size_t)bh * Tq * hd;
  const bf16* kb = k + (size_t)bh * Tk * hd;
  const bf16* vb = v + (size_t)bh * Tk * hd;
  const uint8_t* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;
  const int nkt = (Tk + TC_BK - 1) / TC_BK;

  // the key tiles this query tile needs
  int kt_end = nkt;
  if (causal) {
    int fv = 0;  // first visible key of the batch row
    if (valid) {
      int m = Tk;
      for (int j = tid; j < Tk; j += NT)
        if (valid[j]) { m = j; break; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) s_red[warp] = m;
      __syncthreads();
      fv = s_red[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) fv = min(fv, s_red[w]);
    }
    // rows q0.. all see key fv: keys past the last row's diagonal carry
    // exactly zero weight and their tiles can be skipped
    if (fv <= q0 + shift) {
      const int q_last = min(q0 + BQ - 1, Tq - 1);
      kt_end = min(nkt, (q_last + shift) / TC_BK + 1);
    }
  }
  const int per = (kt_end + nsplit - 1) / nsplit;
  const int kt0 = split * per, kt1 = min(kt_end, kt0 + per);

  // the ring: tile kt0 + i goes to stage i % NS, one commit group each
  auto load_stage = [&](int it) {
    const int k0 = it * TC_BK, sg = (it - kt0) % NS;
    if (it < kt1) {
      tc_load_tile<HDP, NT>(ks + sg * TC_BK * LDS, kb + (size_t)k0 * hd,
                            Tk - k0, hd, vec);
      tc_load_tile<HDP, NT>(vs + sg * TC_BK * LDS, vb + (size_t)k0 * hd,
                            Tk - k0, hd, vec);
      tc_load_state(st + sg * TC_BK, valid, k0, Tk);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) load_stage(kt0 + i);

  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;  // rows of c[0..1]; c[2..3]: + 8
  // Q as A fragments, read once from device memory while the first K/V
  // tile is in flight
  uint32_t qf[NKK][4];
  {
    const bf16* r0p = qb + (size_t)row0 * hd;
    const bf16* r1p = r0p + 8 * (size_t)hd;
    const bool l0 = row0 < Tq, l1 = row0 + 8 < Tq;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      const int d = kk * 16 + 2 * tg;
      qf[kk][0] = tc_q_pair(r0p, l0, d, hd, vec);
      qf[kk][1] = tc_q_pair(r1p, l1, d, hd, vec);
      qf[kk][2] = tc_q_pair(r0p, l0, d + 8, hd, vec);
      qf[kk][3] = tc_q_pair(r1p, l1, d + 8, hd, vec);
    }
  }

  for (int it = kt0; it < kt1; ++it) {
    const int buf = (it - kt0) % NS;
    cp_async_wait<NS - 2>();  // this tile has landed
    __syncthreads();          // ... for every thread; the last stage is free
    load_stage(it + NS - 1);  // streams in while this tile runs
    if (q0 + warp * 16 < Tq) {  // a warp past Tq only helps copy
      // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
      const bf16* kt = ks + buf * TC_BK * LDS;
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldsm_x4(r, kt + (np * 16 + (lm >> 1) * 8 + lr) * LDS + kk * 16 +
                         (lm & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }

      // scale to log2 units and mask: -1e30 masked, -inf past Tk
      const int k0 = it * TC_BK;
      const uint8_t* kst = st + buf * TC_BK;
      const bool need_mask = causal || valid || k0 + TC_BK > Tk;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale_log2;
          if (need_mask) {
            const int kc = nt * 8 + 2 * tg + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            const uint8_t ks_ = kst[kc];
            if (ks_ == 2)
              x = -INFINITY;
            else if (ks_ == 0 || (causal && k0 + kc > row + shift))
              x = FA_MASKED;
          }
          s[nt][e] = x;
        }

      // online softmax over the two rows this thread holds
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[hr], mx);  // finite: key k0 exists
        const float alpha = exp2f(m_r[hr] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[nt][2 * hr + c] - m_new);
            s[nt][2 * hr + c] = p;
            sum += p;
          }
        l_r[hr] = l_r[hr] * alpha + sum;  // this thread's columns only
        m_r[hr] = m_new;
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          o[dt][2 * hr] *= alpha;
          o[dt][2 * hr + 1] *= alpha;
        }
      }

      // O += P V, P rounded to bf16 in the A fragments
      const bf16* vt = vs + buf * TC_BK * LDS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < NKK; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, vt + (kk * 16 + (lm & 1) * 8 + lr) * LDS + dp * 16 +
                           (lm >> 1) * 8);
          mma_bf16(o[2 * dp], a, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], a, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 1);
    l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 2);
  }

  if (nsplit == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= Tq) continue;
      const float inv = 1.0f / fmaxf(l_r[hr], 1e-30f);
      bf16* orow = out + ((size_t)bh * Tq + row) * hd;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        const int d = dt * 8 + 2 * tg;
        if (d < hd) orow[d] = __float2bfloat16(o[dt][2 * hr] * inv);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(o[dt][2 * hr + 1] * inv);
      }
    }
    return;
  }

  // split keys: write this block's unnormalised partial, then the last
  // block of the (b * h, query tile) to finish merges every split
  const size_t tile = (size_t)bh * gridDim.y + qt;
  const size_t slot = tile * nsplit + split;
  float* po = part_o + slot * BQ * HDP;
  float* pml = part_ml + slot * BQ * 2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = warp * 16 + g + 8 * hr;
    if (q0 + r >= Tq) continue;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int d = dt * 8 + 2 * tg;
      if (d < hd)
        *reinterpret_cast<float2*>(po + r * HDP + d) =
            make_float2(o[dt][2 * hr], o[dt][2 * hr + 1]);
    }
    if (tg == 0) {
      pml[2 * r] = m_r[hr];
      pml[2 * r + 1] = l_r[hr];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[tile], 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int rows = min(BQ, Tq - q0);
  const float* po0 = part_o + tile * nsplit * BQ * HDP;
  const float* pml0 = part_ml + tile * nsplit * BQ * 2;
  float* coef = reinterpret_cast<float*>(fa_smem);  // [nsplit][BQ]
  if (tid < rows) {
    float mv[TC_MAX_SPLIT], lv[TC_MAX_SPLIT];
    float mx = -INFINITY;
#pragma unroll
    for (int sp = 0; sp < TC_MAX_SPLIT; ++sp)
      if (sp < nsplit) {
        mv[sp] = __ldcg(pml0 + (sp * BQ + tid) * 2);
        lv[sp] = __ldcg(pml0 + (sp * BQ + tid) * 2 + 1);
        mx = fmaxf(mx, mv[sp]);
      }
    float lsum = 0.0f;
#pragma unroll
    for (int sp = 0; sp < TC_MAX_SPLIT; ++sp)
      if (sp < nsplit) {
        mv[sp] = exp2f(mv[sp] - mx);
        lsum += mv[sp] * lv[sp];
      }
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int sp = 0; sp < TC_MAX_SPLIT; ++sp)
      if (sp < nsplit) coef[sp * BQ + tid] = mv[sp] * inv;
  }
  __syncthreads();
  // each thread owns PER float4s of the tile; one split's loads are all
  // in flight together
  constexpr int C4 = HDP / 4, PER = (BQ * C4 + NT - 1) / NT;
  float4 acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int sp = 0; sp < nsplit; ++sp) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * NT, r = e / C4, d = (e % C4) * 4;
      if (r < rows && d < hd) {
        const float c = coef[sp * BQ + r];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            po0 + ((size_t)sp * BQ + r) * HDP + d));
        acc[i].x = fmaf(c, x.x, acc[i].x);
        acc[i].y = fmaf(c, x.y, acc[i].y);
        acc[i].z = fmaf(c, x.z, acc[i].z);
        acc[i].w = fmaf(c, x.w, acc[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / C4, d = (e % C4) * 4;
    if (r >= rows || d >= hd) continue;
    bf16* orow = out + ((size_t)bh * Tq + q0 + r) * hd + d;
    const float a4[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (d + j < hd) orow[j] = __float2bfloat16(a4[j]);
  }
  if (tid == 0) counters[tile] = 0;  // ready for the next call
}

template <typename T, int NJ>
static int launch_flash_f32(const void* q, const void* k, const void* v,
                            const void* kv_valid, void* out, int B, int H,
                            int Tq, int Tk, int hd, float scale, int causal,
                            cudaStream_t st) {
  const int hdp = hd + 1;
  const size_t smem = sizeof(float) * ((FA_BQ + FA_BK) * hdp + FA_BK * hd +
                                       FA_BQ * (FA_BK + 1));
  cudaFuncSetAttribute(flash_fwd_kernel<T, NJ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * H);
  flash_fwd_kernel<T, NJ><<<grid, 256, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kv_valid,
      (T*)out, H, Tq, Tk, hd, scale, causal);
  return (int)cudaGetLastError();
}

template <int HDP, int WARPS>
static int launch_flash_tc(const void* q, const void* k, const void* v,
                           const void* kv_valid, void* out, void* part_o,
                           void* part_ml, void* counters, int B, int H,
                           int Tq, int Tk, int hd, float scale, int causal,
                           int nsplit, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(HDP, tc_stages(WARPS));
  cudaFuncSetAttribute(flash_tc_kernel<HDP, WARPS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const bool vec = hd % 8 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                   (uintptr_t)v) % 16 == 0;
  const dim3 grid(nsplit, (Tq + 16 * WARPS - 1) / (16 * WARPS), B * H);
  flash_tc_kernel<HDP, WARPS><<<grid, 32 * WARPS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const uint8_t*)kv_valid, (bf16*)out, (float*)part_o, (float*)part_ml,
      (int*)counters, H, Tq, Tk, hd, scale * 1.4426950408889634f, causal,
      nsplit, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// q: (B, H, Tq, hd); k, v: (B, H, Tk, hd); out like q; kv_valid: (B, Tk)
// bytes or null.  hd <= 1024 (past 256 flash_wide_kernel, either dtype,
// nsplit ignored), Tk >= 1.  dtype 0 = f32, 1 = bf16.
// bf16 only: nsplit (1..16) blocks share each (b * h, query tile)'s keys,
// the query tile bq = 16 * tc_warps(Tq) rows (64 past hd 128); with
// nsplit > 1, part_o holds B*H*ceil(Tq/bq)*nsplit*bq*hdp f32 (hdp = 64
// for hd <= 64, 128 for hd <= 128, else 256), part_ml B*H*ceil(Tq/bq)*nsplit*bq*2 f32, and counters
// B*H*ceil(Tq/bq) ints that are zero on entry (the kernel leaves them
// zero; calls that share counters must run in order, on one stream).
ASR_API int asr_flash_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* kv_valid,
                                void* out, void* part_o, void* part_ml,
                                void* counters, int B, int H, int Tq, int Tk,
                                int hd, float scale, int causal, int nsplit,
                                void* stream) {
  if (hd > FA_WIDE_HD || hd < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Tq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd > FA_HD)
    return dtype == ASR_F32
               ? launch_flash_wide_hd<float>(q, k, v, kv_valid, out, B, H,
                                             Tq, Tk, hd, scale, causal, st)
               : launch_flash_wide_hd<bf16>(q, k, v, kv_valid, out, B, H, Tq,
                                            Tk, hd, scale, causal, st);
  if (dtype == ASR_F32)
    return hd <= 128 ? launch_flash_f32<float, 8>(q, k, v, kv_valid, out, B,
                                                  H, Tq, Tk, hd, scale,
                                                  causal, st)
                     : launch_flash_f32<float, 16>(q, k, v, kv_valid, out,
                                                   B, H, Tq, Tk, hd, scale,
                                                   causal, st);
  if (nsplit < 1 || nsplit > TC_MAX_SPLIT ||
      (nsplit > 1 && (!part_o || !part_ml || !counters)))
    return (int)cudaErrorInvalidValue;
#define FA_TC(hdp, w)                                                      \
  return launch_flash_tc<hdp, w>(q, k, v, kv_valid, out, part_o, part_ml,  \
                                 counters, B, H, Tq, Tk, hd, scale, causal, \
                                 nsplit, st)
  if (hd > 128) FA_TC(256, 4);
  if (tc_warps(Tq) == 5) {
    if (hd <= 64) FA_TC(64, 5);
    FA_TC(128, 5);
  }
  if (hd <= 64) FA_TC(64, 4);
  FA_TC(128, 4);
#undef FA_TC
}

// Head widths past FA_WIDE_HD, either dtype: scores, softmax and P v as
// three launches (global_attn.cuh) through `scores`, B H Tq Tk f32 of
// device memory.  q, k, v, out and kv_valid as asr_flash_attention's;
// B H <= 65535.
ASR_API int asr_flash_attention_global(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* kv_valid, void* out,
                                       void* scores, int B, int H, int Tq,
                                       int Tk, int hd, float scale,
                                       int causal, void* stream) {
  if (hd < 1 || Tk < 1 || !scores || (long)B * H > 65535 ||
      (Tq + GL_T - 1) / GL_T > 65535)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Tq == 0) return 0;
  const GlStrides qs{(long)H * Tq * hd, (long)Tq * hd, hd};
  const GlStrides ks{(long)H * Tk * hd, (long)Tk * hd, hd};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == ASR_F32
                   ? gl_attention<float>(q, qs, k, ks, v, ks, kv_valid, out,
                                         qs, (float*)scores, B, H, Tq, Tk,
                                         hd, scale, causal, st)
                   : gl_attention<bf16>(q, qs, k, ks, v, ks, kv_valid, out,
                                        qs, (float*)scores, B, H, Tq, Tk, hd,
                                        scale, causal, st));
}
