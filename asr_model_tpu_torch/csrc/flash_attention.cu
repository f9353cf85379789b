// Online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/attention_kernel.py:flash_attention.
//
// out = softmax(q k^T * scale + mask) v over (B, H, Tq, hd) x (B, H, Tk,
// hd), f32 or bf16 in, f32 running max / sum / accumulator, output in
// the input dtype.  Masking follows the JAX package's plain route
// (attention._sdpa_xla): a masked logit is set to -1e30 -- it is not
// dropped -- so a row whose keys are all masked averages V uniformly;
// the causal mask is aligned bottom-right (key j is visible to query i
// when j <= i + Tk - Tq); kv_valid is a (B, Tk) byte mask.
//
// What bounds it: at the encoder shape (8, 4, 1001, 128) the two
// products are 4 * B * H * Tq * Tk * hd = 16.4 GFLOP on 33 MB, i.e. ~500
// operations per byte -- operations.  Design: one block per (b * h,
// 64-query tile), looping over 32-key tiles in the block (the TPU's
// sequential KV grid axis and its VMEM carry become a loop and
// registers); Q stays in shared memory, K and V tiles are staged as f32,
// each thread keeps 4 query rows x 8 channels of the output in
// registers, and the 16 threads sharing a row reduce its max and sum
// with warp shuffles.  The products run on the CUDA cores in f32; moving
// them to tensor cores (wgmma) is the next step for this kernel.
#include "common.cuh"

constexpr int FA_BQ = 64;   // query rows per block
constexpr int FA_BK = 32;   // keys per tile
constexpr int FA_HD = 128;  // largest head dim
constexpr float FA_MASKED = -1e30f;

template <typename T>
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

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
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
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kmax = min(FA_BK, Tk - k0);
    for (int c = 0; c < kmax; ++c) {
      float vv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < hd ? vs[c * hd + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (FA_BK + 1) + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Tq) continue;
    const float inv = 1.0f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < hd)
        out[qbase + (size_t)qi * hd + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
static int launch_flash(const void* q, const void* k, const void* v,
                        const void* kv_valid, void* out, int B, int H, int Tq,
                        int Tk, int hd, float scale, int causal,
                        cudaStream_t st) {
  const int hdp = hd + 1;
  const size_t smem = sizeof(float) * ((FA_BQ + FA_BK) * hdp + FA_BK * hd +
                                       FA_BQ * (FA_BK + 1));
  cudaFuncSetAttribute(flash_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * H);
  flash_fwd_kernel<T><<<grid, 256, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kv_valid,
      (T*)out, H, Tq, Tk, hd, scale, causal);
  return (int)cudaGetLastError();
}

// q: (B, H, Tq, hd); k, v: (B, H, Tk, hd); out like q; kv_valid: (B, Tk)
// bytes or null.  hd <= 128, Tk >= 1.  dtype 0 = f32, 1 = bf16.
ASR_API int asr_flash_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* kv_valid,
                                void* out, int B, int H, int Tq, int Tk,
                                int hd, float scale, int causal,
                                void* stream) {
  if (hd > FA_HD || hd < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Tq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32)
    return launch_flash<float>(q, k, v, kv_valid, out, B, H, Tq, Tk, hd,
                               scale, causal, st);
  return launch_flash<__nv_bfloat16>(q, k, v, kv_valid, out, B, H, Tq, Tk,
                                     hd, scale, causal, st);
}
