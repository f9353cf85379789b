// DIO's contour fix: the CUDA kernel behind ops/cuda/dio.py:dio_contour.
//
// Replaces the XLA lax.scan pair of asr_model_tpu/ops/dio.py:_fix_contour
// (the JAX package has no Pallas kernel for it; native/world.cpp:270-323
// is the C++ original).  Per utterance, over nf frames and nb band
// candidates a frame:
//   1. a frame whose f0 jumps by more than `allowed` (relative) from its
//      left neighbour's original value is unvoiced;
//   2. voiced runs shorter than `vrm` frames are dropped;
//   3. forward: an unvoiced frame right after a voiced one (or after an
//      extended one) takes the band candidate nearest the running
//      reference, if within `allowed` of it; the reference follows;
//   4. the same backward; where both extend a frame the backward value
//      wins (the C++ section order).
// Steps 3-4 are serial recurrences: each frame's choice depends on the
// reference the previous frame left.  Nothing bounds them but latency:
// the bytes are (nb + 2) * nf floats an utterance (tens of KB) and the
// operations a few per candidate.  One CTA an utterance computes steps
// 1-2 with all its threads (step 1 into `out`, step 2 into a workspace
// row), runs the forward scan on thread 0 into `out` and the backward
// scan on thread 32 into the second workspace row (another warp, so the
// two issue independently), and merges with all its threads.  The
// candidates are read from device memory: a scan walks each band's row
// in order, so all but one load in 32 hits L1.  Every value is a
// compare and a select of the inputs or one IEEE division, so the
// result equals the plain version's exactly.

#include "common.cuh"

constexpr int DC_THREADS = 128;

__device__ __forceinline__ float dc_near(const float* __restrict__ cand,
                                         int nb, int nf, int i, float ref,
                                         float allowed) {
  // the band candidate of least |v - ref| / ref among v > 0 (the first
  // on a tie), kept when that error is under `allowed`
  const float r = fmaxf(ref, 1e-9f);
  float best_err = INFINITY, best_v = 0.0f;
  for (int k = 0; k < nb; ++k) {
    const float v = cand[(size_t)k * nf + i];
    const float err = v > 0.0f ? fabsf(v - r) / r : INFINITY;
    if (k == 0 || err < best_err) {
      best_err = err;
      best_v = v;
    }
  }
  return best_err < allowed ? best_v : 0.0f;
}

__global__ void __launch_bounds__(DC_THREADS)
dio_contour_kernel(const float* __restrict__ cand, const float* __restrict__ f0,
                   float* __restrict__ out, float* __restrict__ work, int nb,
                   int nf, int vrm, float allowed) {
  const int b = blockIdx.x;
  const float* c = cand + (size_t)b * nb * nf;
  const float* f = f0 + (size_t)b * nf;
  float* o = out + (size_t)b * nf;
  float* s2 = work + (size_t)b * 2 * nf;
  float* bw = s2 + nf;

  // 1: jumps against the original left neighbour, into out
  for (int i = threadIdx.x; i < nf; i += DC_THREADS) {
    const float v = f[i], p = f[i > 0 ? i - 1 : 0];
    const float jump = fabsf(v - p) / (v > 0.0f ? v : 1.0f);
    o[i] = (v > 0.0f && p > 0.0f && jump > allowed) ? 0.0f : v;
  }
  __syncthreads();
  // 2: a voiced frame stays when its run holds at least vrm frames
  for (int i = threadIdx.x; i < nf; i += DC_THREADS) {
    const float v = o[i];
    float r = 0.0f;
    if (v > 0.0f) {
      int len = 1;
      for (int j = i - 1; j >= 0 && len < vrm && o[j] > 0.0f; --j) ++len;
      for (int j = i + 1; j < nf && len < vrm && o[j] > 0.0f; ++j) ++len;
      r = len >= vrm ? v : 0.0f;
    }
    s2[i] = r;
  }
  __syncthreads();
  // 3-4: the forward scan into out, the backward scan into bw
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    const bool fwd = threadIdx.x == 0;
    float* dst = fwd ? o : bw;
    float ref = 0.0f;
    bool active = false;
    float v2_next = s2[fwd ? 0 : nf - 1];
    for (int s = 0; s < nf; ++s) {
      const int i = fwd ? s : nf - 1 - s;
      const float v2 = v2_next;
      // the next frame's value, loaded while this frame is worked on
      v2_next = s2[fwd ? min(s + 1, nf - 1) : max(nf - 2 - s, 0)];
      float val;
      if (v2 > 0.0f) {
        val = v2;
        ref = v2;
        active = true;
      } else {
        const float cv = dc_near(c, nb, nf, i, ref, allowed);
        const bool extend = active && cv > 0.0f;
        val = extend ? cv : 0.0f;
        ref = extend ? cv : ref;
        active = extend;
      }
      dst[i] = val;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nf; i += DC_THREADS) {
    const float v = s2[i], vb = bw[i];
    o[i] = v > 0.0f ? v : (vb > 0.0f ? vb : o[i]);
  }
}

// `work` holds 2 * nf floats an utterance (step 2's row and the
// backward scan's)
ASR_API int asr_dio_contour(const void* cand, const void* f0, void* out,
                            void* work, int B, int nb, int nf, int vrm,
                            float allowed, void* stream) {
  if (B < 0 || nb < 1 || nf < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  dio_contour_kernel<<<B, DC_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)cand, (const float*)f0, (float*)out, (float*)work, nb, nf,
      vrm, allowed);
  return (int)cudaGetLastError();
}
