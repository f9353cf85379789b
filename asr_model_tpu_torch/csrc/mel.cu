// Power mel spectrogram for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/mel_kernel.py:pallas_mel_spectrogram
// (and so the frontend of pallas_log_mel_spectrogram; the Whisper
// compression stays in PyTorch, as it stays in XLA there).
//
// For a (B, N) f32 batch: frames of n_fft samples at hop `hop` over the
// centre zero-padded signal (frame t starts at sample t * hop - n_fft /
// 2), the windowed DFT as two products against the Hann-windowed cos /
// -sin bases (n_fft, F), power re^2 + im^2, and the (F, n_mels) HTK
// filterbank: out (B, n_mels, T), T = 1 + N / hop.
//
// What bounds it: the function needs a real FFT, the power and the
// filterbank, about 0.16 MFLOP per frame (1.3 GFLOP for 8 x 10 s) against
// the audio read once and the mel written once -- operations, in f32.
// This kernel does the DFT products instead, 4 * n_fft * F operations per
// frame (2.1 MFLOP; 16.8 GFLOP for 8 x 10 s), about 13x the FFT's, so it
// cannot come near that bound; a shared-memory FFT is the way there.
// Design: one block per (32-frame tile,
// utterance).  Frames are read straight from the waveform with the
// hop-strided addressing the TPU kernel could not express (it framed the
// signal in HBM first), 32 samples of 32 frames at a time into shared
// memory; the bases stream through shared tiles from L2; each 64-bin
// slice of the power spectrum lives only in shared memory before it is
// folded into the block's (32, n_mels) mel accumulators in registers, so
// the (T, F) spectrum never reaches device memory.  f32 on the CUDA
// cores: the 2e-3 tolerance of the spectrum does not leave room for TF32.
#include "common.cuh"

constexpr int MEL_TF = 32;   // frames per block
constexpr int MEL_FN = 64;   // frequency bins per slice
constexpr int MEL_KC = 32;   // samples per chunk
constexpr int MEL_MAXM = 128;

__global__ void __launch_bounds__(256)
mel_kernel(const float* __restrict__ audio, const float* __restrict__ wc,
           const float* __restrict__ ws, const float* __restrict__ fb,
           float* __restrict__ out, int N, int T, int hop, int n_fft, int F,
           int n_mels) {
  __shared__ float as[MEL_TF][MEL_KC + 1];
  __shared__ float wct[MEL_KC][MEL_FN + 1];
  __shared__ float wst[MEL_KC][MEL_FN + 1];
  __shared__ float pw[MEL_TF][MEL_FN + 1];

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int f0t = blockIdx.x * MEL_TF;     // first frame of the tile
  const float* x = audio + (size_t)b * N;
  const int pad = n_fft / 2;

  // DFT role: bin fc of the slice, frames 8 * fg .. + 7
  const int fc = t % MEL_FN, fg = t / MEL_FN;
  // mel role: mel bin mm, frames 16 * mh .. + 15
  const int mm = t % MEL_MAXM, mh = t / MEL_MAXM;
  float macc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) macc[i] = 0.0f;

  for (int fs = 0; fs < F; fs += MEL_FN) {
    float re[8], im[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) re[i] = im[i] = 0.0f;
    for (int k0 = 0; k0 < n_fft; k0 += MEL_KC) {
#pragma unroll
      for (int e = 0; e < (MEL_TF * MEL_KC) / 256; ++e) {
        const int idx = t + 256 * e;
        const int fr = idx / MEL_KC, kk = idx % MEL_KC;
        const int s = (f0t + fr) * hop + k0 + kk - pad;
        as[fr][kk] =
            (f0t + fr < T && k0 + kk < n_fft && s >= 0 && s < N) ? x[s] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < (MEL_KC * MEL_FN) / 256; ++e) {
        const int idx = t + 256 * e;
        const int kk = idx / MEL_FN, ff = idx % MEL_FN;
        const bool in = k0 + kk < n_fft && fs + ff < F;
        const size_t off = (size_t)(k0 + kk) * F + fs + ff;
        wct[kk][ff] = in ? wc[off] : 0.0f;
        wst[kk][ff] = in ? ws[off] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < MEL_KC; ++kk) {
        const float c = wct[kk][fc], sn = wst[kk][fc];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = as[8 * fg + i][kk];
          re[i] = fmaf(a, c, re[i]);
          im[i] = fmaf(a, sn, im[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) pw[8 * fg + i][fc] = re[i] * re[i] + im[i] * im[i];
    __syncthreads();
    if (mm < n_mels) {
      const int fmax = min(MEL_FN, F - fs);
      for (int ff = 0; ff < fmax; ++ff) {
        const float w = fb[(size_t)(fs + ff) * n_mels + mm];
#pragma unroll
        for (int i = 0; i < 16; ++i) macc[i] = fmaf(pw[16 * mh + i][ff], w, macc[i]);
      }
    }
    __syncthreads();
  }

  if (mm < n_mels) {
    float* o = out + ((size_t)b * n_mels + mm) * T;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int fr = f0t + 16 * mh + i;
      if (fr < T) o[fr] = macc[i];
    }
  }
}

// audio: (B, N) f32; wc, ws: (n_fft, F) f32; fb: (F, n_mels) f32;
// out: (B, n_mels, T) f32 with T = 1 + N / hop.  n_mels <= 128.
ASR_API int asr_mel_spectrogram(const void* audio, const void* wc,
                                const void* ws, const void* fb, void* out,
                                int B, int N, int hop, int n_fft, int F,
                                int n_mels, void* stream) {
  if (n_mels > MEL_MAXM || n_mels < 1) return (int)cudaErrorInvalidValue;
  const int T = 1 + N / hop;
  if (B == 0) return 0;
  const dim3 grid((T + MEL_TF - 1) / MEL_TF, B);
  mel_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)wc, (const float*)ws,
      (const float*)fb, (float*)out, N, T, hop, n_fft, F, n_mels);
  return (int)cudaGetLastError();
}
