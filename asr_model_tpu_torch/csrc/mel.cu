// Power mel spectrogram for Hopper (sm_90a).
//
// Replaces asr_model_tpu/ops/pallas/mel_kernel.py:pallas_mel_spectrogram
// (and so the frontend of pallas_log_mel_spectrogram; the Whisper
// compression stays in PyTorch, as it stays in XLA there).
//
// For a (B, N) f32 batch: frames of n_fft samples at hop `hop` over the
// centre zero-padded signal (frame t starts at sample t * hop - n_fft /
// 2), the periodic Hann window, the real FFT's power |X[k]|^2 for k = 0
// .. n_fft / 2, and the HTK filterbank: out (B, n_mels, T), T = 1 + N /
// hop (one fewer for an odd n_fft whose last frame would run past the
// padding, as the reference's framing gives).
//
// What bounds it: the function needs a real FFT, the power and the
// filterbank's nonzero entries, about 60k operations per 1024-sample
// frame, against the audio read once and the mel written once --
// operations, in f32.  (The TPU kernel computed the windowed DFT as two
// products, 13x the FFT's operations, to put it on the MXU.)
// Design: one block per (16-frame tile, utterance).  The tile's span of
// the waveform, 15 * hop + n_fft samples, is read once into shared
// memory, zero outside the signal (the centred padding).  Each frame's
// windowed n_fft reals are packed as M = n_fft / 2 complex values z[n] =
// x[2n] + i x[2n + 1] and go through an M-point complex FFT in shared
// memory: Stockham radix-8 stages (and one radix-2 or -4 stage when M is
// not a power of 8), each thread holding the 8 points of its butterflies
// in registers, M / 8 threads a frame, 2048 / M frames at a time.  The
// real-FFT split X[k] = E[k] + W^k O[k] gives the M + 1 bins, and their
// power goes to the frame's free ping-pong buffer (the buffers are padded
// one complex value in 16 against bank conflicts).  The mel product runs
// over each filter's nonzero band only (the wrapper's band table: first
// bin, length, offset into packed weights; an HTK bin lies in at most
// two triangles), two lanes a mel, each weight loaded once for all the
// frames in flight.  The FFT size is a template parameter, so strides,
// stages and loops are compile-time.  Twiddles W^k = exp(-2 pi i k / n_fft) come from a
// table the wrapper makes in float64 and stores as f32.  The tile's (n_mels,
// 16) outputs are staged in shared memory and written as runs of 16
// consecutive frames of each mel row.  f32 on the CUDA cores: the power
// spectrum's 2e-3 tolerance leaves no room for TF32.
#include "common.cuh"

constexpr int MEL_TF = 16;        // frames per block
constexpr int MEL_THREADS = 256;
constexpr int MEL_MAXM = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// in-register R-point DFT (R = 2, 4, 8), natural order in and out:
// radix-2 decimation-in-frequency layers, then the bit-reversal
template <int R>
__device__ __forceinline__ void dft_small(float2 (&v)[R]) {
  const float c = 0.70710678118654752f;
  const float w8r[4] = {1.0f, c, 0.0f, -c};    // exp(-2 pi i j / 8)
  const float w8i[4] = {0.0f, -c, -1.0f, -c};
#pragma unroll
  for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int base = 0; base < R; base += 2 * half) {
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float2 a = v[base + i], b = v[base + i + half];
        v[base + i] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        const int j = i * (4 / half);             // W_{2 half}^i = W_8^j
        v[base + i + half] = cmul(d, make_float2(w8r[j], w8i[j]));
      }
    }
  }
  float2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = v[i];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r = 0;
#pragma unroll
    for (int bit = 1, rb = R / 2; bit < R; bit <<= 1, rb >>= 1)
      if (i & bit) r |= rb;
    v[r] = t[i];
  }
}

// Shared FFT buffers are padded by one complex value every 16, so the
// stride-R stores of a stage spread over the banks.
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// Stockham stages of an m-point FFT: radix 8 while 8 divides what is
// left, then one of radix 2 or 4
__host__ __device__ constexpr int fft_stage_count(int m) {
  return m <= 1 ? 0 : 1 + fft_stage_count(m >= 8 ? m / 8 : 1);
}

template <int NFFT>
struct MelShape {
  static constexpr int M = NFFT / 2;                  // complex points
  static constexpr int TPF = M / 8;                   // threads a frame
  static constexpr int FC =                           // frames at a time
      MEL_THREADS / TPF < MEL_TF ? MEL_THREADS / TPF : MEL_TF;
  static constexpr int BUF = M + M / 16;              // padded buffer
  static constexpr int STAGES = fft_stage_count(M);
};

// one Stockham stage of radix R over M points (NS: the size of the
// transforms already done); tw[k] = exp(-2 pi i k / (2 M))
template <int M, int R, int NS>
__device__ __forceinline__ void fft_stage(const float2* src, float2* dst,
                                          int tf,
                                          const float2* __restrict__ tw) {
  constexpr int TPF = M / 8;
#pragma unroll
  for (int q = 0; q < 8 / R; ++q) {
    const int j = tf + q * TPF;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad16(j + r * (M / R))];
    const int kq = j & (NS - 1);
    if (NS > 1) {
      const int step = 2 * kq * (M / (NS * R));  // W_M^(r kq M/(NS R))
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(&tw[r * step]));
    }
    dft_small<R>(v);
    const int d = (j - kq) * R + kq;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad16(d + r * NS)] = v[r];
  }
}

// the stages from NS on (as fft_stage_count counts them); src ends on
// the transform, dst on the free buffer
template <int M, int NS>
__device__ __forceinline__ void fft_stages(float2*& src, float2*& dst,
                                           int tf, bool act,
                                           const float2* __restrict__ tw) {
  if constexpr (NS < M) {
    constexpr int R = M / NS >= 8 ? 8 : M / NS;
    __syncthreads();
    if (act) fft_stage<M, R, NS>(src, dst, tf, tw);
    float2* t = src;
    src = dst;
    dst = t;
    fft_stages<M, NS * R>(src, dst, tf, act, tw);
  }
}

template <int NFFT>
__host__ __device__ constexpr size_t mel_smem_floats(int hop, int n_mels) {
  return (size_t)MelShape<NFFT>::FC * 4 * MelShape<NFFT>::BUF  // ping-pong
         + (size_t)n_mels * MEL_TF                              // output
         + (size_t)(MEL_TF - 1) * hop + NFFT;                   // waveform
}

template <int NFFT>
__global__ void __launch_bounds__(MEL_THREADS, 3)
mel_fft_kernel(const float* __restrict__ audio, const float* __restrict__ win,
               const float2* __restrict__ tw, const int* __restrict__ band,
               const float* __restrict__ bw, float* __restrict__ out, int N,
               int T, int hop, int n_mels) {
  using S = MelShape<NFFT>;
  constexpr int M = S::M, TPF = S::TPF, FC = S::FC, BUF = S::BUF;
  extern __shared__ __align__(16) float msm[];
  float2* fbuf = reinterpret_cast<float2*>(msm);   // [FC][2][BUF]
  float* outs = msm + (size_t)FC * 4 * BUF;        // [n_mels][TF]
  float* wave = outs + n_mels * MEL_TF;            // [span]
  const int span = (MEL_TF - 1) * hop + NFFT;

  const int t = threadIdx.x, b = blockIdx.y;
  const int f0t = blockIdx.x * MEL_TF;
  const float* x = audio + (size_t)b * N;
  const long long start = (long long)f0t * hop - NFFT / 2;
  for (int i = t; i < span; i += MEL_THREADS) {
    const long long s = start + i;
    wave[i] = (s >= 0 && s < N) ? x[s] : 0.0f;
  }

  const int slot = t / TPF, tf = t % TPF;
  const bool act = slot < FC;
  float2* b0 = fbuf + (size_t)(act ? slot : 0) * 2 * BUF;
  // the buffer that ends up free (the power goes there)
  constexpr int PW_OFF = (S::STAGES & 1) ? 0 : BUF;

  for (int f0 = 0; f0 < MEL_TF; f0 += FC) {
    __syncthreads();  // waveform in; the previous round's power consumed
    if (act) {
      const float* w = wave + (f0 + slot) * hop;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tf + q * TPF;
        b0[pad16(n)] = make_float2(w[2 * n] * __ldg(&win[2 * n]),
                                   w[2 * n + 1] * __ldg(&win[2 * n + 1]));
      }
    }
    float2 *src = b0, *dst = b0 + BUF;
    fft_stages<M, 1>(src, dst, tf, act, tw);
    __syncthreads();
    if (act) {
      // real-FFT split: E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj
      // Z[M-k]) / 2i, X[k] = E + W^k O, for k = 0 .. M
      float* pw = reinterpret_cast<float*>(dst);
      for (int k = tf; k <= M; k += TPF) {
        const float2 zk = src[pad16(k & (M - 1))];
        const float2 zm = src[pad16((M - k) & (M - 1))];
        const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
        const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
        const float2 wo = cmul(__ldg(&tw[k]), o);
        const float re = e.x + wo.x, im = e.y + wo.y;
        pw[k] = re * re + im * im;
      }
    }
    __syncthreads();
    // mel product over each filter's band: lanes 2m and 2m + 1 take the
    // two halves of mel m's bins for every frame of the round (one
    // weight load per bin), summed by one shuffle in a fixed order; 128
    // mels a pass
    for (int m0 = 0; m0 < n_mels; m0 += MEL_THREADS / 2) {
      const int m = m0 + (t >> 1), half = t & 1;
      int lo = 0, n = 0, off = 0;
      if (m < n_mels) {
        lo = __ldg(&band[3 * m]);
        const int len = __ldg(&band[3 * m + 1]), h = (len + 1) / 2;
        off = __ldg(&band[3 * m + 2]) + (half ? h : 0);
        lo += half ? h : 0;
        n = half ? len - h : h;
      }
      float acc[FC];
#pragma unroll
      for (int sl = 0; sl < FC; ++sl) acc[sl] = 0.0f;
      const float* pw0 = reinterpret_cast<const float*>(fbuf + PW_OFF);
      for (int i = 0; i < n; ++i) {
        const float w = __ldg(&bw[off + i]);
#pragma unroll
        for (int sl = 0; sl < FC; ++sl)
          acc[sl] = fmaf(pw0[sl * 4 * BUF + lo + i], w, acc[sl]);
      }
#pragma unroll
      for (int sl = 0; sl < FC; ++sl) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[sl], 1);
        if (!half && m < n_mels && f0 + sl < MEL_TF)
          outs[m * MEL_TF + f0 + sl] = acc[sl] + other;
      }
    }
  }
  __syncthreads();
  for (int e = t; e < n_mels * MEL_TF; e += MEL_THREADS) {
    const int m = e / MEL_TF, f = e % MEL_TF;
    if (f0t + f < T) out[((size_t)b * n_mels + m) * T + f0t + f] = outs[e];
  }
}

template <int NFFT>
static int launch_mel(const void* audio, const void* win, const void* tw,
                      const void* band, const void* bw, void* out, int B,
                      int N, int T, int hop, int n_mels, cudaStream_t st) {
  const size_t smem = sizeof(float) * mel_smem_floats<NFFT>(hop, n_mels);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mel_fft_kernel<NFFT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((T + MEL_TF - 1) / MEL_TF, B);
  mel_fft_kernel<NFFT><<<grid, MEL_THREADS, smem, st>>>(
      (const float*)audio, (const float*)win, (const float2*)tw,
      (const int*)band, (const float*)bw, (float*)out, N, T, hop, n_mels);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Any other n_fft (64..4096, odd included): Bluestein's algorithm, so the
// frame's n_fft-point DFT is a circular convolution of power-of-two
// length L >= 2 n_fft - 1 (L <= 8192), done by two L-point FFTs.  With
// the chirp b[m] = exp(i pi m^2 / n_fft), X[k] = conj(b[k]) (a (*) b)[k]
// for a[n] = x[n] win[n] conj(b[n]); |X[k]|^2 = |(a (*) b)[k]|^2, so the
// power needs no final chirp.  The wrapper makes the tables in float64:
// wc[n] = win[n] conj(b[n]), bf = FFT_L(b wrapped to length L) / L and
// the twiddles exp(-2 pi i k / L).  One block per (16-frame tile,
// utterance), one frame at a time: a radix-2 Stockham FFT of L points
// in shared memory (the inverse with conjugate twiddles), the power of
// bins 0 .. n_fft / 2, and the mel product over each filter's band, a
// thread a mel.  Frames are read straight from the waveform.  The same
// f32 arithmetic as the power-of-two kernel; about 4 L log2(L) / (n_fft
// log2(n_fft)) times its operations.

// one L-point radix-2 Stockham FFT (tw[k] = exp(-2 pi i k / L), k < L /
// 2; conjugated for the inverse): src ends on the transform
__device__ void mel_fft_pow2(float2*& src, float2*& dst, int L,
                             const float2* __restrict__ tw, bool inv) {
  const int h = L / 2;
  for (int ns = 1; ns < L; ns <<= 1) {
    __syncthreads();
    const int step = h / ns;
    for (int j = threadIdx.x; j < h; j += MEL_THREADS) {
      const int k = j & (ns - 1);
      float2 w = __ldg(&tw[k * step]);
      if (inv) w.y = -w.y;
      const float2 a = src[j], b = cmul(src[j + h], w);
      const int d = ((j - k) << 1) + k;
      dst[d] = make_float2(a.x + b.x, a.y + b.y);
      dst[d + ns] = make_float2(a.x - b.x, a.y - b.y);
    }
    float2* t = src;
    src = dst;
    dst = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(MEL_THREADS)
mel_bluestein_kernel(const float* __restrict__ audio,
                     const float2* __restrict__ wc,
                     const float2* __restrict__ bf,
                     const float2* __restrict__ tw,
                     const int* __restrict__ band,
                     const float* __restrict__ bw, float* __restrict__ out,
                     int N, int T, int hop, int n_fft, int L, int n_mels) {
  extern __shared__ __align__(16) float msm[];
  float2* b0 = reinterpret_cast<float2*>(msm);   // [L]
  float2* b1 = b0 + L;                           // [L]
  float* outs = reinterpret_cast<float*>(b1 + L);  // [n_mels][TF]
  const int t = threadIdx.x, b = blockIdx.y;
  const int f0t = blockIdx.x * MEL_TF;
  const float* x = audio + (size_t)b * N;
  const int nb = n_fft / 2 + 1;
  for (int f = 0; f < MEL_TF && f0t + f < T; ++f) {
    const long long start = (long long)(f0t + f) * hop - n_fft / 2;
    __syncthreads();              // the previous frame's power is read
    for (int n = t; n < L; n += MEL_THREADS) {
      float2 v = make_float2(0.0f, 0.0f);
      if (n < n_fft) {
        const long long s = start + n;
        const float xv = (s >= 0 && s < N) ? x[s] : 0.0f;
        const float2 c = __ldg(&wc[n]);
        v = make_float2(xv * c.x, xv * c.y);
      }
      b0[n] = v;
    }
    float2 *src = b0, *dst = b1;
    mel_fft_pow2(src, dst, L, tw, false);
    for (int n = t; n < L; n += MEL_THREADS) src[n] = cmul(src[n], __ldg(&bf[n]));
    mel_fft_pow2(src, dst, L, tw, true);
    // the power of bins 0 .. n_fft / 2 into the free buffer
    float* pw = reinterpret_cast<float*>(dst);
    for (int k = t; k < nb; k += MEL_THREADS) {
      const float2 c = src[k];
      pw[k] = c.x * c.x + c.y * c.y;
    }
    __syncthreads();
    for (int m = t; m < n_mels; m += MEL_THREADS) {
      const int lo = __ldg(&band[3 * m]), len = __ldg(&band[3 * m + 1]);
      const int off = __ldg(&band[3 * m + 2]);
      float acc = 0.0f;
      for (int i = 0; i < len; ++i)
        acc = fmaf(pw[lo + i], __ldg(&bw[off + i]), acc);
      outs[m * MEL_TF + f] = acc;
    }
  }
  __syncthreads();
  for (int e = t; e < n_mels * MEL_TF; e += MEL_THREADS) {
    const int m = e / MEL_TF, f = e % MEL_TF;
    if (f0t + f < T) out[((size_t)b * n_mels + m) * T + f0t + f] = outs[e];
  }
}

// the Bluestein length for n_fft, and the kernel's dynamic shared memory
__host__ __device__ constexpr int mel_bluestein_len(int n_fft) {
  int L = 1;
  while (L < 2 * n_fft - 1) L <<= 1;
  return L;
}
__host__ __device__ constexpr size_t mel_bluestein_smem(int n_fft,
                                                       int n_mels) {
  return sizeof(float) * (4 * (size_t)mel_bluestein_len(n_fft) +
                          (size_t)n_mels * MEL_TF);
}

// ---------------------------------------------------------------------
// Any n_fft and any n_mels: the DFT summed directly (the design above)
constexpr int MD_TF = 8;          // frames a block

__host__ __device__ constexpr size_t mel_dft_smem(int n_fft, int hop,
                                                  int tf) {
  return sizeof(float) *
         ((size_t)(tf - 1) * hop + n_fft + (size_t)tf * (n_fft / 2 + 1));
}

template <int TF>
__global__ void __launch_bounds__(MEL_THREADS)
mel_dft_kernel(const float* __restrict__ audio, const float* __restrict__ win,
               const float2* __restrict__ tw, const int* __restrict__ band,
               const float* __restrict__ bw, float* __restrict__ out, int N,
               int T, int hop, int n_fft, int n_mels) {
  extern __shared__ float smem[];
  const int nf = n_fft / 2 + 1, span = (TF - 1) * hop + n_fft;
  float* xs = smem;                          // [span] the tile's samples
  float* pw = xs + span;                     // [TF][nf] power
  const int t = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * TF;
  const long s0 = (long)f0 * hop - n_fft / 2;
  for (int e = t; e < span; e += MEL_THREADS) {
    const long i = s0 + e;
    xs[e] = i >= 0 && i < N ? audio[(size_t)b * N + i] : 0.0f;
  }
  __syncthreads();
  const int nfr = min(TF, T - f0);
  for (int k = t; k < nf; k += MEL_THREADS) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.0f;
    int idx = 0;                             // k n mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float2 w = __ldg(tw + idx);
      const float wn = __ldg(win + n);
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float xv = xs[f * hop + n] * wn;
        re[f] = fmaf(xv, w.x, re[f]);
        im[f] = fmaf(xv, w.y, im[f]);
      }
      idx += k;
      if (idx >= n_fft) idx -= n_fft;
    }
#pragma unroll
    for (int f = 0; f < TF; ++f)
      if (f < nfr) pw[f * nf + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();
  for (int e = t; e < n_mels * nfr; e += MEL_THREADS) {
    const int m = e / nfr, f = e % nfr;
    const int lo = band[3 * m], len = band[3 * m + 1], off = band[3 * m + 2];
    float s = 0.0f;
    for (int i = 0; i < len; ++i) s = fmaf(pw[f * nf + lo + i], bw[off + i], s);
    out[((size_t)b * n_mels + m) * T + f0 + f] = s;
  }
}

// the frames a block of mel_dft_kernel takes: 8, or 1 where 8 frames'
// power would not fit in shared memory (0: not even one fits)
__host__ __device__ constexpr int mel_dft_frames(int n_fft, int hop) {
  return mel_dft_smem(n_fft, hop, MD_TF) <= 232448 ? MD_TF
         : mel_dft_smem(n_fft, hop, 1) <= 232448   ? 1
                                                   : 0;
}

template <int TF>
static int launch_mel_dft(const void* audio, const void* win, const void* tw,
                          const void* band, const void* bw, void* out, int B,
                          int N, int T, int hop, int n_fft, int n_mels,
                          cudaStream_t st) {
  const size_t smem = mel_dft_smem(n_fft, hop, TF);
  cudaError_t e = cudaFuncSetAttribute(
      mel_dft_kernel<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  mel_dft_kernel<TF><<<dim3((T + TF - 1) / TF, B), MEL_THREADS, smem, st>>>(
      (const float*)audio, (const float*)win, (const float2*)tw,
      (const int*)band, (const float*)bw, (float*)out, N, T, hop, n_fft,
      n_mels);
  return (int)cudaGetLastError();
}

// The direct-DFT route: audio, band, bw, out as below; win (n_fft,) f32
// periodic Hann window, tw (n_fft,) complex f32 exp(-2 pi i k / n_fft).
// Any n_fft >= 2 whose single frame fits in shared memory (about 38,000
// at hop 160), any n_mels >= 1.
ASR_API int asr_mel_spectrogram_dft(const void* audio, const void* win,
                                    const void* tw, const void* band,
                                    const void* bw, void* out, int B, int N,
                                    int hop, int n_fft, int n_mels,
                                    void* stream) {
  const int tf = mel_dft_frames(n_fft, hop);
  if (n_mels < 1 || hop < 1 || n_fft < 2 || tf == 0)
    return (int)cudaErrorInvalidValue;
  const int T = 1 + (N + 2 * (n_fft / 2) - n_fft) / hop;
  if (B == 0 || T < 1) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (tf == MD_TF)
    return launch_mel_dft<MD_TF>(audio, win, tw, band, bw, out, B, N, T, hop,
                                 n_fft, n_mels, st);
  return launch_mel_dft<1>(audio, win, tw, band, bw, out, B, N, T, hop, n_fft,
                           n_mels, st);
}
ASR_API int asr_mel_dft_frames(int n_fft, int hop) {
  return mel_dft_frames(n_fft, hop);
}

// ---------------------------------------------------------------------
// Past the direct DFT's shared memory (mel_dft_frames 0: one frame and
// its power no longer fit a block, n_fft past about 38,700): the same
// sums over device memory, two launches.  mel_dft_global_power: a thread
// a frequency bin of MG_TF frames (a block 256 bins of a frame group),
// the frames' samples read from the waveform in L2 (every thread of a
// block reads the same sample: a broadcast), the twiddle carried by a
// complex product per sample and read afresh from the table every
// MG_ANCHOR samples (the product's rounding stays below 1e-5), the power
// into `pw` (B, T, nf) f32 of device memory; mel_dft_global_bands: a
// thread a (mel, frame), the filter's nonzero band over pw.  What bounds
// it: the DFT's n_fft operations a bin, n_fft^2 / 2 a frame (the direct
// sum, as the Pallas kernel's basis products), far above its bytes.
constexpr int MG_TF = 8;          // frames a block
constexpr int MG_ANCHOR = 32;     // samples between twiddle table reads

__global__ void __launch_bounds__(MEL_THREADS)
mel_dft_global_power(const float* __restrict__ audio,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw, float* __restrict__ pw,
                     int N, int T, int hop, int n_fft) {
  const int nf = n_fft / 2 + 1;
  const int k = blockIdx.x * MEL_THREADS + threadIdx.x;
  const int f0 = blockIdx.y * MG_TF, b = blockIdx.z;
  if (k >= nf) return;
  const int nfr = min(MG_TF, T - f0);
  const long s0 = (long)f0 * hop - n_fft / 2;
  const float* xb = audio + (size_t)b * N;
  const float2 step = __ldg(tw + k);        // exp(-2 pi i k / n_fft)
  float re[MG_TF], im[MG_TF];
#pragma unroll
  for (int f = 0; f < MG_TF; ++f) re[f] = im[f] = 0.0f;
  float2 w = make_float2(1.0f, 0.0f);
  int idx = 0;                               // k n mod n_fft
  for (int n = 0; n < n_fft; ++n) {
    if (n % MG_ANCHOR == 0) w = __ldg(tw + idx);
    const float wn = __ldg(win + n);
#pragma unroll
    for (int f = 0; f < MG_TF; ++f) {
      const long i = s0 + (long)f * hop + n;
      const float xv =
          f < nfr && i >= 0 && i < N ? __ldg(xb + i) * wn : 0.0f;
      re[f] = fmaf(xv, w.x, re[f]);
      im[f] = fmaf(xv, w.y, im[f]);
    }
    const float wx = fmaf(w.x, step.x, -w.y * step.y);
    w.y = fmaf(w.x, step.y, w.y * step.x);
    w.x = wx;
    idx += k;
    if (idx >= n_fft) idx -= n_fft;
  }
#pragma unroll
  for (int f = 0; f < MG_TF; ++f)
    if (f < nfr)
      pw[((size_t)b * T + f0 + f) * nf + k] = re[f] * re[f] + im[f] * im[f];
}

__global__ void __launch_bounds__(MEL_THREADS)
mel_dft_global_bands(const float* __restrict__ pw,
                     const int* __restrict__ band,
                     const float* __restrict__ bw, float* __restrict__ out,
                     int T, int nf, int n_mels) {
  const long e = (long)blockIdx.x * MEL_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= (long)n_mels * T) return;
  const int m = (int)(e / T), f = (int)(e % T);
  const int lo = band[3 * m], len = band[3 * m + 1], off = band[3 * m + 2];
  const float* p = pw + ((size_t)b * T + f) * nf + lo;
  float s = 0.0f;
  for (int i = 0; i < len; ++i) s = fmaf(p[i], bw[off + i], s);
  out[((size_t)b * n_mels + m) * T + f] = s;
}

// The global route: audio, win, tw, band, bw, out as
// asr_mel_spectrogram_dft's; pw (B, T, n_fft / 2 + 1) f32 of device
// memory.  Any n_fft >= 2, any n_mels >= 1, B <= 65535.  Two launches.
ASR_API int asr_mel_spectrogram_global(const void* audio, const void* win,
                                       const void* tw, const void* band,
                                       const void* bw, void* out, void* pw,
                                       int B, int N, int hop, int n_fft,
                                       int n_mels, void* stream) {
  if (n_mels < 1 || hop < 1 || n_fft < 2 || !pw)
    return (int)cudaErrorInvalidValue;
  const int T = 1 + (N + 2 * (n_fft / 2) - n_fft) / hop;
  if (B == 0 || T < 1) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const int nf = n_fft / 2 + 1;
  cudaStream_t st = (cudaStream_t)stream;
  mel_dft_global_power<<<dim3((nf + MEL_THREADS - 1) / MEL_THREADS,
                              (T + MG_TF - 1) / MG_TF, B),
                         MEL_THREADS, 0, st>>>(
      (const float*)audio, (const float*)win, (const float2*)tw, (float*)pw,
      N, T, hop, n_fft);
  mel_dft_global_bands<<<dim3((unsigned)(((long)n_mels * T + MEL_THREADS - 1) /
                                         MEL_THREADS),
                              B),
                         MEL_THREADS, 0, st>>>((const float*)pw,
                                               (const int*)band,
                                               (const float*)bw, (float*)out,
                                               T, nf, n_mels);
  return (int)cudaGetLastError();
}

// audio: (B, N) f32; band: (n_mels, 3) int32 (first bin, length, offset
// into bw); bw: the filters' nonzero weights, packed; out: (B, n_mels,
// T) f32 with T = 1 + (N + 2 (n_fft / 2) - n_fft) / hop (1 + N / hop for
// an even n_fft).  1 <= n_mels <= 256, 64 <= n_fft <= 4096.
// n_fft a power of two: win (n_fft,) f32 Hann window, tw (n_fft,)
// complex f32 exp(-2 pi i k / n_fft) (wc, bf unused).  Any other n_fft:
// the Bluestein tables of length L = mel_bluestein_len(n_fft): wc
// (n_fft,) complex, bf (L,) complex, tw (L / 2,) complex exp(-2 pi i k /
// L) (win unused).
ASR_API int asr_mel_spectrogram(const void* audio, const void* win,
                                const void* tw, const void* wc,
                                const void* bf, const void* band,
                                const void* bw, void* out, int B, int N,
                                int hop, int n_fft, int n_mels,
                                void* stream) {
  if (n_mels > MEL_MAXM || n_mels < 1 || hop < 1 || n_fft < 64 ||
      n_fft > 4096)
    return (int)cudaErrorInvalidValue;
  // frames of the centre-padded signal (n_fft / 2 zeros a side)
  const int T = 1 + (N + 2 * (n_fft / 2) - n_fft) / hop;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_fft) {
#define MEL_CASE(n)                                                        \
  case n:                                                                  \
    return launch_mel<n>(audio, win, tw, band, bw, out, B, N, T, hop,      \
                         n_mels, st);
    MEL_CASE(64) MEL_CASE(128) MEL_CASE(256) MEL_CASE(512) MEL_CASE(1024)
    MEL_CASE(2048) MEL_CASE(4096)
#undef MEL_CASE
  }
  if (!wc || !bf) return (int)cudaErrorInvalidValue;
  const int L = mel_bluestein_len(n_fft);
  const size_t smem = mel_bluestein_smem(n_fft, n_mels);
  cudaError_t e = cudaFuncSetAttribute(
      mel_bluestein_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  mel_bluestein_kernel<<<dim3((T + MEL_TF - 1) / MEL_TF, B), MEL_THREADS,
                         smem, st>>>(
      (const float*)audio, (const float2*)wc, (const float2*)bf,
      (const float2*)tw, (const int*)band, (const float*)bw, (float*)out, N,
      T, hop, n_fft, L, n_mels);
  return (int)cudaGetLastError();
}
