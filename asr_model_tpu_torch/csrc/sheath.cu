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
// GFLOP on 8 MB of activations -- operations, not bytes.  Unlike the TPU
// program, which held every row in one core's VMEM, the card runs the
// rows on all SMs, and each slot needs two reductions over all rows
// before the next slot may start.  Design: a fixed sequence of launches
// per step, with no host synchronisation:
//   sheath_rows  -- one block per 16-row tile: v_gate, LayerNorm,
//                   adapter, gate, x_new in place in the f32 state, ion;
//   sheath_mem   -- the per-batch masked mean of x_new (one thread per
//                   (batch, channel), rows summed in order: deterministic);
//   sheath_ctl   -- one block: the global masked mean of ion, the EMA,
//                   the jump action, the next slot index, actions, jstat;
//   sheath_jump  -- adds the jump term where the action was > 0.
// Each reads the slot index and the step's action from device memory
// and returns at once when the slot is past L, so the host never waits.
// The TPU kernel's pooling matrices (which only existed to turn the
// reductions into matmuls) are gone: the reductions read the mask.
#include <algorithm>

#include "common.cuh"

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
  const float* mkey;       // (L, M, D)
  const float* mval;       // (L, M)
  const float* vmlp1_w;    // (L, D, D2)
  const float* vmlp1_b;    // (L, D2)
  const float* vmlp2_w;    // (L, D2)
  const float* vmlp2_b;    // (L,)
  const float* vcat_w;     // (L, 2)
  const float* vcat_b;     // (L,)
  const float* adapt_w;    // ((L + 1) / 2, D, D)
  const float* adapt_b;    // ((L + 1) / 2, D)
  const float* memgate_w;  // (D,)
  const float* memgate_b;  // (1,)
  float* xs;               // (N, D) f32 state
  float* ion;              // (N,)
  float* mem;              // (B, D)
  float* mem_w;            // (B, D)
  int* ctl;                // [slot i, step active, step action]
  float* jump_w;           // (1,)
  int* actions;            // (L,)
  int* jstat;              // (3,)
  int N, B, C, D, D2, M, L;
  float thresh;
};

template <typename T>
__global__ void sheath_init(SheathArgs a) {
  const size_t nd = (size_t)a.N * a.D, bd = (size_t)a.B * a.D;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       e < nd || e < bd; e += stride) {
    if (e < nd) a.xs[e] = to_f32(((const T*)a.x_in)[e]);
    if (e < bd) a.mem_w[e] = a.mem0[e % a.D];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctl[0] = 0;
    a.ctl[1] = 0;
    a.ctl[2] = 0;
    for (int c = 0; c < 3; ++c) a.jstat[c] = 0;
  }
}

__global__ void __launch_bounds__(256) sheath_rows(SheathArgs a) {
  const int i = a.ctl[0];
  if (i >= a.L) return;
  const int D = a.D, D2 = a.D2, M = a.M;
  extern __shared__ float smem[];
  float* xt = smem;                       // [16][D]  x
  float* px = xt + GEMM_ROWS * D;         // [16][D]  LayerNorm(x)
  float* hs = px + GEMM_ROWS * D;         // [16][D2] scoring MLP hidden
  float* lg = hs + GEMM_ROWS * D2;        // [16][M]  memory logits
  float* wt = lg + GEMM_ROWS * M;         // gemm weight tile
  float* mkinv = wt + GEMM_WT_FLOATS;     // [M] 1 / ||mkey||
  float* xinv = mkinv + M;                // [16] 1 / ||x||
  float* gv = xinv + GEMM_ROWS;           // [16] skip gate
  float* ms = gv + GEMM_ROWS;             // [16] memory score
  float* ionr = ms + GEMM_ROWS;           // [16] ion

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int nwarp = blockDim.x / 32;
  const int r0 = blockIdx.x * GEMM_ROWS;
  const float* lns = a.ln_scale + (size_t)i * D;
  const float* lnb = a.ln_bias + (size_t)i * D;
  const float* gw = a.gate_w + (size_t)i * D;
  const float* mk = a.mkey + (size_t)i * M * D;

  for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
    const int r = e / D, j = e % D;
    xt[e] = (r0 + r < a.N) ? a.xs[(size_t)(r0 + r) * D + j] : 0.0f;
  }
  __syncthreads();

  // per-row norm, LayerNorm (two-pass variance, eps 1e-5) and skip gate
  for (int r = warp; r < GEMM_ROWS; r += nwarp) {
    const float* xr = xt + r * D;
    float s = 0.0f, sq = 0.0f;
    for (int j = lane; j < D; j += 32) {
      s += xr[j];
      sq += xr[j] * xr[j];
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s / (float)D;
    float q = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float c = xr[j] - mu;
      q += c * c;
    }
    q = warp_sum(q);
    const float rstd = rsqrtf(q / (float)D + 1e-5f);
    float g = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float p = (xr[j] - mu) * rstd * lns[j] + lnb[j];
      px[r * D + j] = p;
      g += p * gw[j];
    }
    g = warp_sum(g);
    if (lane == 0) {
      xinv[r] = rsqrtf(fmaxf(sq, 1e-24f));
      gv[r] = sigmoidf_(g + a.gate_b[i]);
    }
  }
  // 1 / ||mkey[m]||
  for (int m = warp; m < M; m += nwarp) {
    float sq = 0.0f;
    for (int j = lane; j < D; j += 32) {
      const float v = mk[(size_t)m * D + j];
      sq += v * v;
    }
    sq = warp_sum(sq);
    if (lane == 0) mkinv[m] = rsqrtf(fmaxf(sq, 1e-24f));
  }
  __syncthreads();

  // memory-bank logits: cosine similarity / sqrt(D)
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  for (int n0 = 0; n0 < M; n0 += GEMM_NT) {
    float acc[4];
    gemm_rows16<float, false>(xt, D, D, mk, D, n0, M, wt, acc);
    const int n = n0 + t % GEMM_NT;
    if (n < M) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * (t / GEMM_NT) + q;
        lg[r * M + n] = acc[q] * xinv[r] * mkinv[n] * inv_sqrt_d;
      }
    }
  }
  __syncthreads();

  // softmax over the M keys, dotted with mval
  const float* mv = a.mval + (size_t)i * M;
  for (int r = warp; r < GEMM_ROWS; r += nwarp) {
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, lg[r * M + m]);
    mx = warp_max(mx);
    float se = 0.0f, sv = 0.0f;
    for (int m = lane; m < M; m += 32) {
      const float p = expf(lg[r * M + m] - mx);
      se += p;
      sv += p * mv[m];
    }
    se = warp_sum(se);
    sv = warp_sum(sv);
    if (lane == 0) ms[r] = sv / se;
  }

  // scoring MLP hidden: silu(x vmlp1_w + vmlp1_b)
  const float* w1 = a.vmlp1_w + (size_t)i * D * D2;
  const float* b1 = a.vmlp1_b + (size_t)i * D2;
  for (int n0 = 0; n0 < D2; n0 += GEMM_NT) {
    float acc[4];
    gemm_rows16<float, true>(xt, D, D, w1, D2, n0, D2, wt, acc);
    const int n = n0 + t % GEMM_NT;
    if (n < D2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hs[(4 * (t / GEMM_NT) + q) * D2 + n] = siluf_(acc[q] + b1[n]);
    }
  }
  __syncthreads();

  const float* w2 = a.vmlp2_w + (size_t)i * D2;
  for (int r = warp; r < GEMM_ROWS; r += nwarp) {
    float s = 0.0f;
    for (int n = lane; n < D2; n += 32) s += hs[r * D2 + n] * w2[n];
    s = warp_sum(s);
    if (lane == 0) {
      const float mlp = s + a.vmlp2_b[i];
      const float xv = ms[r] * a.vcat_w[2 * i] + mlp * a.vcat_w[2 * i + 1] +
                       a.vcat_b[i];
      const float io = xv > a.thresh ? 1.0f : 0.0f;
      ionr[r] = io;
      if (r0 + r < a.N) a.ion[r0 + r] = io;
    }
  }
  __syncthreads();

  // x_new = x + g * (apx * ion), written in place into the f32 state
  if (i % 2 == 0) {
    const float* aw = a.adapt_w + (size_t)(i / 2) * D * D;
    const float* ab = a.adapt_b + (size_t)(i / 2) * D;
    for (int n0 = 0; n0 < D; n0 += GEMM_NT) {
      float acc[4];
      gemm_rows16<float, true>(px, D, D, aw, D, n0, D, wt, acc);
      const int n = n0 + t % GEMM_NT;
      if (n < D) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 4 * (t / GEMM_NT) + q;
          if (r0 + r < a.N) {
            const float apx = acc[q] + ab[n];
            a.xs[(size_t)(r0 + r) * D + n] =
                xt[r * D + n] + gv[r] * (apx * ionr[r]);
          }
        }
      }
    }
  } else {
    for (int e = t; e < GEMM_ROWS * D; e += blockDim.x) {
      const int r = e / D, j = e % D;
      if (r0 + r < a.N)
        a.xs[(size_t)(r0 + r) * D + j] =
            xt[e] + gv[r] * (px[e] * ionr[r]);
    }
  }
}

// per-batch masked mean of x_new: grid (B, ceil(D / 128)), 128 threads
__global__ void sheath_mem(SheathArgs a) {
  if (a.ctl[0] >= a.L) return;
  const int b = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= a.D) return;
  float s = 0.0f, n = 0.0f;
  const float* xb = a.xs + (size_t)b * a.C * a.D + j;
  const uint8_t* vb = a.valid ? a.valid + (size_t)b * a.C : nullptr;
  for (int c = 0; c < a.C; ++c) {
    const float m = vb ? (vb[c] ? 1.0f : 0.0f) : 1.0f;
    s += m * xb[(size_t)c * a.D];
    n += m;
  }
  a.mem[(size_t)b * a.D + j] = s / fmaxf(n, 1.0f);
}

// the step's scalar control: one block of 256 threads
__global__ void __launch_bounds__(256) sheath_ctl(SheathArgs a, int step) {
  __shared__ float red_s[8], red_n[8];
  __shared__ float mem_v[64];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int i = a.ctl[0];
  if (i >= a.L) {
    if (t == 0) {
      a.actions[step] = 0;
      a.ctl[1] = 0;
      a.ctl[2] = 0;
    }
    return;
  }
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
  // working-memory gate per batch row: sigmoid(mem . memgate_w + b)
  for (int b = warp; b < a.B; b += 8) {
    float d = 0.0f;
    for (int j = lane; j < a.D; j += 32)
      d += a.mem[(size_t)b * a.D + j] * a.memgate_w[j];
    d = warp_sum(d);
    if (lane == 0) mem_v[b] = sigmoidf_(d + a.memgate_b[0]);
  }
  __syncthreads();
  if (t == 0) {
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
    a.ctl[1] = 1;
    a.ctl[2] = action;
    a.actions[step] = action;
    a.jstat[action] += a.B;
  }
  for (int e = t; e < a.B * a.D; e += blockDim.x) {
    const int b = e / a.D;
    const float v = mem_v[b];
    a.mem_w[e] = v * a.mem_w[e] + (1.0f - v) * a.mem[e];
  }
}

template <typename T>
__global__ void sheath_jump(SheathArgs a) {
  if (a.ctl[1] == 0 || a.ctl[2] <= 0) return;
  const float jw = a.jump_w[0];
  const size_t nd = (size_t)a.N * a.D;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nd;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t r = e / a.D;
    const int j = (int)(e % a.D);
    const int b = (int)(r / a.C);
    const float x0 = to_f32(((const T*)a.x_in)[e]);
    a.xs[e] = a.xs[e] + (jw * x0 + (1.0f - jw) * a.mem_w[(size_t)b * a.D + j]);
  }
}

template <typename T>
__global__ void sheath_finish(SheathArgs a) {
  const size_t nd = (size_t)a.N * a.D;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < nd;
       e += (size_t)gridDim.x * blockDim.x)
    ((T*)a.out)[e] = from_f32<T>(a.xs[e]);
}

static size_t sheath_rows_smem(int D, int D2, int M) {
  return sizeof(float) * (2 * GEMM_ROWS * D + GEMM_ROWS * D2 +
                          GEMM_ROWS * M + GEMM_WT_FLOATS + M +
                          4 * GEMM_ROWS);
}

template <typename T>
static int launch_sheath(SheathArgs a, cudaStream_t st) {
  const size_t nd = (size_t)a.N * a.D;
  const int ew_grid = (int)std::min<size_t>((nd + 255) / 256, 4096);
  sheath_init<T><<<ew_grid, 256, 0, st>>>(a);
  const size_t smem = sheath_rows_smem(a.D, a.D2, a.M);
  cudaFuncSetAttribute(sheath_rows,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int row_grid = (a.N + GEMM_ROWS - 1) / GEMM_ROWS;
  const dim3 mem_grid(a.B, (a.D + 127) / 128);
  for (int step = 0; step < a.L; ++step) {
    sheath_rows<<<row_grid, 256, smem, st>>>(a);
    sheath_mem<<<mem_grid, 128, 0, st>>>(a);
    sheath_ctl<<<1, 256, 0, st>>>(a, step);
    sheath_jump<T><<<ew_grid, 256, 0, st>>>(a);
  }
  sheath_finish<T><<<ew_grid, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Pointers in the order of SheathArgs; weights f32 and contiguous,
// x_in/out of `dtype` (0 = f32, 1 = bf16), workspace f32/int32.
ASR_API int asr_fused_sheath_scan(
    int dtype, const void* x_in, void* out, const void* valid,
    const void* mem0, const void* sampled, const void* jump_s,
    const void* ln_scale, const void* ln_bias, const void* gate_w,
    const void* gate_b, const void* mkey, const void* mval,
    const void* vmlp1_w, const void* vmlp1_b, const void* vmlp2_w,
    const void* vmlp2_b, const void* vcat_w, const void* vcat_b,
    const void* adapt_w, const void* adapt_b, const void* memgate_w,
    const void* memgate_b, void* xs, void* ion, void* mem, void* mem_w,
    void* ctl, void* jump_w, void* actions, void* jstat, int N, int B,
    int C, int D, int D2, int M, int L, float thresh, void* stream) {
  if (B > 64) return (int)cudaErrorInvalidValue;
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
  a.mkey = (const float*)mkey;
  a.mval = (const float*)mval;
  a.vmlp1_w = (const float*)vmlp1_w;
  a.vmlp1_b = (const float*)vmlp1_b;
  a.vmlp2_w = (const float*)vmlp2_w;
  a.vmlp2_b = (const float*)vmlp2_b;
  a.vcat_w = (const float*)vcat_w;
  a.vcat_b = (const float*)vcat_b;
  a.adapt_w = (const float*)adapt_w;
  a.adapt_b = (const float*)adapt_b;
  a.memgate_w = (const float*)memgate_w;
  a.memgate_b = (const float*)memgate_b;
  a.xs = (float*)xs;
  a.ion = (float*)ion;
  a.mem = (float*)mem;
  a.mem_w = (float*)mem_w;
  a.ctl = (int*)ctl;
  a.jump_w = (float*)jump_w;
  a.actions = (int*)actions;
  a.jstat = (int*)jstat;
  a.N = N;
  a.B = B;
  a.C = C;
  a.D = D;
  a.D2 = D2;
  a.M = M;
  a.L = L;
  a.thresh = thresh;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ASR_F32) return launch_sheath<float>(a, st);
  return launch_sheath<__nv_bfloat16>(a, st);
}
