// The eval AbbyNormal tail as device helpers, shared by the kernels that
// normalise rows held in shared memory (abby.cu; the fused attention and
// MLP kernels of later slices).
#pragma once

#include "common.cuh"

// The normalising tail on one row of a tile, shared with later fused
// kernels: `xr` is the row in shared memory (f32), `j` the channel.
__device__ __forceinline__ float abby_tail_at(const float* xr, int j, int D,
                                              int size, int choice,
                                              float alpha, float k,
                                              float beta) {
  const int pad = size / 2;
  float s = 0.0f, mx = -INFINITY;
  for (int o = -pad; o <= pad; ++o) {
    const int jj = j + o;
    if (jj >= 0 && jj < D) {
      const float v = xr[jj] * xr[jj];
      s += v;
      mx = fmaxf(mx, v);
    }
  }
  const float avg = s / (float)size;
  const float div2 = mx > 2.0f * avg ? mx : avg;
  const float mix = choice == 1 ? div2 : avg;
  return xr[j] / expf(beta * logf(mix * alpha + k));
}

// Row statistics of the tail: the routing choice argmax(logits + cv).
__device__ __forceinline__ int abby_choice(const float* xr, int D,
                                           const float* logits, int lane) {
  float sa = 0.0f, s = 0.0f;
  for (int j = lane; j < D; j += 32) {
    sa += fabsf(xr[j]);
    s += xr[j];
  }
  sa = warp_sum(sa);
  s = warp_sum(s);
  const float mu = s / (float)D;
  float q = 0.0f;
  for (int j = lane; j < D; j += 32) {
    const float c = xr[j] - mu;
    q += c * c;
  }
  q = warp_sum(q);
  const float cv = sqrtf(q / (float)(D - 1)) / (sa / (float)D + 1e-6f);
  int best = 0;
  float bv = logits[0] + cv;
  for (int c = 1; c < 3; ++c) {
    const float v = logits[c] + cv;
    if (v > bv) {
      bv = v;
      best = c;
    }
  }
  return best;
}
