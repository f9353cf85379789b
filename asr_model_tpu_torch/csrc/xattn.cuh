// What the whole-call attention's two sources (xattn.cu: the
// tensor-core and CUDA-core routes; xattn_wide.cu: the wide and global
// routes) agree on: the masked logit and the order of a call's weights.
#pragma once

constexpr float XA_MASKED = -1e30f;

// Weights of a call, torch (out, in) layouts, in this order.
enum XaWeight {
  QN_W1, QN_B1, QN_W2, QN_B2, QP_W, QP_B,
  KN_W1, KN_B1, KN_W2, KN_B2, KP_W, KP_B,
  HN_W1, HN_B1, HN_W2, HN_B2, OP_W, OP_B, XA_NW
};
