// What every kernel of the SDF MLP shares: the plan of the layers (Plan,
// make_plan) and softplus100, the fp32 activation of the FMA K1
// (sdf_mlp_fma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LAYERS = 16;

struct Layer {
  long long w;    // W_h   [k_h][width]  (input x output, row-major)
  long long wx;   // W_x   [k_x][width]  skip layers only
  long long b;    // bias  [width]
  int k_h;        // rows of W_h: the width the layer reads from the previous layer (layer 0: x)
  int k_x;        // rows of W_x: x_cols for a skip layer, 0 otherwise
};

struct Plan {
  int n;
  int x_cols;
  Layer l[MAX_LAYERS];
};

// softplus(100 z)/100 in the stable form max(t,0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

// desc: n_layers x 5 int64 (w, wx, b, k_h, k_x), offsets in elements; every
// layer's output padded to `width`.
bool make_plan(const long long* desc, int n_layers, int x_cols, Plan* plan, int width) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  if (x_cols <= 0 || x_cols > width || x_cols % 8 != 0) return false;
  plan->n = n_layers;
  plan->x_cols = x_cols;
  for (int l = 0; l < n_layers; ++l) {
    const long long* d = desc + 5 * l;
    Layer L{d[0], d[1], d[2], (int)d[3], (int)d[4]};
    if (L.k_h <= 0 || L.k_h > width || L.k_h % 8 != 0) return false;
    if (l == 0 && (L.k_h != x_cols || L.k_x != 0)) return false;
    if (L.k_x != 0 && L.k_x != x_cols) return false;
    if (L.w < 0 || L.b < 0 || L.w % 8 || L.b % 8) return false;
    if (L.k_x && (L.wx < 0 || L.wx % 8)) return false;
    plan->l[l] = L;
  }
  return true;
}

}  // namespace
