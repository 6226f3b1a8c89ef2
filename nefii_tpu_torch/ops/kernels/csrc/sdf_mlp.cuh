// What every kernel of the SDF MLP shares: the plan of the layers (Plan,
// make_plan), softplus100, the fp32 activation of the FMA K1
// (sdf_mlp_fma.cuh), and the positional encoding on the device
// (embed_value, encode_rows), which K1's sdf entries and K3 compute in the
// prologue that fills their x tiles.

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
  int d_emb;  // K1's sdf entries: real embedding width 3 (1 + 2 multires) of the points they encode
  Layer l[MAX_LAYERS];
};

// softplus(100 z)/100 in the stable form max(t,0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

__device__ __forceinline__ float coord(const float4& p, int j) {
  return j == 0 ? p.x : (j == 1 ? p.y : p.z);
}

// the argument of frequency 2^k of coordinate j of p, rounded as the
// embedder's p * 2^k (exact)
__device__ __forceinline__ float embed_arg(const float4& p, int j, int k) {
  return __fmul_rn(coord(p, j), ldexpf(1.0f, k));
}

// column c < d_emb of the positional encoding of p:
// [p, sin(p), cos(p), sin(2p), cos(2p), ...], 3 columns each. sinf/cosf are
// libm's, not the fast intrinsics: a value is the one fused_mlp.embed_padded
// gives on the card, bit for bit.
__device__ __forceinline__ float embed_value(const float4& p, int c) {
  if (c < 3) return coord(p, c);
  const int q = c - 3, k = q / 6;
  int j = q % 6;
  const bool use_cos = j >= 3;
  if (use_cos) j -= 3;
  const float a = embed_arg(p, j, k);
  return use_cos ? cosf(a) : sinf(a);
}

// The encoding of a tile's ROWS points, tile_pts[ROWS][3] fp32 (of which the
// first `rows` are points): put(r, c, v) for every row r < ROWS and column
// c < d_emb, v = embed_value of the point (0 past `rows`). The columns from
// d_emb on are the caller's (zero, written once). Thread tid of `threads`
// takes (row, unit) pairs, a unit the 6 columns of one frequency (three
// independent sinf, then cosf of the same arguments: embed_value's, in one
// straight line) or the 3 coordinates; a warp's lanes take consecutive rows
// of one unit, so they run one path.
template <int ROWS, typename Put>
__device__ __forceinline__ void encode_rows(const float* tile_pts, int rows, int d_emb, int tid,
                                            int threads, Put put) {
  const int n_freq = (d_emb - 3) / 6;
  for (int u = tid; u < ROWS * (n_freq + 1); u += threads) {
    const int r = u % ROWS, k = u / ROWS;  // k < n_freq: frequency 2^k; k == n_freq: p
    const bool in = r < rows;
    const float4 p = in ? make_float4(tile_pts[3 * r], tile_pts[3 * r + 1], tile_pts[3 * r + 2],
                                      0.0f)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < n_freq) {
      const float a0 = embed_arg(p, 0, k), a1 = embed_arg(p, 1, k), a2 = embed_arg(p, 2, k);
      const float v[6] = {sinf(a0), sinf(a1), sinf(a2), cosf(a0), cosf(a1), cosf(a2)};
#pragma unroll
      for (int j = 0; j < 6; ++j) put(r, 3 + 6 * k + j, in ? v[j] : 0.0f);
    } else {
#pragma unroll
      for (int j = 0; j < 3; ++j) put(r, j, coord(p, j));
    }
  }
}

// desc: n_layers x 5 int64 (w, wx, b, k_h, k_x), offsets in elements; every
// layer's output padded to `width`.
bool make_plan(const long long* desc, int n_layers, int x_cols, Plan* plan, int width) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  if (x_cols <= 0 || x_cols > width || x_cols % 8 != 0) return false;
  plan->n = n_layers;
  plan->x_cols = x_cols;
  plan->d_emb = 0;
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
