// Device-side building blocks of the SDF-MLP hidden chain on the FMA pipe,
// for the fp32 K1 of fused_mlp.cu; the plan of the layers (Plan, make_plan)
// serves every kernel.
//
// The FMA K1 is compiled for hidden widths W = 256 and 512 (FmaCfg). A block
// owns a tile of BM rows (32 at 512, 64 at 256). Activations live in shared
// memory, feature-major ([feature][row]), so an 8-row slice of one feature is
// two broadcast float4 loads. Weights stream from global memory (L2/L1).
// Every thread owns an 8x8 output tile and runs the matmul as fp32 FMAs.
// Layers are computed in place: each thread keeps its outputs in registers
// until every thread has read the tile, then one barrier and the write-back.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;              // rows per thread
constexpr int TN = 8;              // output features per thread
constexpr int FMA_THREADS = 256;   // threads a block of the FMA K1, at every width
constexpr int MAX_LAYERS = 16;

// The FMA K1's tile at hidden width W: W / TN column groups of threads span
// the width and the block's 256 threads make FMA_THREADS / (W / TN) row
// groups of TM rows, so BM = 32 rows at 512 (4 x 64 groups) and 64 at 256
// (8 x 32). At 256 the block doubles its rows rather than halving its
// threads: it keeps 256 threads and two blocks an SM (16 warps, as at 512)
// and the same 64 KB activation tile, and every weight value a block reads
// from L1 serves 64 rows in place of 32; blocks of 128 threads would need
// four an SM for the same warps, each streaming every layer's weights.
template <int W>
struct FmaCfg {
  static_assert(W == 256 || W == 512, "the FMA K1 is compiled for W = 256, 512");
  static constexpr int BM = FMA_THREADS / (W / TN) * TM;  // rows a block tile
};

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

// eight consecutive values starting at a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// softplus(100 z)/100 in the stable form max(t,0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

// acc[i][j] += sum_k aT[k][row0 + i] * B[k][col0 + j]
// aT: shared memory, feature-major [K][BM]; B: global, row-major [K][ldb].
template <int BM>
__device__ __forceinline__ void gemm_acc(float (&acc)[TM][TN], const float* __restrict__ aT,
                                         int K, const float* __restrict__ B, int ldb, int col0,
                                         int row0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(aT + k * BM + row0);
    const float4 a1 = *reinterpret_cast<const float4*>(aT + k * BM + row0 + 4);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[TN];
    load8(B + (long long)k * ldb + col0, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// One layer of the forward chain for the block's tile at width W. Reads `in`
// (feature-major, k_h rows) and xs, writes softplus(z) into act.
template <int W>
__device__ __forceinline__ void forward_layer(const Layer& L, const float* in, const float* xs,
                                              float* act, const float* __restrict__ wbuf,
                                              int col0, int row0) {
  constexpr int BM = FmaCfg<W>::BM;
  float acc[TM][TN];
  zero(acc);
  gemm_acc<BM>(acc, in, L.k_h, wbuf + L.w, W, col0, row0);
  if (L.k_x > 0) gemm_acc<BM>(acc, xs, L.k_x, wbuf + L.wx, W, col0, row0);
  float bias[TN];
  load8(wbuf + L.b + col0, bias);
  __syncthreads();  // every thread has finished reading `in` (it may be act)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) act[(col0 + j) * BM + row0 + i] = softplus100(acc[i][j] + bias[j]);
  __syncthreads();
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
