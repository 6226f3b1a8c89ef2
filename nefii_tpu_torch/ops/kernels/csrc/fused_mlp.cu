// Fused SDF-MLP kernels for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes) by nefii_tpu_torch/ops/kernels/fused_mlp.py.
//
// Replaces the two Pallas TPU kernels of nefii_tpu/ops/pallas/fused_mlp.py:
//
//   nefii_sdf_hidden  <- _kernel (fused_mlp.py:136), reached through
//       build_fused_hidden / build_fused_sdf. The value-only hidden chain of
//       the SDF MLP: per layer z = h W + b (the skip layer adds x Wx, the
//       concat(h, x)/sqrt(2) folded into split weights), h = softplus(100 z)/100.
//       fp32, or bf16 storage with fp32 accumulation and h rounded to bf16
//       after every layer, exactly as the TPU kernel does.
//   nefii_sdf_fwd_bwd <- _kernel_fwd_bwd (fused_mlp.py:240), reached through
//       build_fused_sdf_feature_grad. The same forward, storing every
//       pre-activation z, then the input-space backward seeded by the sdf
//       column of the last linear: g_z = g_h sigmoid(100 z), g_h = g_z W^T,
//       the skip layer's x part into its own accumulator. fp32 only.
//
// What bounds it on this card. The 8x512 chain is ~3.7 MFLOP per point
// against ~160 B of input and 1-2 KB of output, so it is compute-bound; the
// TPU kernel kept all ~7.5 MB of fp32 weights in VMEM, which an SM (227 KB of
// shared memory) cannot. The design therefore keeps only the block's
// activation tile on chip -- 32 rows x 512 features in fp32, 64 KB of shared
// memory -- and streams each layer's weights through L2 (they fit in its
// 50 MB many times over) and L1, where the four row groups of a block share
// them. Every thread owns an 8x8 output tile and runs the matmul as fp32 FMAs
// (64 FMAs per 16 bytes of weights and 32 bytes of broadcast activations
// read), so the kernel is bound by the FP32 pipe, not by memory. The bf16
// variant converts on load and uses the same FMA path: correct first; the
// tensor-core (wgmma) version is later work. K2's pre-activations (16 KB per
// row) cannot stay on chip either: each block writes them to its own slot of
// a scratch buffer sized by the blocks in flight, not by N (the grid is
// persistent and walks the row tiles).
//
// All matmul work happens in this file; no library GEMM is called.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDTH = 512;                       // hidden width: every fused layer's padded output
constexpr int BM = 32;                           // rows per block tile
constexpr int TM = 8;                            // rows per thread
constexpr int TN = 8;                            // output features per thread
constexpr int THREADS = (BM / TM) * (WIDTH / TN);  // 4 row groups x 64 column groups = 256
constexpr int MAX_LAYERS = 16;

struct Layer {
  long long w;    // W_h   [k_h][WIDTH]  (input x output, row-major)
  long long wx;   // W_x   [k_x][WIDTH]  skip layers only
  long long b;    // bias  [WIDTH]
  long long wt;   // W_h^T [WIDTH][k_h]  (backward)
  long long wxt;  // W_x^T [WIDTH][k_x]  (backward, skip layers)
  int k_h;        // rows of W_h: the width the layer reads from the previous layer (layer 0: x)
  int k_x;        // rows of W_x: x_cols for a skip layer, 0 otherwise
};

struct Plan {
  int n;
  int x_cols;
  Layer l[MAX_LAYERS];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the working type's rounding of an activation (identity in fp32)
template <typename T> __device__ __forceinline__ float round_work(float v) {
  return to_float(from_float<T>(v));
}

// eight consecutive values starting at a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// softplus(100 z)/100 in the stable form max(t,0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

// sigmoid(100 z), stable on both sides
__device__ __forceinline__ float sigmoid100(float z) {
  const float t = 100.0f * z;
  if (t >= 0.0f) return 1.0f / (1.0f + expf(-t));
  const float e = expf(t);
  return e / (1.0f + e);
}

// acc[i][j] += sum_k aT[k][row0 + i] * B[k][col0 + j]
// aT: shared memory, feature-major [K][BM]; B: global, row-major [K][ldb].
template <typename T>
__device__ __forceinline__ void gemm_acc(float (&acc)[TM][TN], const float* __restrict__ aT,
                                         int K, const T* __restrict__ B, int ldb, int col0,
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

// xs[c][r] = x[base + r][c] (zero past the last row)
template <typename T>
__device__ __forceinline__ void load_rows(float* xs, const T* __restrict__ x, int xc,
                                          long long base, long long n_rows) {
  for (int i = threadIdx.x; i < BM * xc; i += THREADS) {
    const int r = i / xc, c = i - r * xc;
    const long long row = base + r;
    xs[c * BM + r] = row < n_rows ? to_float(x[row * xc + c]) : 0.0f;
  }
}

// out[base + r][c] = act[c][r]
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float* act, long long base,
                                           long long n_rows) {
  for (int i = threadIdx.x; i < BM * WIDTH; i += THREADS) {
    const int r = i / WIDTH, c = i - r * WIDTH;
    const long long row = base + r;
    if (row < n_rows) out[row * WIDTH + c] = from_float<T>(act[c * BM + r]);
  }
}

// One layer of the forward chain for the block's tile. Reads `in` (feature-
// major, k_h rows) and xs, writes softplus(z) into act, and z into z_out
// ([BM][WIDTH], row-major) when given.
template <typename T>
__device__ __forceinline__ void forward_layer(const Layer& L, const float* in, const float* xs,
                                              float* act, const T* __restrict__ wbuf,
                                              float* z_out, int col0, int row0) {
  float acc[TM][TN];
  zero(acc);
  gemm_acc<T>(acc, in, L.k_h, wbuf + L.w, WIDTH, col0, row0);
  if (L.k_x > 0) gemm_acc<T>(acc, xs, L.k_x, wbuf + L.wx, WIDTH, col0, row0);
  float bias[TN];
  load8(wbuf + L.b + col0, bias);
  __syncthreads();  // every thread has finished reading `in` (it may be act)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float z[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      z[j] = acc[i][j] + bias[j];
      act[(col0 + j) * BM + row0 + i] = round_work<T>(softplus100(z[j]));
    }
    if (z_out != nullptr) {
      float4* zp = reinterpret_cast<float4*>(z_out + (row0 + i) * WIDTH + col0);
      zp[0] = make_float4(z[0], z[1], z[2], z[3]);
      zp[1] = make_float4(z[4], z[5], z[6], z[7]);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sdf_hidden_kernel(const T* __restrict__ x, const T* __restrict__ wbuf,
                  const __grid_constant__ Plan plan,
                  T* __restrict__ out, long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                // [WIDTH][BM]
  float* xs = smem + WIDTH * BM;    // [x_cols][BM]
  const int tx = threadIdx.x % (WIDTH / TN), ty = threadIdx.x / (WIDTH / TN);
  const int col0 = tx * TN, row0 = ty * TM;
  const long long n_tiles = (n_rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * BM;
    load_rows(xs, x, plan.x_cols, base, n_rows);
    __syncthreads();
    for (int l = 0; l < plan.n; ++l)
      forward_layer<T>(plan.l[l], l == 0 ? xs : act, xs, act, wbuf, nullptr, col0, row0);
    store_rows(out, act, base, n_rows);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
sdf_fwd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wbuf,
                   const __grid_constant__ Plan plan,
                   const float* __restrict__ wlast, float* __restrict__ h_out,
                   float* __restrict__ dx_out, float* zbuf, long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  const int xc = plan.x_cols;
  float* act = smem;              // [WIDTH][BM]: h in the forward, g in the backward
  float* xs = act + WIDTH * BM;   // [x_cols][BM]
  float* gx = xs + xc * BM;       // [x_cols][BM]: skip layers' gradient w.r.t. x
  float* zs = zbuf + (long long)blockIdx.x * plan.n * BM * WIDTH;  // this block's slot
  const int tx = threadIdx.x % (WIDTH / TN), ty = threadIdx.x / (WIDTH / TN);
  const int col0 = tx * TN, row0 = ty * TM;
  const long long n_tiles = (n_rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * BM;
    load_rows(xs, x, xc, base, n_rows);
    for (int i = threadIdx.x; i < BM * xc; i += THREADS) gx[i] = 0.0f;
    __syncthreads();

    // ---- forward, storing the pre-activations -------------------------
    for (int l = 0; l < plan.n; ++l)
      forward_layer<float>(plan.l[l], l == 0 ? xs : act, xs, act, wbuf,
                           zs + (long long)l * BM * WIDTH, col0, row0);
    store_rows(h_out, act, base, n_rows);
    __syncthreads();

    // ---- backward of the sdf column ------------------------------------
    for (int i = threadIdx.x; i < BM * WIDTH; i += THREADS) act[i] = wlast[i / BM];
    __syncthreads();
    for (int l = plan.n - 1; l >= 0; --l) {
      const Layer& L = plan.l[l];
      const float* z = zs + (long long)l * BM * WIDTH;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // plain loads: z was written by this kernel, so not through the
        // read-only (non-coherent) path that load8 uses
        const float4 z0 = *reinterpret_cast<const float4*>(z + (row0 + i) * WIDTH + col0);
        const float4 z1 = *reinterpret_cast<const float4*>(z + (row0 + i) * WIDTH + col0 + 4);
        const float zr[TN] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int j = 0; j < TN; ++j) act[(col0 + j) * BM + row0 + i] *= sigmoid100(zr[j]);
      }
      __syncthreads();  // g_z complete
      float acc[TM][TN];
      if (L.k_x > 0 && col0 < L.k_x) {
        zero(acc);
        gemm_acc<float>(acc, act, WIDTH, wbuf + L.wxt, L.k_x, col0, row0);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) gx[(col0 + j) * BM + row0 + i] += acc[i][j];
      }
      zero(acc);
      if (col0 < L.k_h) gemm_acc<float>(acc, act, WIDTH, wbuf + L.wt, L.k_h, col0, row0);
      __syncthreads();  // every thread has finished reading g_z
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) act[(col0 + j) * BM + row0 + i] = acc[i][j];
      __syncthreads();
    }
    // act rows [0, x_cols) hold the gradient w.r.t. the layer-0 input
    for (int i = threadIdx.x; i < BM * xc; i += THREADS) {
      const int r = i / xc, c = i - r * xc;
      const long long row = base + r;
      if (row < n_rows) dx_out[row * xc + c] = act[c * BM + r] + gx[c * BM + r];
    }
    __syncthreads();
  }
}

// desc: n_layers x 7 int64 (w, wx, b, wt, wxt, k_h, k_x) in elements.
bool make_plan(const long long* desc, int n_layers, int x_cols, bool need_backward, Plan* plan) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return false;
  if (x_cols <= 0 || x_cols > WIDTH || x_cols % 8 != 0) return false;
  plan->n = n_layers;
  plan->x_cols = x_cols;
  for (int l = 0; l < n_layers; ++l) {
    const long long* d = desc + 7 * l;
    Layer L{d[0], d[1], d[2], d[3], d[4], (int)d[5], (int)d[6]};
    if (L.k_h <= 0 || L.k_h > WIDTH || L.k_h % 8 != 0) return false;
    if (l == 0 && (L.k_h != x_cols || L.k_x != 0)) return false;
    if (L.k_x != 0 && L.k_x != x_cols) return false;
    if (L.w < 0 || L.b < 0 || L.w % 8 || L.b % 8) return false;
    if (L.k_x && (L.wx < 0 || L.wx % 8)) return false;
    if (need_backward) {
      if (L.wt < 0 || L.wt % 8) return false;
      if (L.k_x && (L.wxt < 0 || L.wxt % 8)) return false;
    }
    plan->l[l] = L;
  }
  return true;
}

}  // namespace

extern "C" {

const char* nefii_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nefii_fused_mlp_config(int* width, int* block_rows, int* threads) {
  *width = WIDTH;
  *block_rows = BM;
  *threads = THREADS;
  return 0;
}

// out[n_rows][WIDTH] = hidden chain of x[n_rows][x_cols]; bf16 != 0 selects
// bf16 storage (x, weights, out) with fp32 accumulation.
int nefii_sdf_hidden(const void* x, const void* wbuf, const long long* desc, int n_layers,
                     int x_cols, void* out, long long n_rows, int grid, int bf16,
                     void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, false, &plan) || grid <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (WIDTH + x_cols) * BM * (int)sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = cudaFuncSetAttribute(sdf_hidden_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sdf_hidden_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wbuf), plan,
        static_cast<__nv_bfloat16*>(out), n_rows);
  } else {
    e = cudaFuncSetAttribute(sdf_hidden_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sdf_hidden_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wbuf), plan,
        static_cast<float*>(out), n_rows);
  }
  return (int)cudaGetLastError();
}

// h_out[n_rows][WIDTH] (last hidden state) and dx_out[n_rows][x_cols]
// (d sdf / d x) in fp32; zbuf holds grid x n_layers x BM x WIDTH floats.
int nefii_sdf_fwd_bwd(const void* x, const void* wbuf, const long long* desc, int n_layers,
                      int x_cols, const void* wlast, void* h_out, void* dx_out, void* zbuf,
                      long long n_rows, int grid, void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, true, &plan) || grid <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (WIDTH + 2 * x_cols) * BM * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sdf_fwd_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fwd_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wbuf), plan,
      static_cast<const float*>(wlast), static_cast<float*>(h_out),
      static_cast<float*>(dx_out), static_cast<float*>(zbuf), n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
