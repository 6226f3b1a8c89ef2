// Fused SDF-MLP kernels for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes) by nefii_tpu_torch/ops/kernels/fused_mlp.py.
//
// Replaces the two Pallas TPU kernels of nefii_tpu/ops/pallas/fused_mlp.py:
//
//   _kernel (fused_mlp.py:136), reached through build_fused_hidden /
//   build_fused_sdf: the value-only hidden chain of the SDF MLP, per layer
//   z = h W + b (the skip layer adds x Wx, the concat(h, x)/sqrt(2) folded
//   into split weights), h = softplus(100 z)/100. Three entries:
//     nefii_sdf_hidden     fp32, on the FMA pipe (the layer loop of
//                          sdf_mlp.cuh), at width 256 or 512;
//     nefii_sdf_hidden_tc  bf16 operands, fp32 accumulation, h rounded to
//                          bf16 after every layer, on the tensor cores
//                          (sdf_mlp_tc.cuh: wgmma, bulk-copy weight ring);
//     nefii_sdf_value      the same tensor-core kernel with an sdf epilogue:
//                          sdf = h . w_last[:, 0] + b_last[0] in fp32, so the
//                          [N, W] hidden state never reaches memory.
//   _kernel_fwd_bwd (fused_mlp.py:240), reached through
//   build_fused_sdf_feature_grad: nefii_sdf_fwd_bwd, the same forward in
//   fp32 accuracy, then the input-space backward seeded by the sdf column of
//   the last linear: g_z = g_h sigmoid(100 z), g_h = g_z W^T, the skip
//   layer's x part into its own accumulator. It runs on the tensor cores in
//   split bf16 (three bf16 products per multiply-add); its design and bound
//   are in sdf_mlp_split.cuh.
//
// Widths. Every kernel here is compiled for hidden widths 256 and 512: the
// FMA kernel (FmaCfg, 32-row tiles at 512, 64-row at 256), the tensor-core
// kernels K1 bf16 and K2 (TcCfg, SplitCfg). Each entry takes the packing's
// width, launches that instantiation and refuses any other. A net runs at the
// smallest compiled width that holds it (fused_mlp.py), so NeuS's 8x256 runs
// unpadded in every kernel.
//
// What bounds the fp32 FMA kernels on this card. The 8x512 chain is ~3.7
// MFLOP per point against ~160 B of input and 1-2 KB of output, so it is
// compute-bound; the TPU kernel kept all ~7.5 MB of fp32 weights in VMEM,
// which an SM (227 KB of shared memory) cannot. The design therefore keeps
// only the block's activation tile on chip -- 32 rows x 512 features in fp32
// (64 x 256 at width 256), 64 KB of shared memory -- and streams each layer's weights through L2
// (they fit in its 50 MB many times over) and L1, where the four row groups
// of a block share them. Every thread owns an 8x8 output tile and runs the
// matmul as fp32 FMAs (64 FMAs per 16 bytes of weights and 32 bytes of
// broadcast activations read), so the kernel is bound by the FP32 pipe, not
// by memory: the JAX counterpart is fp32, and one TF32 or bf16 tensor-core
// pass would change the numerics (K2's split bf16 keeps them, at three
// products each). The bf16 design and its bound are in sdf_mlp_tc.cuh.
//
// All matmul work happens here, in sdf_mlp.cuh (the FMA layer loop),
// sdf_mlp_tc.cuh and sdf_mlp_split.cuh (on the tensor-core building blocks
// of tc_common.cuh); no library GEMM is called.

#include "sdf_mlp.cuh"
#include "sdf_mlp_split.cuh"
#include "sdf_mlp_tc.cuh"

namespace {

// xs[c][r] = x[base + r][c] (zero past the last row), BM rows
template <int BM>
__device__ __forceinline__ void load_rows(float* xs, const float* __restrict__ x, int xc,
                                          long long base, long long n_rows) {
  for (int i = threadIdx.x; i < BM * xc; i += FMA_THREADS) {
    const int r = i / xc, c = i - r * xc;
    const long long row = base + r;
    xs[c * BM + r] = row < n_rows ? x[row * xc + c] : 0.0f;
  }
}

// out[base + r][c] = act[c][r], BM rows of W
template <int W, int BM>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float* act, long long base,
                                           long long n_rows) {
  for (int i = threadIdx.x; i < BM * W; i += FMA_THREADS) {
    const int r = i / W, c = i - r * W;
    const long long row = base + r;
    if (row < n_rows) out[row * W + c] = act[c * BM + r];
  }
}

template <int W>
__global__ void __launch_bounds__(FMA_THREADS, 2)
sdf_hidden_kernel(const float* __restrict__ x, const float* __restrict__ wbuf,
                  const __grid_constant__ Plan plan,
                  float* __restrict__ out, long long n_rows) {
  constexpr int BM = FmaCfg<W>::BM;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;            // [W][BM]
  float* xs = smem + W * BM;    // [x_cols][BM]
  const int tx = threadIdx.x % (W / TN), ty = threadIdx.x / (W / TN);
  const int col0 = tx * TN, row0 = ty * TM;
  const long long n_tiles = (n_rows + BM - 1) / BM;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * BM;
    load_rows<BM>(xs, x, plan.x_cols, base, n_rows);
    __syncthreads();
    for (int l = 0; l < plan.n; ++l)
      forward_layer<W>(plan.l[l], l == 0 ? xs : act, xs, act, wbuf, col0, row0);
    store_rows<W, BM>(out, act, base, n_rows);
    __syncthreads();
  }
}

template <int W>
int launch_fma(const void* x, const void* wbuf, const Plan& plan, void* out, long long n_rows,
               int grid, void* stream) {
  const int smem = (W + plan.x_cols) * FmaCfg<W>::BM * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sdf_hidden_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_hidden_kernel<W><<<grid, FMA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wbuf), plan,
      static_cast<float*>(out), n_rows);
  return (int)cudaGetLastError();
}

template <int W, bool SDF>
int launch_tc_w(const void* x, const void* tc, const void* wbuf, const Plan& plan,
                const void* wlast, float b_last, void* out_h, void* out_sdf, long long n_rows,
                int grid, void* stream) {
  using C = TcCfg<W>;
  cudaError_t e = cudaFuncSetAttribute(sdf_tc_kernel<W, SDF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  sdf_tc_kernel<W, SDF><<<grid, TC_THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(tc),
      static_cast<const __nv_bfloat16*>(wbuf), plan, static_cast<const float*>(wlast), b_last,
      static_cast<__nv_bfloat16*>(out_h), static_cast<float*>(out_sdf), n_rows);
  return (int)cudaGetLastError();
}

template <bool SDF>
int launch_tc(const void* x, const void* tc, const void* wbuf, const long long* desc,
              int n_layers, int x_cols, int width, const void* wlast, float b_last, void* out_h,
              void* out_sdf, long long n_rows, int grid, void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || x_cols > TC_BK || grid <= 0 ||
      n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (width == 512)
    return launch_tc_w<512, SDF>(x, tc, wbuf, plan, wlast, b_last, out_h, out_sdf, n_rows, grid,
                                 stream);
  if (width == 256)
    return launch_tc_w<256, SDF>(x, tc, wbuf, plan, wlast, b_last, out_h, out_sdf, n_rows, grid,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

template <int W>
int launch_split(const void* x, const void* rec, const void* wbuf, const Plan& plan,
                 const void* wlast, void* h_out, void* dx_out, void* sbuf, int n_rec,
                 long long n_rows, int grid, void* stream) {
  using C = SplitCfg<W>;
  if (n_rec != split_records<W>(plan)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(sdf_split_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  sdf_split_kernel<W><<<grid, TC_THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(rec),
      static_cast<const float*>(wbuf), plan, static_cast<const float*>(wlast),
      static_cast<float*>(h_out), static_cast<float*>(dx_out), static_cast<float*>(sbuf), n_rec,
      n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nefii_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the FMA kernel's compiled widths (widths[2]), its rows a block at each
// (block_rows[2]) and threads a block; the tensor-core kernels' rows a tile,
// threads a block and compiled widths (tc_widths[2])
int nefii_fused_mlp_config(int* widths, int* block_rows, int* threads, int* tc_block_rows,
                           int* tc_threads, int* tc_widths) {
  widths[0] = 256;
  widths[1] = 512;
  block_rows[0] = FmaCfg<256>::BM;
  block_rows[1] = FmaCfg<512>::BM;
  *threads = FMA_THREADS;
  *tc_block_rows = TC_BM;
  *tc_threads = TC_THREADS;
  tc_widths[0] = 256;
  tc_widths[1] = 512;
  return 0;
}

// out[n_rows][width] = hidden chain of x[n_rows][x_cols], fp32 (FMA pipe),
// at `width` (256 or 512).
int nefii_sdf_hidden(const void* x, const void* wbuf, const long long* desc, int n_layers,
                     int x_cols, int width, void* out, long long n_rows, int grid,
                     void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || grid <= 0 || n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (width == 512) return launch_fma<512>(x, wbuf, plan, out, n_rows, grid, stream);
  if (width == 256) return launch_fma<256>(x, wbuf, plan, out, n_rows, grid, stream);
  return (int)cudaErrorInvalidValue;
}

// out[n_rows][width] bf16 = hidden chain of x[n_rows][x_cols] bf16 on the
// tensor cores at `width` (256 or 512); tc holds the packed weight chunks,
// wbuf the biases. A block step holds 512 / width tiles of 64 rows.
int nefii_sdf_hidden_tc(const void* x, const void* tc, const void* wbuf, const long long* desc,
                        int n_layers, int x_cols, int width, void* out, long long n_rows,
                        int grid, void* stream) {
  return launch_tc<false>(x, tc, wbuf, desc, n_layers, x_cols, width, nullptr, 0.0f, out,
                          nullptr, n_rows, grid, stream);
}

// sdf[n_rows] fp32 = (hidden chain of x) . wlast + b_last, the same kernel.
int nefii_sdf_value(const void* x, const void* tc, const void* wbuf, const long long* desc,
                    int n_layers, int x_cols, int width, const void* wlast, float b_last,
                    void* sdf, long long n_rows, int grid, void* stream) {
  return launch_tc<true>(x, tc, wbuf, desc, n_layers, x_cols, width, wlast, b_last, nullptr,
                         sdf, n_rows, grid, stream);
}

// h_out[n_rows][width] (last hidden state) and dx_out[n_rows][x_cols]
// (d sdf / d x), fp32, on the tensor cores in split bf16 at `width` (256 or
// 512); rec holds n_rec records of K2's packed split weights (pack_split),
// wbuf the fp32 biases; sbuf holds grid x (n_layers - 1) x TC_BM x width
// floats.
int nefii_sdf_fwd_bwd(const void* x, const void* rec, const void* wbuf, const long long* desc,
                      int n_layers, int x_cols, int width, const void* wlast, void* h_out,
                      void* dx_out, void* sbuf, int n_rec, long long n_rows, int grid,
                      void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || x_cols > SP_NX || grid <= 0 ||
      n_rows <= 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < plan.n; ++l)
    if (plan.l[l].k_h % 16 || plan.l[l].k_x % 16) return (int)cudaErrorInvalidValue;
  if (width == 512)
    return launch_split<512>(x, rec, wbuf, plan, wlast, h_out, dx_out, sbuf, n_rec, n_rows, grid,
                             stream);
  if (width == 256)
    return launch_split<256>(x, rec, wbuf, plan, wlast, h_out, dx_out, sbuf, n_rec, n_rows, grid,
                             stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
