// Fused SDF-MLP kernels for NVIDIA Hopper (sm_90a), bound through a plain C
// interface (ctypes) by nefii_tpu_torch/ops/kernels/fused_mlp.py.
//
// Replaces the two Pallas TPU kernels of nefii_tpu/ops/pallas/fused_mlp.py:
//
//   _kernel (fused_mlp.py:136), reached through build_fused_hidden /
//   build_fused_sdf: the value-only hidden chain of the SDF MLP, per layer
//   z = h W + b (the skip layer adds x Wx, the concat(h, x)/sqrt(2) folded
//   into split weights), h = softplus(100 z)/100. Four entries:
//     nefii_sdf_hidden      fp32, on the FMA pipe (sdf_mlp_fma.cuh: operands
//                           from shared memory, bulk-copy weight ring), h;
//     nefii_sdf_value_fp32  the same kernel on points, which it encodes, with
//                           an sdf epilogue: the sdf column summed in
//                           fused_mlp.sdf_column's order, so the [N, W]
//                           hidden state never reaches memory;
//     nefii_sdf_hidden_tc   bf16 operands, fp32 accumulation, h rounded to
//                           bf16 after every layer, on the tensor cores
//                           (sdf_mlp_tc.cuh: wgmma, bulk-copy weight ring);
//     nefii_sdf_value       the same tensor-core kernel on points, which it
//                           encodes, with an sdf epilogue: sdf = h .
//                           w_last[:, 0] + b_last[0] in fp32.
//   The hidden entries take the embedded points [N][x_cols]; the sdf entries,
//   which answer every SDF query of the tracers, take the points [N][3] fp32
//   and compute the positional encoding in the prologue that fills their x
//   tile (encode_rows, sdf_mlp.cuh), bit for bit fused_mlp.embed_padded.
//   _kernel_fwd_bwd (fused_mlp.py:240), reached through
//   build_fused_sdf_feature_grad: nefii_sdf_fwd_bwd, the same forward in
//   fp32 accuracy, then the input-space backward seeded by the sdf column of
//   the last linear: g_z = g_h sigmoid(100 z), g_h = g_z W^T, the skip
//   layer's x part into its own accumulator. It runs on the tensor cores in
//   split bf16 (three bf16 products per multiply-add); its design and bound
//   are in sdf_mlp_split.cuh.
//
// Widths. Every kernel here is compiled for hidden widths 256 and 512: the
// FMA kernel (FmaCfg: 64-row tiles at 512, 128-row at 256), the tensor-core
// kernels K1 bf16 and K2 (TcCfg, SplitCfg). Each entry takes the packing's
// width, launches that instantiation and refuses any other. A net runs at the
// smallest compiled width that holds it (fused_mlp.py), so NeuS's 8x256 runs
// unpadded in every kernel.
//
// What bounds each kernel, and what its design does about it, is in its
// header: sdf_mlp_fma.cuh (K1 fp32, the FP32 pipe), sdf_mlp_tc.cuh (K1 bf16)
// and sdf_mlp_split.cuh (K2), the last two on the tensor-core building
// blocks of tc_common.cuh. No library GEMM is called.

#include "sdf_mlp_fma.cuh"
#include "sdf_mlp_split.cuh"
#include "sdf_mlp_tc.cuh"

namespace {

template <int W, bool SDF>
int launch_fma_w(const void* x, const void* wbuf, const Plan& plan, const void* wlast,
                 float b_last, int sdf_cols, void* out_h, void* out_sdf, long long n_rows,
                 int grid, void* stream) {
  const int smem = FmaCfg<W>::smem(plan.x_cols);
  cudaError_t e = cudaFuncSetAttribute(sdf_fma_kernel<W, SDF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fma_kernel<W, SDF><<<grid, FMA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wbuf), plan,
      static_cast<const float*>(wlast), b_last, sdf_cols, static_cast<float*>(out_h),
      static_cast<float*>(out_sdf), n_rows);
  return (int)cudaGetLastError();
}

// the sdf entries' encoding: d_emb = 3 (1 + 2 multires) columns of x_cols
bool set_d_emb(Plan* plan, int multires) {
  if (multires < 0 || 3 * (1 + 2 * multires) > plan->x_cols) return false;
  plan->d_emb = 3 * (1 + 2 * multires);
  return true;
}

template <bool SDF>
int launch_fma(const void* x, const void* wbuf, const long long* desc, int n_layers, int x_cols,
               int width, int multires, const void* wlast, float b_last, int sdf_cols,
               void* out_h, void* out_sdf, long long n_rows, int grid, void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || x_cols > FMA_MAX_XC || grid <= 0 ||
      n_rows <= 0 || (SDF && !set_d_emb(&plan, multires)))
    return (int)cudaErrorInvalidValue;
  if (SDF && (sdf_cols < 1 || sdf_cols > width || (sdf_cols & (sdf_cols - 1))))
    return (int)cudaErrorInvalidValue;
  if (width == 512)
    return launch_fma_w<512, SDF>(x, wbuf, plan, wlast, b_last, sdf_cols, out_h, out_sdf, n_rows,
                                  grid, stream);
  if (width == 256)
    return launch_fma_w<256, SDF>(x, wbuf, plan, wlast, b_last, sdf_cols, out_h, out_sdf, n_rows,
                                  grid, stream);
  return (int)cudaErrorInvalidValue;
}

template <int W, bool SDF>
int launch_tc_w(const void* x, const void* tc, const void* wbuf, const Plan& plan,
                const void* wlast, float b_last, void* out_h, void* out_sdf, long long n_rows,
                int grid, void* stream) {
  // x: the embedded points (the hidden entry) or the points (the sdf entry)
  using C = TcCfg<W>;
  cudaError_t e = cudaFuncSetAttribute(sdf_tc_kernel<W, SDF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  sdf_tc_kernel<W, SDF><<<grid, TC_THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(
      SDF ? nullptr : static_cast<const __nv_bfloat16*>(x),
      SDF ? static_cast<const float*>(x) : nullptr, static_cast<const __nv_bfloat16*>(tc),
      static_cast<const __nv_bfloat16*>(wbuf), plan, static_cast<const float*>(wlast), b_last,
      static_cast<__nv_bfloat16*>(out_h), static_cast<float*>(out_sdf), n_rows);
  return (int)cudaGetLastError();
}

template <bool SDF>
int launch_tc(const void* x, const void* tc, const void* wbuf, const long long* desc,
              int n_layers, int x_cols, int width, int multires, const void* wlast, float b_last,
              void* out_h, void* out_sdf, long long n_rows, int grid, void* stream) {
  Plan plan;
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || x_cols > TC_BK || grid <= 0 ||
      n_rows <= 0 || (SDF && !set_d_emb(&plan, multires)))
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

// the FMA kernel's compiled widths (widths[2]), its rows a block tile at each
// (block_rows[2]) and threads a block (consumers and the producer
// warpgroup); the tensor-core kernels' rows a tile, threads a block and
// compiled widths (tc_widths[2])
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
  return launch_fma<false>(x, wbuf, desc, n_layers, x_cols, width, 0, nullptr, 0.0f, 1, out,
                           nullptr, n_rows, grid, stream);
}

// sdf[n_rows] fp32 of the points pts[n_rows][3] fp32, encoded at `multires`
// frequencies into x_cols columns: the sdf column of the same kernel's h
// against wlast (`width` floats, zero padded), summed as fused_mlp.sdf_column
// sums it: the products zero padded to sdf_cols (a power of two), pairwise
// halves, then + b_last.
int nefii_sdf_value_fp32(const void* pts, const void* wbuf, const long long* desc, int n_layers,
                         int x_cols, int width, int multires, const void* wlast, float b_last,
                         int sdf_cols, void* sdf, long long n_rows, int grid, void* stream) {
  return launch_fma<true>(pts, wbuf, desc, n_layers, x_cols, width, multires, wlast, b_last,
                          sdf_cols, nullptr, sdf, n_rows, grid, stream);
}

// out[n_rows][width] bf16 = hidden chain of x[n_rows][x_cols] bf16 on the
// tensor cores at `width` (256 or 512); tc holds the packed weight chunks,
// wbuf the biases. A block step holds 512 / width tiles of 64 rows.
int nefii_sdf_hidden_tc(const void* x, const void* tc, const void* wbuf, const long long* desc,
                        int n_layers, int x_cols, int width, void* out, long long n_rows,
                        int grid, void* stream) {
  return launch_tc<false>(x, tc, wbuf, desc, n_layers, x_cols, width, 0, nullptr, 0.0f, out,
                          nullptr, n_rows, grid, stream);
}

// sdf[n_rows] fp32 = (hidden chain of x) . wlast + b_last, the same kernel,
// x the encoding (at `multires` frequencies, into x_cols columns) of the
// points pts[n_rows][3] fp32.
int nefii_sdf_value(const void* pts, const void* tc, const void* wbuf, const long long* desc,
                    int n_layers, int x_cols, int width, int multires, const void* wlast,
                    float b_last, void* sdf, long long n_rows, int grid, void* stream) {
  return launch_tc<true>(pts, tc, wbuf, desc, n_layers, x_cols, width, multires, wlast, b_last,
                         nullptr, sdf, n_rows, grid, stream);
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
