// Tensor-core hidden chain of the SDF MLP in bf16 for sm_90a: K1's bf16 path
// (nefii_sdf_hidden_tc and nefii_sdf_value in fused_mlp.cu).
//
// Replaces the Pallas `_kernel` (nefii_tpu/ops/pallas/fused_mlp.py:136) at
// dtype bfloat16: per layer z = h W + b with bf16 operands and fp32
// accumulation (the skip layer's concat(h, x)/sqrt(2) folded into split
// weights), h = softplus(100 z)/100 rounded to bf16 after every layer.
//
// Bound. 3.7 MFLOP a point against ~100 B of input: compute-bound on the
// bf16 tensor cores (989 TFLOP/s: ~1 ms at 262,144 points). The weights
// (3.8 MB packed) do not fit in shared memory, so every 64-row tile streams
// all of them from L2: 4,096 tiles x 3.8 MB = 15.6 GB of L2 reads at 262,144
// points. Beside that streaming, the epilogue's exp and log on the
// special-function unit take a large share of the time on an H100, since
// the products do not overlap it: both warpgroups wait for the layer's last
// wgmma (PERF.md).
//
// Design (warp-specialised, persistent, one block per SM; the building
// blocks, shared with K2's sdf_mlp_split.cuh, are in tc_common.cuh):
//   * a tile is 64 rows, the M of one wgmma. Two consumer warpgroups each own
//     256 of the 512 output columns (wgmma.mma_async m64n256k16, bf16 -> fp32)
//     and keep their 64x256 fp32 accumulator in registers, 128 a thread.
//   * the activation tile, 64 x 512 bf16, is the A operand in shared memory
//     (64 KB) in the 128-byte swizzled K-major layout that the descriptor
//     names, as eight [64][64] chunks; the 64 x 64 bf16 embedding tile (x,
//     zero padded) beside it feeds layer 0 and the skip layer's x part.
//   * one thread of a producer warpgroup (which gives its registers to the
//     consumers with setmaxnreg) streams the weights through a ring of
//     TC_STAGES 64 KB stages with cp.async.bulk and mbarriers: chunk c of the
//     packed buffer is the [512 out][64 in] K-major slice c, pre-swizzled by
//     prepare_weights, so one contiguous bulk copy lands it in the layout the
//     B descriptor reads. The producer walks the same (tile, chunk) sequence
//     as the consumers.
//   * epilogue in registers: bias, softplus100_tc, round to bf16, written back
//     into the A tile once every wgmma of the layer has retired in both
//     warpgroups (wait_group 0, then a named barrier over the 256 consumers).
//     The last layer either stores h (nefii_sdf_hidden_tc) or reduces each row
//     of the bf16-rounded h against the sdf column of the final linear in
//     fp32 and stores sdf [N] (nefii_sdf_value), so h never reaches memory.

#pragma once

#include "tc_common.cuh"

namespace {

// softplus(100 z)/100 on the special-function unit: exp and log from the
// hardware's exp2/log2 (__expf, __logf). log(1 + e) instead of log1p(e) loses
// e below 2^-24 and bits of it below ~1e-3, an absolute error under 4e-9 in
// h: nothing against the 2^-8 relative rounding to bf16 that follows, or
// the 1e-2 bound of the kernel against its plain version. libm's
// expf/log1pf (softplus100), or a series for small e behind a branch, made
// the epilogue the largest part of the kernel's time.
__device__ __forceinline__ float softplus100_tc(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + __logf(1.0f + __expf(-fabsf(t)))) * 0.01f;
}

constexpr int TC_BK = 64;                            // K of a chunk: one 128-byte bf16 row
constexpr int TC_STAGES = 2;                         // weight ring depth
constexpr int TC_CHUNK_BYTES = WIDTH * TC_BK * 2;    // a [512][64] bf16 weight chunk: 64 KB
constexpr int TC_RING_OFF = 0;                       // shared memory, from a 1024-aligned base
constexpr int TC_ACT_OFF = TC_RING_OFF + TC_STAGES * TC_CHUNK_BYTES;
constexpr int TC_X_OFF = TC_ACT_OFF + (WIDTH / TC_BK) * TC_TILE_BYTES;
constexpr int TC_RED_OFF = TC_X_OFF + TC_TILE_BYTES;
constexpr int TC_BAR_OFF = TC_RED_OFF + 2 * TC_BM * (int)sizeof(float);
constexpr int TC_SMEM = TC_BAR_OFF + 2 * TC_STAGES * 8 + 1024;  // + alignment slack

__device__ __forceinline__ int tc_chunks(int k) { return (k + TC_BK - 1) / TC_BK; }

__device__ __forceinline__ float2 ld_bf162(const __nv_bfloat16* p) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// SDF = false: out_h[n_rows][WIDTH] bf16, the last hidden state.
// SDF = true:  out_sdf[n_rows] fp32 = h . wlast + b_last.
// tc: the packed, swizzled [512][64] weight chunks of every layer in order
// (h part, then x part); wbuf: the bf16 buffer the biases are read from.
template <bool SDF>
__global__ void __launch_bounds__(TC_THREADS, 1)
sdf_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ tc,
              const __nv_bfloat16* __restrict__ wbuf, const __grid_constant__ Plan plan,
              const float* __restrict__ wlast, float b_last, __nv_bfloat16* __restrict__ out_h,
              float* __restrict__ out_sdf, long long n_rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);
  const uint32_t ring = sbase + TC_RING_OFF, act = sbase + TC_ACT_OFF, xs = sbase + TC_X_OFF;
  const uint32_t bars = sbase + TC_BAR_OFF;
  float* red = reinterpret_cast<float*>(sm + TC_RED_OFF);  // [2][TC_BM] row partial sums
  const int tid = threadIdx.x;
  const long long n_tiles = (n_rows + TC_BM - 1) / TC_BM;
  int n_chunks = 0;
  for (int l = 0; l < plan.n; ++l) n_chunks += tc_chunks(plan.l[l].k_h) + tc_chunks(plan.l[l].k_x);

  if (tid == 0) ring_init<TC_STAGES>(bars);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread streams every chunk of every tile --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == TC_CONSUMERS)
      ring_produce<TC_STAGES, TC_CHUNK_BYTES>(ring, bars, reinterpret_cast<const uint8_t*>(tc),
                                              n_chunks, n_tiles);
    return;
  }

  // ---- consumers: the registers the producer gave up (232 a thread: the
  // 128 accumulators without spills; the launch bound allows 168) ----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128;                         // output columns [256 wg, 256 wg + 256)
  const int lane = tid % 32;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // its columns 8 j + cq, 8 j + cq + 1
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  Ring<TC_STAGES> rg(bars);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * TC_BM;
    // x tile [64][64]: zero past x_cols and past the last row
    for (int u = tid; u < TC_BM * 8; u += TC_CONSUMERS) {
      const int r = u / 8, g = u % 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g * 8 < plan.x_cols && row0 + r < n_rows)
        v = __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * plan.x_cols + g * 8));
      *reinterpret_cast<uint4*>(sm + TC_X_OFF + sw128(r, g * 8)) = v;
    }
    fence_proxy_async();
    consumers_sync();

    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
      const int nh = tc_chunks(L.k_h), nc = nh + tc_chunks(L.k_x);
      for (int c = 0; c < nc; ++c) {
        const uint32_t a = (l == 0 || c >= nh) ? xs : act + c * TC_TILE_BYTES;
        const uint32_t b = ring + rg.stage * TC_CHUNK_BYTES + wg * (TC_CHUNK_BYTES / 2);
        rg.wait_full();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)
          wgmma_m64n256k16(acc, wgmma_desc(a + 32 * kk), wgmma_desc(b + 32 * kk),
                           (c > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(acc);
        if (tid % 128 == 0) mbar_arrive(rg.empty(rg.stage));  // this warpgroup is done with it
        rg.next();
      }

      // ---- epilogue: bias, softplus100, bf16 ----------------------------
      const bool last = l == plan.n - 1;
      consumers_sync();  // every wgmma of both warpgroups has read act and xs
      const __nv_bfloat16* bias = wbuf + L.b + 256 * wg + cq;
      if (SDF && last) {
        const float* wl = wlast + 256 * wg + cq;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 bj = ld_bf162(bias + 8 * j);
          const float2 wj = __ldg(reinterpret_cast<const float2*>(wl + 8 * j));
          s0 += round_bf16(softplus100_tc(acc[4 * j] + bj.x)) * wj.x +
                round_bf16(softplus100_tc(acc[4 * j + 1] + bj.y)) * wj.y;
          s1 += round_bf16(softplus100_tc(acc[4 * j + 2] + bj.x)) * wj.x +
                round_bf16(softplus100_tc(acc[4 * j + 3] + bj.y)) * wj.y;
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (lane % 4 == 0) {
          red[wg * TC_BM + r0] = s0;
          red[wg * TC_BM + r0 + 8] = s1;
        }
        consumers_sync();
        if (tid < TC_BM && row0 + tid < n_rows)
          out_sdf[row0 + tid] = red[tid] + red[TC_BM + tid] + b_last;
      } else {
        uint8_t* arow = sm + TC_ACT_OFF + 4 * wg * TC_TILE_BYTES + r0 * 128 + cq * 2;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 bj = ld_bf162(bias + 8 * j);
          const uint32_t off = (j / 8) * TC_TILE_BYTES + ((((j & 7) ^ (r0 & 7))) << 4);
          *reinterpret_cast<__nv_bfloat162*>(arow + off) = __floats2bfloat162_rn(
              softplus100_tc(acc[4 * j] + bj.x), softplus100_tc(acc[4 * j + 1] + bj.y));
          *reinterpret_cast<__nv_bfloat162*>(arow + off + 8 * 128) = __floats2bfloat162_rn(
              softplus100_tc(acc[4 * j + 2] + bj.x), softplus100_tc(acc[4 * j + 3] + bj.y));
        }
        fence_proxy_async();
        consumers_sync();
        if (!SDF && last) {
          // un-swizzle the tile into out_h, 16 bytes a thread a step
          for (int u = tid; u < TC_BM * (WIDTH / 8); u += TC_CONSUMERS) {
            const int r = u / (WIDTH / 8), g = u % (WIDTH / 8);
            if (row0 + r < n_rows)
              *reinterpret_cast<uint4*>(out_h + (row0 + r) * WIDTH + g * 8) =
                  *reinterpret_cast<const uint4*>(sm + TC_ACT_OFF + (g / 8) * TC_TILE_BYTES +
                                                  sw128(r, (g % 8) * 8));
          }
        }
      }
    }
  }
}

}  // namespace
