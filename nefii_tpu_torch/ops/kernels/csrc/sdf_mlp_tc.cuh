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
// Design (warp-specialised, persistent, one block per SM):
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

#include <cuda_bf16.h>

#include "sdf_mlp.cuh"

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

constexpr int TC_BM = 64;                            // rows a tile: the M of one wgmma
constexpr int TC_BK = 64;                            // K of a chunk: one 128-byte bf16 row
constexpr int TC_STAGES = 2;                         // weight ring depth
constexpr int TC_CONSUMERS = 256;                    // two warpgroups of 128
constexpr int TC_THREADS = TC_CONSUMERS + 128;       // and a producer warpgroup
constexpr int TC_CHUNK_BYTES = WIDTH * TC_BK * 2;    // a [512][64] bf16 weight chunk: 64 KB
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 2;     // a [64][64] bf16 activation chunk: 8 KB
constexpr int TC_RING_OFF = 0;                       // shared memory, from a 1024-aligned base
constexpr int TC_ACT_OFF = TC_RING_OFF + TC_STAGES * TC_CHUNK_BYTES;
constexpr int TC_X_OFF = TC_ACT_OFF + (WIDTH / TC_BK) * TC_TILE_BYTES;
constexpr int TC_RED_OFF = TC_X_OFF + TC_TILE_BYTES;
constexpr int TC_BAR_OFF = TC_RED_OFF + 2 * TC_BM * (int)sizeof(float);
constexpr int TC_SMEM = TC_BAR_OFF + 2 * TC_STAGES * 8 + 1024;  // + alignment slack

__device__ __forceinline__ int tc_chunks(int k) { return (k + TC_BK - 1) / TC_BK; }

// byte offset of element (row, k) of a [rows][64] bf16 tile in the 128-byte
// swizzled layout: the 16-byte group k/8 of a row sits at group (k/8) ^ (row % 8)
__device__ __forceinline__ uint32_t sw128(int row, int k) {
  return row * 128 + ((((k >> 3) ^ (row & 7)) << 4) | ((k & 7) << 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading byte offset is unused by this layout)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across wgmma_wait0
__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], both from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// global -> shared bulk copy whose completion counts `bytes` on mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// generic-proxy writes to shared memory become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier 1 over the two consumer warpgroups (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONSUMERS) : "memory");
}

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
  const uint32_t full0 = sbase + TC_BAR_OFF, empty0 = full0 + TC_STAGES * 8;
  float* red = reinterpret_cast<float*>(sm + TC_RED_OFF);  // [2][TC_BM] row partial sums
  const int tid = threadIdx.x;
  const long long n_tiles = (n_rows + TC_BM - 1) / TC_BM;
  int n_chunks = 0;
  for (int l = 0; l < plan.n; ++l) n_chunks += tc_chunks(plan.l[l].k_h) + tc_chunks(plan.l[l].k_x);

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrive, plus the bytes
      mbar_init(empty0 + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread streams every chunk of every tile --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == TC_CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1u);
          mbar_arrive_expect_tx(full0 + 8 * stage, TC_CHUNK_BYTES);
          const uint8_t* src = reinterpret_cast<const uint8_t*>(tc) + (long long)c * TC_CHUNK_BYTES;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bulk_g2s(ring + stage * TC_CHUNK_BYTES + q * (TC_CHUNK_BYTES / 4),
                     src + q * (TC_CHUNK_BYTES / 4), TC_CHUNK_BYTES / 4, full0 + 8 * stage);
          if (++stage == TC_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
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
  int stage = 0;
  uint32_t phase = 0;
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
        const uint32_t b = ring + stage * TC_CHUNK_BYTES + wg * (TC_CHUNK_BYTES / 2);
        mbar_wait(full0 + 8 * stage, phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk)
          wgmma_m64n256k16(acc, wgmma_desc(a + 32 * kk), wgmma_desc(b + 32 * kk),
                           (c > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait0();
        fence_operands(acc);
        if (tid % 128 == 0) mbar_arrive(empty0 + 8 * stage);  // this warpgroup is done with it
        if (++stage == TC_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
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
