// Tensor-core hidden chain of the SDF MLP in bf16 for sm_90a: K1's bf16 path
// (nefii_sdf_hidden_tc and nefii_sdf_value in fused_mlp.cu), compiled for
// hidden widths W = 512 and W = 256.
//
// Replaces the Pallas `_kernel` (nefii_tpu/ops/pallas/fused_mlp.py:136) at
// dtype bfloat16: per layer z = h W + b with bf16 operands and fp32
// accumulation (the skip layer's concat(h, x)/sqrt(2) folded into split
// weights), h = softplus(100 z)/100 rounded to bf16 after every layer. The
// Pallas kernel pads each layer to 128 lanes; here a net runs at the
// smallest compiled width that holds it (NeuS's 8x256 at 256).
//
// Bound. 3.7 MFLOP a point on the 8x512 net (0.94 on the 8x256) against
// ~100 B of input: compute-bound on the bf16 tensor cores (989 TFLOP/s:
// ~1 ms at 262,144 points on the 8x512). The weights (3.8 MB packed at 512)
// do not fit in shared memory, so every block step streams all of them from
// L2: at 512, 4,096 tiles x 3.8 MB = 15.6 GB of L2 reads at 262,144 points,
// which sets the pace with the epilogue's exp and log on the special-function
// unit (PERF.md).
//
// Design (warp-specialised, persistent, one block per SM; the building
// blocks, shared with K2's sdf_mlp_split.cuh, are in tc_common.cuh). A
// consumer warpgroup always owns 256 output columns of a 64-row tile
// (wgmma.mma_async m64n256k16, bf16 -> fp32) and keeps its 64x256 fp32
// accumulator in registers, 128 a thread:
//   * W = 512: the two consumer warpgroups share one tile, 256 columns each;
//     the layer's epilogue waits for both (a named barrier over the 256).
//   * W = 256: each warpgroup owns a whole tile of its own, so a block step
//     holds two tiles (128 rows) and every weight chunk streamed from L2
//     serves both, half the L2 bytes a row of 512's. The two run in
//     ping-pong: a warpgroup starts a layer's products only once the other
//     has issued (and retired) its products of its current layer up to the
//     ring's depth, so one tile's softplus epilogue runs while the other's
//     wgmma does (two named barriers, one a warpgroup).
//   * the activation tile, 64 x W bf16, is the A operand in shared memory in
//     the 128-byte swizzled K-major layout that the descriptor names, as W/64
//     [64][64] chunks; the 64 x 64 bf16 embedding tile (x, zero padded)
//     beside it feeds layer 0 and the skip layer's x part.
//   * the sdf entry takes the points, [N][3] fp32, and fills the embedding
//     tile itself: each consumer thread of the tile encodes its share of the
//     tile's rows (encode_rows, sdf_mlp.cuh: embed_value's arithmetic, the
//     encoding K3 computes, rounded to bf16 as fused_mlp.embed_padded rounds
//     it), so the tile holds what the embedded input held, bit for bit; the
//     columns from d_emb on are zeroed once. The encoding sits on the
//     critical path: at W = 512 between a tile's last epilogue and its next
//     products, at W = 256 beside the other warpgroup's last products, which
//     are shorter than an epilogue. So it waits on no load: each thread
//     fetches its share of the next step's points (768 bytes a tile) into
//     registers a whole step ahead and stages them in shared memory at the
//     step's start; and a unit's six sinf/cosf run as independent chains (at
//     multires 6, 18 a thread a tile at W = 256). The hidden entry, on no
//     path, keeps the embedded input [N][x_cols] bf16.
//   * one thread of a producer warpgroup (which gives its registers to the
//     consumers with setmaxnreg) streams the weights through a ring of
//     [W][64] chunks, 128 KB at either width (2 stages of 64 KB at 512, 4 of
//     32 KB at 256), with cp.async.bulk and mbarriers: chunk c of the packed
//     buffer is the [W out][64 in] K-major slice c, pre-swizzled by pack_tc
//     (fused_mlp.py), so one contiguous bulk copy lands it in the layout the
//     B descriptor reads. A stage goes back to the producer once both
//     consumer warpgroups have read it. The producer walks the same (step,
//     chunk) sequence as the consumers.
//   * epilogue in registers: bias, softplus100_tc, round to bf16, written back
//     into the A tile once every wgmma of the layer on that tile has retired.
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

constexpr int TC_BK = 64;  // K of a chunk: one 128-byte bf16 row

// The layout of K1 at hidden width W: tiles a block step holds, the ring and
// shared memory (offsets from a 1024-aligned base).
template <int W>
struct TcCfg {
  static_assert(W == 256 || W == 512, "K1 on the tensor cores is compiled for W = 256, 512");
  static constexpr int WG_PER_TILE = W / 256;            // consumer warpgroups on one tile
  static constexpr int TILES = 2 / WG_PER_TILE;          // tiles a block step holds
  static constexpr int TILE_THREADS = 128 * WG_PER_TILE;
  static constexpr int CHUNK = W * TC_BK * 2;            // a [W][64] bf16 weight chunk
  static constexpr int STAGES = 2 * 512 / W;             // weight ring depth: 128 KB
  static constexpr int ACT = (W / TC_BK) * TC_TILE_BYTES;  // one 64 x W bf16 activation tile
  static constexpr int RING_OFF = 0;
  static constexpr int ACT_OFF = RING_OFF + STAGES * CHUNK;
  static constexpr int X_OFF = ACT_OFF + TILES * ACT;
  static constexpr int RED_OFF = X_OFF + TILES * TC_TILE_BYTES;
  static constexpr int PTS_OFF = RED_OFF + 2 * TC_BM * (int)sizeof(float);  // the sdf entry's
  static constexpr int PTS = 3 * TC_BM;                   // floats of a tile's points
  static constexpr int PTS_PER_THREAD = (PTS + TILE_THREADS - 1) / TILE_THREADS;
  static constexpr int BAR_OFF = PTS_OFF + TILES * PTS * (int)sizeof(float);
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "K1 needs more shared memory than a block may use");
};

__device__ __forceinline__ int tc_chunks(int k) { return (k + TC_BK - 1) / TC_BK; }

__device__ __forceinline__ float2 ld_bf162(const __nv_bfloat16* p) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// every consumer thread of tile t: all 256 at W = 512 (barrier 1), the tile's
// warpgroup at W = 256 (barrier 2 + t)
template <int W>
__device__ __forceinline__ void tile_sync(int t) {
  if constexpr (TcCfg<W>::TILES == 1)
    consumers_sync();
  else
    named_sync(2 + t, 128);
}

// SDF = false: x[n_rows][x_cols] bf16, the embedded points ->
//              out_h[n_rows][W] bf16, the last hidden state.
// SDF = true:  pts[n_rows][3] fp32, encoded here at plan.d_emb columns ->
//              out_sdf[n_rows] fp32 = h . wlast + b_last.
// tc: the packed, swizzled [W][64] weight chunks of every layer in order
// (h part, then x part); wbuf: the bf16 buffer the biases are read from.
template <int W, bool SDF>
__global__ void __launch_bounds__(TC_THREADS, 1)
sdf_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ pts,
              const __nv_bfloat16* __restrict__ tc,
              const __nv_bfloat16* __restrict__ wbuf, const __grid_constant__ Plan plan,
              const float* __restrict__ wlast, float b_last, __nv_bfloat16* __restrict__ out_h,
              float* __restrict__ out_sdf, long long n_rows) {
  using C = TcCfg<W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);
  const uint32_t ring = sbase + C::RING_OFF;
  const uint32_t bars = sbase + C::BAR_OFF;
  float* red = reinterpret_cast<float*>(sm + C::RED_OFF);  // [2][TC_BM] row partial sums
  const int tid = threadIdx.x;
  const long long n_tiles = (n_rows + TC_BM - 1) / TC_BM;
  const long long n_steps = (n_tiles + C::TILES - 1) / C::TILES;
  int n_chunks = 0;
  for (int l = 0; l < plan.n; ++l) n_chunks += tc_chunks(plan.l[l].k_h) + tc_chunks(plan.l[l].k_x);

  if (tid == 0) ring_init<C::STAGES>(bars);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread streams every chunk of every step --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == TC_CONSUMERS)
      ring_produce<C::STAGES, C::CHUNK>(ring, bars, reinterpret_cast<const uint8_t*>(tc),
                                        n_chunks, n_steps);
    return;
  }

  // ---- consumers: the registers the producer gave up (232 a thread: the
  // 128 accumulators without spills; the launch bound allows 168) ----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128;
  const int t = C::TILES == 1 ? 0 : wg;             // this warpgroup's tile of the step
  const int col0 = C::TILES == 1 ? 256 * wg : 0;    // its output columns [col0, col0 + 256)
  const int ttid = C::TILES == 1 ? tid : tid % 128;  // its index among the tile's threads
  const int lane = tid % 32;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // its columns col0 + 8 j + cq, + 1
  const uint32_t act = sbase + C::ACT_OFF + t * C::ACT;
  const uint32_t xs = sbase + C::X_OFF + t * TC_TILE_BYTES;
  uint8_t* const act_p = sm + C::ACT_OFF + t * C::ACT;
  uint8_t* const xs_p = sm + C::X_OFF + t * TC_TILE_BYTES;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  Ring<C::STAGES> rg(bars);
  // the sdf entry: this tile's points staged [64][3], and this thread's share
  // of the next step's, fetched a step ahead
  float* const pts_s = reinterpret_cast<float*>(sm + C::PTS_OFF) + t * C::PTS;
  float pnext[C::PTS_PER_THREAD];
  auto fetch = [&](long long step) {
    const long long f0 = (step * C::TILES + t) * C::PTS;
#pragma unroll
    for (int i = 0; i < C::PTS_PER_THREAD; ++i) {
      const int f = ttid + i * C::TILE_THREADS;
      pnext[i] = (f < C::PTS && f0 + f < 3 * n_rows) ? __ldg(pts + f0 + f) : 0.0f;
    }
  };
  if constexpr (SDF) {
    // the encoding fills the columns below d_emb of every step's x tile
    for (int u = ttid; u < TC_BM * TC_BK; u += C::TILE_THREADS)
      if (u % TC_BK >= plan.d_emb)
        *reinterpret_cast<__nv_bfloat16*>(xs_p + sw128(u / TC_BK, u % TC_BK)) =
            __float2bfloat16_rn(0.0f);
    fetch(blockIdx.x);
  }
  for (long long step = blockIdx.x; step < n_steps; step += gridDim.x) {
    const long long row0 = (step * C::TILES + t) * TC_BM;
    if constexpr (SDF) {
#pragma unroll
      for (int i = 0; i < C::PTS_PER_THREAD; ++i)
        if (ttid + i * C::TILE_THREADS < C::PTS) pts_s[ttid + i * C::TILE_THREADS] = pnext[i];
      tile_sync<W>(t);
      if (step + gridDim.x < n_steps) fetch(step + gridDim.x);
      // x tile [64][64]: the rows' points encoded, zero past the last row
      encode_rows<TC_BM>(pts_s, (int)max(0LL, min((long long)TC_BM, n_rows - row0)), plan.d_emb,
                         ttid, C::TILE_THREADS, [&](int r, int c, float v) {
                           *reinterpret_cast<__nv_bfloat16*>(xs_p + sw128(r, c)) =
                               __float2bfloat16_rn(v);
                         });
    } else {
      // x tile [64][64]: zero past x_cols and past the last row
      for (int u = ttid; u < TC_BM * 8; u += C::TILE_THREADS) {
        const int r = u / 8, g = u % 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (g * 8 < plan.x_cols && row0 + r < n_rows)
          v = __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * plan.x_cols + g * 8));
        *reinterpret_cast<uint4*>(xs_p + sw128(r, g * 8)) = v;
      }
    }
    fence_proxy_async();
    tile_sync<W>(t);

    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
      const int nh = tc_chunks(L.k_h), nc = nh + tc_chunks(L.k_x);
      // ping-pong (W = 256): wait until the other warpgroup has issued and
      // retired its products of its current layer up to the ring's depth;
      // warpgroup 0 starts the block's first layer at once
      if constexpr (C::TILES == 2)
        if (t == 1 || step != blockIdx.x || l > 0) named_sync(4 + t, 256);
      for (int c = 0; c < nc; ++c) {
        const uint32_t a = (l == 0 || c >= nh) ? xs : act + c * TC_TILE_BYTES;
        const uint32_t b = ring + rg.stage * C::CHUNK + col0 * TC_BK * 2;
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
        // ping-pong: let the other warpgroup start this layer (warpgroup 1
        // skips its block's last signal, which no one would wait for)
        if constexpr (C::TILES == 2)
          if (c == min(nc, C::STAGES) - 1 &&
              (t == 0 || step + gridDim.x < n_steps || l < plan.n - 1))
            named_arrive(4 + (1 - t), 256);
      }

      // ---- epilogue: bias, softplus100, bf16 ----------------------------
      const bool last = l == plan.n - 1;
      tile_sync<W>(t);  // every wgmma on this tile has read act and xs
      const __nv_bfloat16* bias = wbuf + L.b + col0 + cq;
      if (SDF && last) {
        const float* wl = wlast + col0 + cq;
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
        if constexpr (C::WG_PER_TILE == 2) {
          // the row's two halves, one a warpgroup
          if (lane % 4 == 0) {
            red[wg * TC_BM + r0] = s0;
            red[wg * TC_BM + r0 + 8] = s1;
          }
          consumers_sync();
          if (tid < TC_BM && row0 + tid < n_rows)
            out_sdf[row0 + tid] = red[tid] + red[TC_BM + tid] + b_last;
        } else if (lane % 4 == 0) {
          if (row0 + r0 < n_rows) out_sdf[row0 + r0] = s0 + b_last;
          if (row0 + r0 + 8 < n_rows) out_sdf[row0 + r0 + 8] = s1 + b_last;
        }
      } else {
        uint8_t* arow = act_p + 4 * (col0 / 256) * TC_TILE_BYTES + r0 * 128 + cq * 2;
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
        tile_sync<W>(t);
        if (!SDF && last) {
          // un-swizzle the tile into out_h, 16 bytes a thread a step
          for (int u = ttid; u < TC_BM * (W / 8); u += C::TILE_THREADS) {
            const int r = u / (W / 8), g = u % (W / 8);
            if (row0 + r < n_rows)
              *reinterpret_cast<uint4*>(out_h + (row0 + r) * W + g * 8) =
                  *reinterpret_cast<const uint4*>(act_p + (g / 8) * TC_TILE_BYTES +
                                                  sw128(r, (g % 8) * 8));
          }
        }
      }
    }
  }
}

}  // namespace
