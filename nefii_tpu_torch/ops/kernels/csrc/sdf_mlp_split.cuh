// K2 on the tensor cores for sm_90a: the SDF MLP's forward and the input
// gradient of its sdf column, fp32-accurate in split bf16 (nefii_sdf_fwd_bwd
// in fused_mlp.cu), compiled for hidden widths W = 512 and W = 256.
//
// Replaces the Pallas `_kernel_fwd_bwd` (nefii_tpu/ops/pallas/fused_mlp.py:240):
// per point the hidden chain z_l = h W_l + b_l, h = softplus(100 z_l)/100
// (the skip layer's concat(h, x)/sqrt(2) folded into split weights); then,
// from the seed g = w_last[:, 0], per layer from the top g_z = g
// sigmoid(100 z_l) and g = g_z W_l^T, the skip layer's x part into its own
// accumulator. Out: the last h [N][W] and dx [N][x_cols], fp32.
//
// Arithmetic. Every operand v is split into hi = bf16(v) and lo = bf16(v -
// hi) (round to nearest even): the weights once, by split_weights
// (fused_mlp.py) at the first launch; h and g_z in the epilogue that writes
// them; x when it is loaded. Each product is A_hi.B_hi + A_lo.B_hi +
// A_hi.B_lo, three bf16 wgmma accumulated in fp32. What is dropped
// (A_lo.B_lo, and lo's own rounding) is ~2^-16 relative: on the 8x512 net
// the chain stays within ~1e-5 of fp32, where one bf16 or TF32 pass is 1e-3
// to 1e-2 off (fused_fwd_bwd_split_plain is this arithmetic in plain PyTorch; tests/test_torch_port_fused_mlp.py holds it against the
// JAX kernel).
//
// Bound. Forward and backward are 2 x 1.84 M multiply-adds a point at real
// widths, three bf16 products each: 22 MFLOP a point against ~2.3 KB of
// input and output, so the bf16 tensor cores bound it (5.8 ms at 262,144
// points, 989 TFLOP/s). The weights of both passes in hi and lo (15 MB
// packed, 920 records of 16 KB) do not fit on chip: every 64-row tile
// streams all of them from L2, 61.7 GB a call at 262,144 points, computed
// from the design. What set the pace on an H100 was how far the producer
// could run ahead, not what L2 serves: releasing each stage as soon as its
// products retire (below) cut the time by a quarter, while a 2-CTA cluster
// that multicasts every record into both blocks, halving the L2 requests,
// was slower than without it (PERF.md).
//
// Design (K1's skeleton, sdf_mlp_tc.cuh, on the blocks of tc_common.cuh):
//   * a persistent block of two consumer warpgroups and one producer
//     warpgroup (setmaxnreg 232 / 40) walks 64-row tiles. Each consumer
//     warpgroup owns W/2 output columns (wgmma m64n256k16 at 512, m64n128k16
//     at 256) and keeps its 64 x W/2 fp32 accumulator in registers. K1's
//     ping-pong of two tiles does not fit at 256: their hi and lo (128 KB)
//     and the ring pass the 227 KB a block has, so K2 keeps one tile.
//   * shared memory (227 KB a block): the activation tile in hi and lo,
//     2 x 64 KB at 512 (2 x 32 KB at 256), and the embedding tile in hi and
//     lo, 2 x 8 KB, 128-byte swizzled K-major as in K1, leave room for the
//     weight ring of 16 KB records: 5 stages at 512, 8 at 256. K1's 64-deep
//     chunks would need 128 KB a stage in hi and lo, so a record is the hi
//     or the lo half of k16 slices of a K-major [W][16] block in the 32-byte
//     swizzle: one slice at 512, two at 256. Per record pair: wait for the
//     hi record, A_hi.B_hi and A_lo.B_hi, commit; wait for the lo record,
//     A_hi.B_lo, commit. After each commit the record before retires
//     (wait_group 1) and its stage goes back to the producer, so a warpgroup
//     holds one stage beyond the one it reads and the producer runs ahead by
//     the rest of the ring.
//   * forward epilogue in registers: bias, then softplus and s_l =
//     sigmoid(100 z_l) from one exp; h split into the A tile; s_l stored to
//     the block's slot of a global scratch (sized by the resident blocks, 7 x
//     256 W bytes a block) in the accumulator's fragment order, so in the backward
//     the thread that holds g[r][c] reads back its own s_l[r][c] with
//     coalesced 16-byte loads and no shared-memory transpose; each backward
//     layer prefetches its s into L2 before its products. The last layer
//     stores h and seeds the backward, g_z = w_last[:, 0] s_7, from its
//     registers; its h store overlaps the first backward products.
//   * backward: A = g_z (hi, lo) against W_l itself, K-major along its output
//     dimension (N = k_h padded to W). Layer 0's output and the skip layer's
//     x part are x_cols wide: N padded to SP_NX = 64, 8 slices a record, into
//     a second accumulator (m64n32k16, 32 columns a warpgroup) that becomes dx.

#pragma once

#include "tc_common.cuh"

namespace {

constexpr int SP_REC = 16384;                      // bytes of one record (one stage)
constexpr int SP_NX = 64;                          // backward N of the x_cols-wide outputs
constexpr int SP_GX = SP_REC / (SP_NX * 32);       // k16 slices a record at N = SP_NX: 8

// The layout of K2 at hidden width W: the ring and shared memory (offsets
// from a 1024-aligned base). K3 (fused_trace.cu) builds on it.
template <int W>
struct SplitCfg {
  static_assert(W == 256 || W == 512, "K2 is compiled for W = 256, 512");
  static constexpr int NW = W / 2;                 // output columns a consumer warpgroup owns
  static constexpr int G = SP_REC / (W * 32);      // k16 slices a record at N = W: 1, 2
  static constexpr int STAGES = W == 512 ? 5 : 8;  // weight ring depth
  static constexpr int ACT = TC_BM * W * 2;        // hi or lo of the activation tile
  static constexpr int RING_OFF = 0;
  static constexpr int AHI_OFF = RING_OFF + STAGES * SP_REC;
  static constexpr int ALO_OFF = AHI_OFF + ACT;
  static constexpr int XHI_OFF = ALO_OFF + ACT;
  static constexpr int XLO_OFF = XHI_OFF + TC_TILE_BYTES;
  static constexpr int BAR_OFF = XLO_OFF + TC_TILE_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "K2 needs more shared memory than a block may use");
};

// records of the k16 slices of a K-deep operand, g slices a record, in hi and lo
__host__ __device__ constexpr int split_recs(int k, int g) { return 2 * ((k / 16 + g - 1) / g); }

// records a tile streams at width W, in the order the consumers read them
// (pack_split and split_records in fused_mlp.py write the same): per layer
// forward, the h part then the x part, G k16 slices of N = W a record, hi
// then lo; then per layer from the top backward, the h part (K = W; layer
// 0's at N = SP_NX, SP_GX slices a record) and the skip layer's x part (N =
// SP_NX). At 512: 1 slice a record, 64 records a backward layer, 8 at N =
// SP_NX.
template <int W>
__host__ __device__ inline int split_records(const Plan& p) {
  constexpr int G = SplitCfg<W>::G;
  int r = 0;
  for (int l = 0; l < p.n; ++l)
    r += split_recs(p.l[l].k_h, G) + split_recs(p.l[l].k_x, G) +
         (l > 0 ? split_recs(W, G) : split_recs(W, SP_GX)) +
         (p.l[l].k_x > 0 ? split_recs(W, SP_GX) : 0);
  return r;
}

// softplus(100 z)/100 and sigmoid(100 z) from one exp on the special-function
// unit. log(1 + e) instead of log1p(e) and __expf/__logf cost under 4e-9 in
// h, nothing against the split arithmetic's ~2^-16; 1 + e lies in [1, 2],
// where __fdividef is within 2 ulp. (libm's expf/log1pf made K1's epilogue
// the largest part of its time, sdf_mlp_tc.cuh.)
__device__ __forceinline__ void softplus_sigmoid100(float z, float& h, float& s) {
  const float t = 100.0f * z;
  const float e = __expf(-fabsf(t));
  const float inv = __fdividef(1.0f, 1.0f + e);
  h = (fmaxf(t, 0.0f) + __logf(1.0f + e)) * 0.01f;
  s = t >= 0.0f ? inv : e * inv;
}

// hi = bf16(a), lo = bf16(a - hi), two values at a time, as two packed
// pairs; with F16 the same in fp16 (K3's split)
template <bool F16 = false>
__device__ __forceinline__ void split2u(float a, float b, uint32_t& hi, uint32_t& lo) {
  if constexpr (F16) {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 f = __half22float2(h);
    const __half2 l = __floats2half2_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// this thread's values (r0, c), (r0, c + 1), (r0 + 8, c), (r0 + 8, c + 1)
// of column group j into the A tile, hi at `arow`, lo LO bytes beyond it
// (arow: the thread's row r0 and columns in the warpgroup's first chunk)
template <bool F16, int LO>
__device__ __forceinline__ void put_split(uint8_t* arow, int j, int r0, float v0, float v1,
                                          float v2, float v3) {
  const uint32_t off = (j / 8) * TC_TILE_BYTES + (((j & 7) ^ (r0 & 7)) << 4);
  uint32_t hi, lo;
  split2u<F16>(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(arow + off) = hi;
  *reinterpret_cast<uint32_t*>(arow + LO + off) = lo;
  split2u<F16>(v2, v3, hi, lo);
  *reinterpret_cast<uint32_t*>(arow + off + 8 * 128) = hi;
  *reinterpret_cast<uint32_t*>(arow + LO + off + 8 * 128) = lo;
}

// Each record's products are one commit group. Commit the group reading
// `stage`; once the group before it has retired (wait_group 1), give that
// group's stage `held` back to the producer. A warpgroup so holds one stage
// beyond the one it reads.
template <int STAGES, int R>
__device__ __forceinline__ void commit_release(float (&acc)[R], const Ring<STAGES>& rg,
                                               int& held, int stage, bool leader) {
  wgmma_commit();
  wgmma_wait<1>();
  fence_operands(acc);
  if (leader && held >= 0) mbar_arrive(rg.empty(held));
  held = stage;
}

// acc (+)= A . B over n_slices k16 slices (rounded up to whole records,
// whose padding is zero): A from the tile (hi at a_hi, lo at a_lo, [64][64]
// chunks in the 128-byte swizzle), B from the ring's records. NW = 256: one
// slice of B rows [256 wg, 256 wg + 256) of 512 a record; NW = 128: two
// slices of B rows [128 wg, 128 wg + 128) of 256; NW = 32: SP_GX slices of B
// rows [32 wg, 32 wg + 32) of SP_NX. The first product scales the old sum by
// scale_first (0: a fresh sum).
template <int NW, int STAGES>
__device__ __forceinline__ void split_gemm(float (&acc)[NW / 2], uint32_t a_hi, uint32_t a_lo,
                                           int n_slices, uint32_t ring, Ring<STAGES>& rg,
                                           int wg, int scale_first, bool leader) {
  constexpr int G = SP_REC / (2 * NW * 32);  // slices a record
  constexpr uint32_t SLICE = 2 * NW * 32;    // bytes of one slice of all the B rows
  int held = -1;  // the stage whose products are still in flight
  for (int j0 = 0; j0 < n_slices; j0 += G) {
    int st = rg.stage;  // hi record: A_hi.B_hi and A_lo.B_hi
    uint32_t b = ring + st * SP_REC + wg * NW * 32;
    rg.wait_full();
    rg.next();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int j = j0 + s;
      const uint32_t ak = (j / 4) * TC_TILE_BYTES + 32 * (j % 4);
      const uint64_t bd = wgmma_desc32(b + s * SLICE);
      wgmma_k16(acc, wgmma_desc(a_hi + ak), bd, j > 0 ? 1 : scale_first);
      wgmma_k16(acc, wgmma_desc(a_lo + ak), bd, 1);
    }
    commit_release(acc, rg, held, st, leader);
    st = rg.stage;  // lo record: A_hi.B_lo
    b = ring + st * SP_REC + wg * NW * 32;
    rg.wait_full();
    rg.next();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int j = j0 + s;
      const uint32_t ak = (j / 4) * TC_TILE_BYTES + 32 * (j % 4);
      wgmma_k16(acc, wgmma_desc(a_hi + ak), wgmma_desc32(b + s * SLICE), 1);
    }
    commit_release(acc, rg, held, st, leader);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (leader && held >= 0) mbar_arrive(rg.empty(held));
}

// x [n_rows][x_cols], h_out [n_rows][W], dx_out [n_rows][x_cols] fp32;
// rec: split_records<W>(plan) records of SP_REC bytes (pack_split); wbuf:
// the fp32 buffer the biases are read from; wlast [W]: the sdf column of the
// final linear; sbuf: gridDim.x x (plan.n - 1) x TC_BM x W floats.
template <int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
sdf_split_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ rec,
                 const float* __restrict__ wbuf, const __grid_constant__ Plan plan,
                 const float* __restrict__ wlast, float* __restrict__ h_out,
                 float* __restrict__ dx_out, float* sbuf, int n_rec, long long n_rows) {
  using C = SplitCfg<W>;
  constexpr int NW = C::NW, J = NW / 8;  // columns, and 8-column groups, a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);
  const uint32_t ring = sbase + C::RING_OFF, bars = sbase + C::BAR_OFF;
  const uint32_t a_hi = sbase + C::AHI_OFF, a_lo = sbase + C::ALO_OFF;
  const uint32_t x_hi = sbase + C::XHI_OFF, x_lo = sbase + C::XLO_OFF;
  const int tid = threadIdx.x;
  const int xc = plan.x_cols;
  const long long n_tiles = (n_rows + TC_BM - 1) / TC_BM;

  if (tid == 0) ring_init<C::STAGES>(bars);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread streams every record of every tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == TC_CONSUMERS)
      ring_produce<C::STAGES, SP_REC>(ring, bars, reinterpret_cast<const uint8_t*>(rec), n_rec,
                                      n_tiles);
    return;
  }

  // ---- consumers ----------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128;                           // output columns [NW wg, NW wg + NW)
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int r0 = 16 * ((tid % 128) / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);
  const int c0 = NW * wg + cq;                        // its columns c0 + 8 j, c0 + 8 j + 1
  uint8_t* arow = sm + C::AHI_OFF + (NW / 64) * wg * TC_TILE_BYTES + r0 * 128 + cq * 2;
  // s_l of this thread: float4 j of layer l at s_mine[(l * J + j) * 4 * TC_CONSUMERS]
  float* s_mine = sbuf + (long long)blockIdx.x * (plan.n - 1) * TC_BM * W + 4 * tid;
  float acc[NW / 2], gx[16];
  Ring<C::STAGES> rg(bars);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * TC_BM;
    // x tile [64][64] in hi and lo: zero past x_cols and past the last row
    for (int u = tid; u < TC_BM * 8; u += TC_CONSUMERS) {
      const int r = u / 8, g = u % 8;
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
      if (g * 8 < xc && row0 + r < n_rows) {
        const float4* p = reinterpret_cast<const float4*>(x + (row0 + r) * xc + g * 8);
        v0 = __ldg(p);
        v1 = __ldg(p + 1);
      }
      uint4 hi, lo;
      split2u(v0.x, v0.y, hi.x, lo.x);
      split2u(v0.z, v0.w, hi.y, lo.y);
      split2u(v1.x, v1.y, hi.z, lo.z);
      split2u(v1.z, v1.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(sm + C::XHI_OFF + sw128(r, g * 8)) = hi;
      *reinterpret_cast<uint4*>(sm + C::XLO_OFF + sw128(r, g * 8)) = lo;
    }
    fence_proxy_async();
    consumers_sync();

    // ---- forward ---------------------------------------------------------
    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
      split_gemm<NW>(acc, l == 0 ? x_hi : a_hi, l == 0 ? x_lo : a_lo, L.k_h / 16, ring, rg, wg,
                     0, leader);
      if (L.k_x > 0) split_gemm<NW>(acc, x_hi, x_lo, L.k_x / 16, ring, rg, wg, 1, leader);
      consumers_sync();  // every product of both warpgroups has read the A tile
      const float* bias = wbuf + L.b + c0;
      float* s_out = s_mine + (long long)l * TC_BM * W;
      if (l < plan.n - 1) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          float h0, h1, h2, h3, s0, s1, s2, s3;
          softplus_sigmoid100(acc[4 * j] + b.x, h0, s0);
          softplus_sigmoid100(acc[4 * j + 1] + b.y, h1, s1);
          softplus_sigmoid100(acc[4 * j + 2] + b.x, h2, s2);
          softplus_sigmoid100(acc[4 * j + 3] + b.y, h3, s3);
          *reinterpret_cast<float4*>(s_out + j * 4 * TC_CONSUMERS) = make_float4(s0, s1, s2, s3);
          put_split<false, C::ACT>(arow, j, r0, h0, h1, h2, h3);
        }
      } else {
        // the last layer: store h, and seed the backward with g_z = w_last s
        const bool in0 = row0 + r0 < n_rows, in1 = row0 + r0 + 8 < n_rows;
        float* h0p = h_out + (row0 + r0) * W + c0;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          const float2 w = __ldg(reinterpret_cast<const float2*>(wlast + c0 + 8 * j));
          float h0, h1, h2, h3, s0, s1, s2, s3;
          softplus_sigmoid100(acc[4 * j] + b.x, h0, s0);
          softplus_sigmoid100(acc[4 * j + 1] + b.y, h1, s1);
          softplus_sigmoid100(acc[4 * j + 2] + b.x, h2, s2);
          softplus_sigmoid100(acc[4 * j + 3] + b.y, h3, s3);
          if (in0) *reinterpret_cast<float2*>(h0p + 8 * j) = make_float2(h0, h1);
          if (in1) *reinterpret_cast<float2*>(h0p + 8 * W + 8 * j) = make_float2(h2, h3);
          put_split<false, C::ACT>(arow, j, r0, w.x * s0, w.y * s1, w.x * s2, w.y * s3);
        }
      }
      fence_proxy_async();
      consumers_sync();
    }

    // ---- backward of the sdf column ----------------------------------------
#pragma unroll
    for (int i = 0; i < 16; ++i) gx[i] = 0.0f;
    for (int l = plan.n - 1; l >= 0; --l) {
      const Layer& L = plan.l[l];
      const float* s_in = s_mine + (long long)max(l - 1, 0) * TC_BM * W;
      // bring this thread's s_{l-1} from memory into L2 while the products run
      if (l > 0 && tid % 8 == 0)
#pragma unroll
        for (int j = 0; j < J; ++j)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(s_in + j * 4 * TC_CONSUMERS));
      if (l > 0)
        split_gemm<NW>(acc, a_hi, a_lo, W / 16, ring, rg, wg, 0, leader);
      else
        split_gemm<32>(gx, a_hi, a_lo, W / 16, ring, rg, wg, 1, leader);
      if (L.k_x > 0) split_gemm<32>(gx, a_hi, a_lo, W / 16, ring, rg, wg, 1, leader);
      if (l == 0) break;
      consumers_sync();  // every product of both warpgroups has read g_z
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 s = *reinterpret_cast<const float4*>(s_in + j * 4 * TC_CONSUMERS);
        put_split<false, C::ACT>(arow, j, r0, acc[4 * j] * s.x, acc[4 * j + 1] * s.y, acc[4 * j + 2] * s.z,
                  acc[4 * j + 3] * s.w);
      }
      fence_proxy_async();
      consumers_sync();
    }
    // dx: this warpgroup's columns 32 wg + 8 j + cq of gx
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * wg + 8 * j + cq;
      if (c >= xc) continue;
      if (row0 + r0 < n_rows)
        *reinterpret_cast<float2*>(dx_out + (row0 + r0) * xc + c) = make_float2(gx[4 * j], gx[4 * j + 1]);
      if (row0 + r0 + 8 < n_rows)
        *reinterpret_cast<float2*>(dx_out + (row0 + r0 + 8) * xc + c) =
            make_float2(gx[4 * j + 2], gx[4 * j + 3]);
    }
  }
}

}  // namespace
