// K1 in fp32 on the FMA pipe for sm_90a: nefii_sdf_hidden and
// nefii_sdf_value_fp32 in fused_mlp.cu, compiled for hidden widths W = 256
// and W = 512.
//
// Replaces the Pallas `_kernel` (nefii_tpu/ops/pallas/fused_mlp.py:136) at
// dtype float32: per layer z = h W + b (the skip layer's concat(h, x)/sqrt(2)
// folded into split weights), h = softplus(100 z)/100. The SDF entry also
// computes build_fused_sdf's final column (fused_mlp.py:427-447) in the last
// layer's epilogue.
//
// Why the FMA pipe. K1 fp32 is the fp32 arbiter of K3's near decisions (its
// re-trace) and of the conf's fp32 trace: the answer has to be the fp32
// chain's, with a row's value independent of its batch. A split or TF32
// tensor-core chain would not be that answer (K2's wgmma accumulation alone
// drifts by ~7e-6, more than K3's NEAR_DELTA). So the chain runs as fp32
// FMAs, each output one fmaf chain with k ascending (W_h rows, then W_x rows),
// then the bias and softplus100: the arithmetic of the kernel this one
// replaced, bit for bit.
//
// Bound. 3.7 MFLOP a point on the 8x512 net (0.94 on the 8x256) against ~200
// B of input: the FP32 pipe (67 TFLOP/s) bounds it, 14.4 ms at 262,144 points
// on the 8x512. Two things stand between the pipe and the products:
//   * the operands. Every FMA needs an activation and a weight. A thread with
//     an 8 x 16 register tile loads 8 activations and 16 weights (six 16-byte
//     shared-memory loads) for 128 FMAs, so shared memory, which L1's loads
//     share, runs below its rate; the weights never go through __ldg in the
//     inner loop.
//   * the weights (7.4 MB in fp32 on the 8x512 net) do not fit on chip. Every
//     row tile streams all of them from L2, so the tile is as large as shared
//     memory allows: 64 rows at 512 and 128 at 256, each activation tile
//     128 KB, and every weight byte fetched serves that many rows (at 512,
//     ~30 GB requested from L2 per 262,144 points).
//
// Design (persistent, warp-specialised, one block per SM):
//   * one thread of a producer warpgroup (which gives its registers to the
//     consumers with setmaxnreg) streams the layers' weights, the row-major
//     [k][W] blocks of the packed buffer as they lie, in 16 KB slabs of
//     FMA_KS(W) rows (8 at 512, 16 at 256) through a ring of 4 stages with
//     cp.async.bulk and mbarriers (tc_common.cuh). A layer's W_h slabs come
//     first, then its W_x slabs. It walks the same (tile, layer, slab)
//     sequence as the consumers, so it runs ahead across layer and tile
//     boundaries: the next layer's first slabs land during the epilogue.
//   * two consumer warpgroups own the block's tile: thread (rg, cg) holds rows
//     8 rg .. 8 rg + 7 and columns q W/4 + 4 cg + {0..3}, q < 4, and reads
//     both operands from shared memory: the activations, feature-major
//     [k][BM] (an 8-row slice of one feature is two broadcast float4 loads),
//     and the slab (four float4 loads, a quarter-warp's lanes on one 128-byte
//     line). A warp's eight lanes that share a row group are eight column
//     groups.
//   * the activation tile's 8-row groups are swizzled by feature:
//     feature c keeps row group g at g ^ ((c >> 2) & 3) (fma_row). The
//     epilogue's stores of a quarter-warp (eight columns, one row group) then
//     fall into four bank groups, not one; the loads read one feature and stay
//     broadcasts.
//   * the epilogue: bias and softplus100 in registers, written back into the
//     activation tile in place once every consumer has read it (two named
//     barriers a layer over the consumers; the producer is never held). The
//     last layer's h goes from the tile to memory (a warp stores 64 bytes
//     of each of 8 rows); or, in the SDF entry, the tile takes each
//     product h w_last[c] rounded on its own and sums each row as
//     fused_mlp.sdf_column does: zero padded to sdf_cols (a power of two),
//     pairwise halves s[c] + s[c + p], then + b_last, every step explicitly
//     rounded (__fmul_rn, __fadd_rn: no contraction). A row's sdf is then
//     sdf_column of the kernel's own h, bit for bit, whatever its batch; the
//     [N, W] hidden state never reaches memory.
//   * the SDF entry takes the points, [N][3] fp32, and encodes them into the
//     x tile itself (encode_rows, sdf_mlp.cuh: embed_value, K3's encoder),
//     the values fused_mlp.embed_padded gives bit for bit; the feature rows
//     from d_emb on are zeroed once. The hidden entry, on no path, keeps the
//     embedded input [N][x_cols]: the independent reference of the encoding
//     on the card.

#pragma once

#include "tc_common.cuh"

namespace {

constexpr int FMA_CONSUMERS = 256;                // two consumer warpgroups
constexpr int FMA_THREADS = FMA_CONSUMERS + 128;  // and a producer warpgroup
constexpr int FMA_TM = 8;                        // rows of a consumer's register tile
constexpr int FMA_TN = 16;                       // columns of it
constexpr int FMA_SLAB = 16384;                  // bytes of a full weight slab
constexpr int FMA_STAGES = 4;                    // the ring: 64 KB
constexpr int FMA_MAX_XC = 64;                   // embedding columns the x tile holds

// The layout of the FMA K1 at hidden width W: W / 16 column groups of threads
// span the width, the 256 consumers make 256 / (W / 16) row groups of 8 rows
// (BM = 64 rows at 512, 128 at 256); shared memory is the ring, its
// barriers, the activation tile [W][BM] and the x tile [x_cols][BM].
template <int W>
struct FmaCfg {
  static_assert(W == 256 || W == 512, "the FMA K1 is compiled for W = 256, 512");
  static constexpr int CG = W / FMA_TN;                  // column groups
  static constexpr int WC = CG / 8;                      // warps along the columns
  static constexpr int BM = FMA_CONSUMERS / CG * FMA_TM;  // rows a block tile
  static constexpr int KS = FMA_SLAB / (W * 4);          // weight rows a slab
  static constexpr int RING_OFF = 0;
  static constexpr int BAR_OFF = RING_OFF + FMA_STAGES * FMA_SLAB;
  static constexpr int ACT_OFF = BAR_OFF + 2 * FMA_STAGES * 8 + 64;
  static constexpr int XS_OFF = ACT_OFF + W * BM * 4;
  // shared memory at x_cols embedding columns
  static constexpr int smem(int x_cols) { return XS_OFF + x_cols * BM * 4; }
  static_assert(KS % 8 == 0, "a slab is whole 8-row steps");
  static_assert(XS_OFF + FMA_MAX_XC * BM * 4 <= 232448,
                "the FMA K1 needs more shared memory than a block may use");
};

// offset of row r of feature c in a [c][BM] tile: the 8-row group r / 8 moves
// to (r / 8) ^ ((c >> 2) & 3)
template <int BM>
__device__ __forceinline__ int fma_row(int c, int r) {
  return c * BM + (r ^ ((c & 12) << 1));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum over the k rows of `in` (feature-major [k][BM], rows
// swizzled by fma_row) of in[k][8 rg + i] * slab[k][column j], k ascending,
// one fmaf chain an output; the slabs come through the ring in order.
template <int W>
__device__ __forceinline__ void fma_part(float (&acc)[FMA_TM][FMA_TN], const float* in, int k,
                                         const float* ring, Ring<FMA_STAGES>& cur, int rg, int cg,
                                         int lane) {
  using C = FmaCfg<W>;
  for (int k0 = 0; k0 < k; k0 += C::KS) {
    const int rows = min(C::KS, k - k0);
    cur.wait_full();
    const float* slab = ring + cur.stage * (FMA_SLAB / 4) + 4 * cg;
    for (int kb = 0; kb < rows; kb += 8) {
      // features k0 + kb .. + 3 keep row group rg ^ s, the next four rg ^ s ^ 1
      const int f = k0 + kb;
      const int s = (f >> 2) & 3;
      const float* a_lo = in + f * C::BM + 8 * (rg ^ s);
      const float* a_hi = in + (f + 4) * C::BM + 8 * (rg ^ s ^ 1);
      const float* b = slab + kb * W;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* ap = u < 4 ? a_lo + u * C::BM : a_hi + (u - 4) * C::BM;
        const float4 a0 = lds4(ap), a1 = lds4(ap + 4);
        const float4 b0 = lds4(b + u * W), b1 = lds4(b + u * W + W / 4);
        const float4 b2 = lds4(b + u * W + W / 2), b3 = lds4(b + u * W + 3 * W / 4);
        const float a[FMA_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[FMA_TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w,
                                  b2.x, b2.y, b2.z, b2.w, b3.x, b3.y, b3.z, b3.w};
#pragma unroll
        for (int i = 0; i < FMA_TM; ++i)
#pragma unroll
          for (int j = 0; j < FMA_TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(cur.empty(cur.stage));  // this warp is done with the slab
    cur.next();
  }
}

// barrier 1 over the consumer warps (barrier 0 is __syncthreads)
__device__ __forceinline__ void fma_sync() { named_sync(1, FMA_CONSUMERS); }

// The producer's one thread: every slab of every layer, for every tile this
// block walks.
template <int W>
__device__ __forceinline__ void fma_produce(uint32_t ring, uint32_t bars,
                                            const float* __restrict__ wbuf, const Plan& plan,
                                            long long n_tiles) {
  using C = FmaCfg<W>;
  Ring<FMA_STAGES> cur(bars);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
      for (int part = 0; part < 2; ++part) {
        const int k = part ? L.k_x : L.k_h;
        const float* src = wbuf + (part ? L.wx : L.w);
        for (int k0 = 0; k0 < k; k0 += C::KS) {
          const uint32_t bytes = min(C::KS, k - k0) * W * 4;
          mbar_wait(cur.empty(cur.stage), cur.phase ^ 1u);
          mbar_arrive_expect_tx(cur.full(cur.stage), bytes);
          bulk_g2s(ring + cur.stage * FMA_SLAB, src + (long long)k0 * W, bytes,
                   cur.full(cur.stage));
          cur.next();
        }
      }
    }
  }
}

// SDF = false: x[n_rows][x_cols], the embedded points -> out_h[n_rows][W],
//              the last hidden state.
// SDF = true:  x = pts[n_rows][3], encoded here at plan.d_emb columns ->
//              out_sdf[n_rows] = sdf_column(h[:, :real], wlast, b_last), the
//              products zero padded to sdf_cols (a power of two <= W).
// wbuf: the packed fp32 weights and biases (prepare_weights), plan: their
// layers; wlast: the sdf column of the final linear, W floats, zero padded.
template <int W, bool SDF>
__global__ void __launch_bounds__(FMA_THREADS, 1)
sdf_fma_kernel(const float* __restrict__ x, const float* __restrict__ wbuf,
               const __grid_constant__ Plan plan, const float* __restrict__ wlast,
               float b_last, int sdf_cols, float* __restrict__ out_h,
               float* __restrict__ out_sdf, long long n_rows) {
  using C = FmaCfg<W>;
  constexpr int BM = C::BM;
  extern __shared__ uint8_t fma_smem[];  // 16-byte aligned: the bulk copies' alignment
  const float* ring = reinterpret_cast<const float*>(fma_smem + C::RING_OFF);
  const uint32_t bars = smem_u32(fma_smem + C::BAR_OFF);
  float* act = reinterpret_cast<float*>(fma_smem + C::ACT_OFF);  // [W][BM]
  float* xs = reinterpret_cast<float*>(fma_smem + C::XS_OFF);     // [x_cols][BM]
  const int tid = threadIdx.x;
  const long long n_tiles = (n_rows + BM - 1) / BM;

  if (tid == 0) {
    for (int s = 0; s < FMA_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                                  // the producer's arrive
      mbar_init(bars + 8 * (FMA_STAGES + s), FMA_CONSUMERS / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= FMA_CONSUMERS) {
    // the producer warpgroup gives its registers to the consumers; one thread streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == FMA_CONSUMERS)
      fma_produce<W>(smem_u32(ring), bars, wbuf, plan, n_tiles);
    return;
  }
  // the consumers: 232 registers a thread (the 128 accumulators, the operands
  // of the next step in flight, no spills; the launch bound allows 168)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int warp = tid / 32, lane = tid % 32;
  const int cg = (warp % C::WC) * 8 + lane % 8;  // columns q W/4 + 4 cg + {0..3}
  const int rg = (warp / C::WC) * 4 + lane / 8;  // rows 8 rg .. 8 rg + 7
  const int sw = 8 * (rg ^ (cg & 3));            // fma_row's offset of the row group, every column
  const int xc = plan.x_cols;
  Ring<FMA_STAGES> cur(bars);
  float acc[FMA_TM][FMA_TN];
  if constexpr (SDF) {
    // the encoding fills the feature rows below d_emb of every tile
    for (int u = tid; u < BM * xc; u += FMA_CONSUMERS)
      if (u / BM >= plan.d_emb) xs[fma_row<BM>(u / BM, u % BM)] = 0.0f;
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * BM;
    if constexpr (SDF) {
      encode_rows<BM>(x + 3 * base, (int)min((long long)BM, n_rows - base), plan.d_emb, tid,
                      FMA_CONSUMERS, [&](int r, int c, float v) { xs[fma_row<BM>(c, r)] = v; });
    } else {
      for (int u = tid; u < BM * xc; u += FMA_CONSUMERS) {
        const int r = u / xc, c = u - r * xc;
        xs[fma_row<BM>(c, r)] = base + r < n_rows ? x[(base + r) * xc + c] : 0.0f;
      }
    }
    fma_sync();

    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
#pragma unroll
      for (int i = 0; i < FMA_TM; ++i)
#pragma unroll
        for (int j = 0; j < FMA_TN; ++j) acc[i][j] = 0.0f;
      fma_part<W>(acc, l == 0 ? xs : act, L.k_h, ring, cur, rg, cg, lane);
      if (L.k_x > 0) fma_part<W>(acc, xs, L.k_x, ring, cur, rg, cg, lane);
      fma_sync();  // every consumer has read the layer's input

      // ---- epilogue: bias, softplus100 ----------------------------------
      float bias[FMA_TN];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(wbuf + L.b + q * (W / 4) + 4 * cg));
        bias[4 * q] = v.x; bias[4 * q + 1] = v.y; bias[4 * q + 2] = v.z; bias[4 * q + 3] = v.w;
      }
      const bool last = l == plan.n - 1;
      float wl[FMA_TN] = {};  // the SDF entry's last layer: the sdf column at these columns
      if (SDF && last) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(wlast + q * (W / 4) + 4 * cg));
          wl[4 * q] = v.x; wl[4 * q + 1] = v.y; wl[4 * q + 2] = v.z; wl[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < FMA_TN; ++j) {
        float v[FMA_TM];
#pragma unroll
        for (int i = 0; i < FMA_TM; ++i) {
          v[i] = softplus100(acc[i][j] + bias[j]);
          if (SDF && last) v[i] = __fmul_rn(v[i], wl[j]);  // the column's product
        }
        float* dst = act + ((j / 4) * (W / 4) + 4 * cg + j % 4) * BM + sw;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      fma_sync();
      if (!last) continue;
      if (SDF) {
        // sdf_column's order: pairwise halves of the zero-padded products
        for (int p = sdf_cols / 2; p >= 1; p /= 2) {
          for (int u = tid; u < p * BM; u += FMA_CONSUMERS) {
            const int c = u / BM, r = u % BM;
            float* d = act + fma_row<BM>(c, r);
            *d = __fadd_rn(*d, act[fma_row<BM>(c + p, r)]);
          }
          fma_sync();
        }
        if (tid < BM && base + tid < n_rows) out_sdf[base + tid] = __fadd_rn(act[tid], b_last);
      } else {
        // h out of the tile, a warp 8 rows x 16 columns a step: it writes 64
        // bytes of each row, and its lanes' reads fall in 32 banks
        for (int b = warp; b < (BM / 8) * (W / 16); b += FMA_CONSUMERS / 32) {
          const int r = 8 * (b % (BM / 8)) + lane % 8;
          const int c = 16 * (b / (BM / 8)) + 4 * (lane / 8);
          if (base + r < n_rows)
            *reinterpret_cast<float4*>(out_h + (base + r) * W + c) =
                make_float4(act[fma_row<BM>(c, r)], act[fma_row<BM>(c + 1, r)],
                            act[fma_row<BM>(c + 2, r)], act[fma_row<BM>(c + 3, r)]);
        }
      }
    }
  }
}

}  // namespace
