// Whole bidirectional sphere trace for NVIDIA Hopper (sm_90a), bound through
// a plain C interface (ctypes) by nefii_tpu_torch/ops/kernels/fused_trace.py.
//
// Replaces the Pallas TPU kernel _trace_kernel (nefii_tpu/ops/pallas/
// fused_trace.py:81), reached through build_fused_sphere_trace. One launch
// runs every iteration of the tracer for every ray: the step in from both
// ends, the back-step line search with factor (1 - step) 2^-j for j <
// line_step_iters, not_crossed, the head masks, at most sphere_tracing_iters
// iterations; each evaluation is the positional encoding of the point, the
// SDF-MLP hidden chain and the sdf column of the final linear. fp32 in, fp32
// accurate, as the TPU kernel.
//
// What bounds it on this card. Every evaluation is the flagship's 8x512
// chain, 3.7 MFLOP a point (NeuS's 8x256, 0.9). On the FP32 pipe (the first port's design) that pipe was
// the ceiling. Here the chain runs on the tensor cores in split fp16: every
// operand v is hi = fp16(v) and lo = fp16(v - hi), every product hi.hi +
// lo.hi + hi.lo, K2's scheme (sdf_mlp_split.cuh) with fp16's 11 significand
// bits in place of bf16's 8. The trace holds it to more than K2: its 5e-5
// stop threshold, its line search and the crossing test acc_s < acc_e turn a
// small error into a flipped decision that moves a ray's end by a whole
// step. Split bf16 keeps ~16 bits, and one tensor-core accumulator running
// over a layer adds with truncation, ~5e-6 of z; both flip such decisions.
// So: split fp16 (~22 bits), and each slice's products summed fresh on the
// tensor cores and added into fp32 registers (trace_gemm), which keeps the
// chain as close to fp32 as fp32 sums in another order. fp16's range is
// enough for the forward chain: activations (x, softplus h) are O(1) and
// stay unscaled; each layer's weights are scaled by a power of two 2^s_l so
// that their largest lies in [2^13, 2^14) and their lo parts stay normal, and
// the epilogue multiplies the sum by 2^-s_l (exact). The bound is three fp16
// products a multiply-add of the evaluations the rays need, on the tensor
// cores at bf16's rate. The forward records (7.47 MB on the flagship net) do
// not fit on chip, so each 64-row tile streams them from L2: the tiles must
// be full of work.
//
// Design. The TPU kernel gave a tile of rays to a grid step and evaluated
// the tile's start and end points while any of its rays lived, so a tile of
// incoherent rays lived as long as its slowest ray. Here a row of a tile is
// a point query, not a ray:
//   * a persistent block (K2's skeleton: two consumer warpgroups, one
//     producer warpgroup streaming records through the ring) keeps a
//     pool of TR_SLOTS = 32 rays. Each ray is a state machine (initial
//     evaluation, trace step, line-search step) that asks for its start
//     point while unf_s, its end point while unf_e, or its back-stepped
//     points while their sdf is negative: at most 2 queries a ray, so the
//     pool's queries always fit one tile of 64 rows.
//   * between tiles, consumer thread s < 32 owns slot s: it reads the sdf of
//     its rows, advances its ray, retires it (writes its results) when both
//     ends are finished or it ran sphere_tracing_iters iterations, and
//     refills the slot with the next ray index from a device counter that the
//     wrapper zeroes (one warp-aggregated atomicAdd a round, rays in index
//     order, so camera rays stay coherent). A prefix sum over the warp gives
//     each query its row; the slot lives in a per-block global scratch, so
//     the ray logic holds no register of the consumers' hot loop.
//   * the tile: the embedding of each row's point into the X tile (hi, lo;
//     embed_value of sdf_mlp.cuh, the encoder of K1's sdf entries too),
//     the forward chain (trace_gemm on K2's forward record layout, in fp16:
//     trace_weights in fused_trace.py; a warpgroup's 64 x W/2 sums in fp32
//     registers beside one 64x128 tensor-core partial), and the last layer's
//     epilogue reduces h . w_last[:, 0] per row in a fixed order (as K1's sdf
//     entry): the 64 x W h never leaves the chip. A wgmma row's sums do not
//     depend on the other rows, so a ray's results do not depend on which
//     rays share its tiles.
//   * widths: compiled for W = 512 and W = 256, on K2's layout at W
//     (SplitCfg). At 512 a record holds one k16 slice of N = 512, each
//     consumer warpgroup owns 256 columns (two m64n128k16 partials a slice,
//     sum[128]) and the ring has 5 stages. At 256, K2@256's design: a record
//     holds two slices of N = 256 (a layer's odd last slice padded with
//     zeros), each warpgroup owns 128 columns (one m64n128k16 partial a
//     slice, sum[64]: half the sums' registers) and the ring has 8 stages.
//     The pool, its one 64-row tile, the near flags and the 2^s scaling are
//     the same at both.
//   * the weight sequence is the same for every tile, so the producer cycles
//     the ring without waiting on the ray logic and runs into the next tile's
//     layer 0. The consumers do not know a tile ahead whether there is one:
//     when the pool is dry they raise a stop flag, the producer sees it while
//     it waits for a stage and waits for its copies in flight before it exits.
//   * the count: the rows that held a query (the evaluations executed, what
//     the gathered tracer counts) and the empty rows of partly filled tiles,
//     added by each block with one 64-bit atomicAdd each when it exits.
// Points and steps use explicitly rounded adds and multiplies (no FMA
// contraction), so they round as the plain PyTorch version does; the
// encoding uses sinf/cosf, not the fast intrinsics.
//
// Near decisions. Split fp16 holds the sdf close to fp32's, not to the bit:
// a stop test (sdf <= threshold) or a line-search sign test (sdf < 0) on a
// value that close to its threshold can go the other way, and the ray then
// ends a sub-threshold step from where the fp32 trace ends; the ends' sums of
// those values can likewise cross (acc_s < acc_e) on one side only. A
// decision whose values lie within delta of its threshold (of each other, for
// the crossing) marks the ray near (near_ray, and
// the count in counters[3]); the wrapper re-traces the near rays in fp32 (K1
// fp32 under the gathered tracer) and keeps that trace for them.

#include "sdf_mlp_split.cuh"

namespace {

constexpr int TR_SLOTS = 32;  // rays in a block's pool
static_assert(2 * TR_SLOTS <= TC_BM, "the pool's queries must fit one tile");

// K3's shared memory at width W: K2's layout (SplitCfg<W>: the ring, the
// activation and X tiles, the ring's barriers), then the rows' points, the
// sdf partial sums and the control words
template <int W>
struct TraceLayout {
  using C = SplitCfg<W>;
  static constexpr int PTS_OFF = C::BAR_OFF + 2 * C::STAGES * 8;  // float4 point of each row
  static constexpr int RED_OFF = PTS_OFF + TC_BM * 16;            // [2][TC_BM] sdf partial sums
  static constexpr int CTL_OFF = RED_OFF + 2 * TC_BM * 4;         // queries this tile, stop flag
  static constexpr int SMEM = CTL_OFF + 16 + 1024;                // + alignment slack
  static_assert(SMEM <= 232448, "K3 needs more shared memory than a block may use");
  static_assert(PTS_OFF % 16 == 0, "the points are float4");
};

constexpr int SLOT_EMPTY = -1;  // a slot waiting for a ray
constexpr int SLOT_DRY = -2;    // no ray is left to take
enum : int { PH_INIT = 0, PH_STEP = 1, PH_LS = 2 };  // what the pending queries are

struct TraceCfg {
  float thresh;     // sdf_threshold
  float delta;      // a decision on an sdf within delta of what it is compared with is near
  float ls_factor;  // 1 - line_search_step; line-search step j scales it by 2^-j
  int ls_iters;     // line_step_iters
  int trace_iters;  // sphere_tracing_iters
  int d_emb;        // real embedding width, 3 (1 + 2 multires)
  float b_last;     // bias of the sdf column
  float unscale[MAX_LAYERS];  // 2^-s_l: layer l's weights are packed times 2^s_l
};

struct Rays {
  const float* cam;  // [n][3]
  const float* dir;  // [n][3]
  const uint8_t* isect;
  const float* near;
  const float* far;
  float* acc_s;  // out [n]
  float* acc_e;
  uint8_t* unf;
  uint8_t* near_ray;            // out [n]: a decision of the ray's trace was near
  unsigned long long* n_near;  // out: the rays with a near decision
  long long n;
};

// one ray of a block's pool, in global scratch, read and written only by the
// consumer thread that owns the slot
struct Slot {
  float cam[3], dir[3];
  float acc_s, acc_e, curr_s, curr_e, next_s, next_e;
  int ray;             // >= 0, SLOT_EMPTY or SLOT_DRY
  int it, j, phase;    // trace iteration, line-search step, PH_*
  int unf_s, unf_e;
  int near;            // a decision so far was near (TraceCfg::delta)
  int q_s, q_e;        // queries pending: the start point, the end point
  int row_s, row_e;    // their rows in the tile
};

// a stop test of a live end whose sdf lies within cfg.delta of the threshold
// is near: split fp16 may decide it otherwise than fp32
__device__ __forceinline__ void head(Slot& s, const TraceCfg& cfg) {
  const float thresh = cfg.thresh;
  if ((s.unf_s && fabsf(__fsub_rn(s.next_s, thresh)) <= cfg.delta) ||
      (s.unf_e && fabsf(__fsub_rn(s.next_e, thresh)) <= cfg.delta))
    s.near = 1;
  s.curr_s = s.unf_s ? s.next_s : 0.0f;
  if (s.curr_s <= thresh) s.curr_s = 0.0f;
  s.curr_e = s.unf_e ? s.next_e : 0.0f;
  if (s.curr_e <= thresh) s.curr_e = 0.0f;
  s.unf_s = s.unf_s && s.curr_s > thresh;
  s.unf_e = s.unf_e && s.curr_e > thresh;
}

__device__ __forceinline__ void retire(Slot& s, const Rays& R) {
  R.acc_s[s.ray] = s.acc_s;
  R.acc_e[s.ray] = s.acc_e;
  R.unf[s.ray] = s.unf_s ? 1 : 0;
  R.near_ray[s.ray] = s.near ? 1 : 0;
  if (s.near) atomicAdd(R.n_near, 1ull);
  s.ray = SLOT_EMPTY;
  s.q_s = s.q_e = 0;
}

// the sdf at the slot's pending queries -> its next queries, or it retires
__device__ void advance(Slot& s, float sd_s, float sd_e, const TraceCfg& cfg, const Rays& R) {
  if (s.phase == PH_INIT) {
    s.next_s = sd_s;
    s.next_e = sd_e;
    head(s, cfg);
    s.it = 0;
  } else {
    if (s.phase == PH_STEP) {
      s.next_s = s.unf_s ? sd_s : 0.0f;
      s.next_e = s.unf_e ? sd_e : 0.0f;
      s.j = 0;
    } else {
      if (s.q_s) s.next_s = sd_s;
      if (s.q_e) s.next_e = sd_e;
      ++s.j;
    }
    // back-step line search for an end that crossed the surface; the sign
    // test of an end just evaluated is near within cfg.delta of 0
    if (s.j < cfg.ls_iters && ((s.q_s && fabsf(s.next_s) <= cfg.delta) ||
                               (s.q_e && fabsf(s.next_e) <= cfg.delta)))
      s.near = 1;
    if (s.j < cfg.ls_iters && (s.next_s < 0.0f || s.next_e < 0.0f)) {
      s.q_s = s.next_s < 0.0f;
      s.q_e = s.next_e < 0.0f;
      const float factor = ldexpf(cfg.ls_factor, -s.j);
      if (s.q_s) s.acc_s = __fsub_rn(s.acc_s, __fmul_rn(factor, s.curr_s));
      if (s.q_e) s.acc_e = __fadd_rn(s.acc_e, __fmul_rn(factor, s.curr_e));
      s.phase = PH_LS;
      return;
    }
    // the crossing test of live ends within cfg.delta of each other is near
    if ((s.unf_s || s.unf_e) && fabsf(__fsub_rn(s.acc_e, s.acc_s)) <= cfg.delta) s.near = 1;
    const bool not_crossed = s.acc_s < s.acc_e;
    s.unf_s = s.unf_s && not_crossed;
    s.unf_e = s.unf_e && not_crossed;
    head(s, cfg);
    ++s.it;
  }
  if (s.it >= cfg.trace_iters || !(s.unf_s || s.unf_e)) {
    retire(s, R);
    return;
  }
  s.acc_s = __fadd_rn(s.acc_s, s.curr_s);
  s.acc_e = __fsub_rn(s.acc_e, s.curr_e);
  s.q_s = s.unf_s;
  s.q_e = s.unf_e;
  s.phase = PH_STEP;
}

// every lane of the warp: fill the empty slots with the next rays, one
// atomicAdd a round; a ray that misses the bounding sphere is written at once
__device__ void refill(Slot& s, unsigned long long* next_ray, const Rays& R, int lane) {
  for (;;) {
    const unsigned need = __ballot_sync(0xffffffffu, s.ray == SLOT_EMPTY);
    if (!need) return;
    const int leader = __ffs(need) - 1;
    unsigned long long base = 0;
    if (lane == leader) base = atomicAdd(next_ray, (unsigned long long)__popc(need));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (s.ray != SLOT_EMPTY) continue;
    const long long r = (long long)base + __popc(need & ((1u << lane) - 1u));
    if (r >= R.n) {
      s.ray = SLOT_DRY;
    } else if (!R.isect[r]) {
      R.acc_s[r] = 0.0f;
      R.acc_e[r] = 0.0f;
      R.unf[r] = 0;
      R.near_ray[r] = 0;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.cam[k] = R.cam[r * 3 + k];
        s.dir[k] = R.dir[r * 3 + k];
      }
      s.ray = (int)r;
      s.acc_s = R.near[r];
      s.acc_e = R.far[r];
      s.curr_s = s.curr_e = s.next_s = s.next_e = 0.0f;
      s.unf_s = s.unf_e = 1;
      s.near = 0;
      s.q_s = s.q_e = 1;
      s.it = s.j = 0;
      s.phase = PH_INIT;
    }
  }
}

__device__ __forceinline__ float4 point_at(const Slot& s, float t) {
  return make_float4(__fadd_rn(s.cam[0], __fmul_rn(t, s.dir[0])),
                     __fadd_rn(s.cam[1], __fmul_rn(t, s.dir[1])),
                     __fadd_rn(s.cam[2], __fmul_rn(t, s.dir[2])), 0.0f);
}

// sum += A . B over n_slices k16 slices (rounded up to whole records, whose
// padding is zero), fp32-accurate. B comes from the ring: per record pair a
// hi record and a lo record of G slices of N = W, of which this warpgroup
// reads its W/2 rows. Each slice and each 128 of the warpgroup's columns is a
// fresh tensor-core sum, A_lo.B_hi + A_hi.B_lo + A_hi.B_hi (the small
// products first), added to `sum` with fp32 adds that round to nearest. The tensor cores add in fp32 with truncation: one accumulator
// running over a 512-deep layer's 96 products gathers that bias (~5e-6 of z
// on the flagship net); a fresh sum a slice leaves one truncation of a
// slice's partial sum, of either sign, so the chain stays as close to fp32
// as fp32 sums in another order.
template <int W, int STAGES>
__device__ __forceinline__ void trace_gemm(float (&sum)[W / 4], float (&tmp)[64], uint32_t a_hi,
                                           uint32_t a_lo, int n_slices, uint32_t ring,
                                           Ring<STAGES>& rg, int wg, bool leader) {
  constexpr int NW = W / 2;             // columns a warpgroup owns
  constexpr int G = SplitCfg<W>::G;     // slices a record
  constexpr uint32_t SLICE = W * 32;    // bytes of one slice of all the B rows
  for (int j0 = 0; j0 < n_slices; j0 += G) {
    const int st_hi = rg.stage;
    rg.wait_full();
    rg.next();
    const int st_lo = rg.stage;
    rg.wait_full();
    rg.next();
    const uint32_t b_hi = ring + st_hi * SP_REC + wg * NW * 32;
    const uint32_t b_lo = ring + st_lo * SP_REC + wg * NW * 32;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int j = j0 + s;
      const uint32_t ak = (j / 4) * TC_TILE_BYTES + 32 * (j % 4);
      const uint64_t d_hi = wgmma_desc(a_hi + ak), d_lo = wgmma_desc(a_lo + ak);
#pragma unroll
      for (int h = 0; h < NW / 128; ++h) {
        const uint32_t bo = s * SLICE + h * 128 * 32;
        wgmma_fence();
        wgmma_m64n128k16_f16(tmp, d_lo, wgmma_desc32(b_hi + bo), 0);
        wgmma_m64n128k16_f16(tmp, d_hi, wgmma_desc32(b_lo + bo), 1);
        wgmma_m64n128k16_f16(tmp, d_hi, wgmma_desc32(b_hi + bo), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(tmp);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[64 * h + i] += tmp[i];
      }
    }
    if (leader) {
      mbar_arrive(rg.empty(st_hi));
      mbar_arrive(rg.empty(st_lo));
    }
  }
}

// The producer's one thread: the n_rec forward records, once a tile, until
// the consumers raise `stop`; then it waits for the copies still in flight,
// so none lands in the shared memory of an exited block.
template <int STAGES>
__device__ void trace_produce(uint32_t ring, uint32_t bars, const uint8_t* src, int n_rec,
                              const volatile int* stop) {
  Ring<STAGES> rg(bars);
  long long issued = 0;
  for (;;) {
    for (int c = 0; c < n_rec; ++c) {
      while (!mbar_try_wait(rg.empty(rg.stage), rg.phase ^ 1u))
        if (*stop) goto drain;
      mbar_arrive_expect_tx(rg.full(rg.stage), SP_REC);
      bulk_g2s(ring + rg.stage * SP_REC, src + (long long)c * SP_REC, SP_REC, rg.full(rg.stage));
      rg.next();
      ++issued;
    }
  }
drain:
  // the last copy into each stage, newest first
  for (long long k = 0; k < issued && k < STAGES; ++k) {
    if (rg.stage == 0) {
      rg.stage = STAGES - 1;
      rg.phase ^= 1u;
    } else {
      --rg.stage;
    }
    mbar_wait(rg.full(rg.stage), rg.phase);
  }
}

// rec: the n_rec split-fp16 records of the forward chain at width W; wbuf:
// the fp32 buffer the biases are read from; wlast [W]: the sdf column of
// the final linear; pool: gridDim.x x TR_SLOTS slots; counters: the next ray
// to take, the evaluations executed, the empty rows, the near rays (zeroed by
// the caller; R.n_near points at the last).
template <int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
sphere_trace_split_kernel(const __grid_constant__ Rays R, const __half* __restrict__ rec, int n_rec,
                          const float* __restrict__ wbuf, const __grid_constant__ Plan plan,
                          const float* __restrict__ wlast, const __grid_constant__ TraceCfg cfg,
                          Slot* __restrict__ pool, unsigned long long* __restrict__ counters) {
  using C = SplitCfg<W>;
  using T = TraceLayout<W>;
  constexpr int NW = W / 2, J = NW / 8;  // columns, and 8-column groups, a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (sbase - raw);
  const uint32_t ring = sbase + C::RING_OFF, bars = sbase + C::BAR_OFF;
  const uint32_t a_hi = sbase + C::AHI_OFF, a_lo = sbase + C::ALO_OFF;
  const uint32_t x_hi = sbase + C::XHI_OFF, x_lo = sbase + C::XLO_OFF;
  float4* pts = reinterpret_cast<float4*>(sm + T::PTS_OFF);
  float* red = reinterpret_cast<float*>(sm + T::RED_OFF);
  volatile int* ctl = reinterpret_cast<volatile int*>(sm + T::CTL_OFF);  // [0] queries, [1] stop
  const int tid = threadIdx.x;

  if (tid == 0) {
    ring_init<C::STAGES>(bars);
    ctl[1] = 0;
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warpgroup: one thread streams the forward records
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == TC_CONSUMERS)
      trace_produce<C::STAGES>(ring, bars, reinterpret_cast<const uint8_t*>(rec), n_rec, ctl + 1);
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
  Slot* slot = pool + (long long)blockIdx.x * TR_SLOTS + tid;
  float sum[NW / 2], tmp[64];  // this warpgroup's 64 x NW sums; one fresh 64 x 128 partial
  Ring<C::STAGES> rg(bars);
  unsigned long long executed = 0, tiles = 0;

  for (bool first = true;; first = false) {
    // ---- the pool: answers, retirements, refills, the next tile's queries
    if (tid < TR_SLOTS) {
      Slot s;
      if (first) {
        s.ray = SLOT_EMPTY;
        s.q_s = s.q_e = 0;
      } else {
        s = *slot;
        if (s.ray >= 0) {
          const float sd_s = s.q_s ? red[s.row_s] + red[TC_BM + s.row_s] + cfg.b_last : 0.0f;
          const float sd_e = s.q_e ? red[s.row_e] + red[TC_BM + s.row_e] + cfg.b_last : 0.0f;
          advance(s, sd_s, sd_e, cfg, R);
        }
      }
      refill(s, counters, R, lane);
      const int q = s.q_s + s.q_e;
      int incl = q;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int row = incl - q;
      if (s.q_s) {
        s.row_s = row;
        pts[row] = point_at(s, s.acc_s);
      }
      if (s.q_e) {
        s.row_e = row + s.q_s;
        pts[row + s.q_s] = point_at(s, s.acc_e);
      }
      *slot = s;
      if (lane == 31) ctl[0] = incl;
    }
    consumers_sync();
    const int n_q = ctl[0];
    if (n_q == 0) break;
    executed += n_q;
    ++tiles;

    // ---- X tile [64][64] in hi and lo: each row's encoded point, zero past
    // the queries and past d_emb
    for (int u = tid; u < TC_BM * 8; u += TC_CONSUMERS) {
      const int r = u / 8, g = u % 8;
      float v[8];
      const float4 p = pts[r];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = (r < n_q && g * 8 + k < cfg.d_emb) ? embed_value(p, g * 8 + k) : 0.0f;
      uint4 hi, lo;
      split2u<true>(v[0], v[1], hi.x, lo.x);
      split2u<true>(v[2], v[3], hi.y, lo.y);
      split2u<true>(v[4], v[5], hi.z, lo.z);
      split2u<true>(v[6], v[7], hi.w, lo.w);
      *reinterpret_cast<uint4*>(sm + C::XHI_OFF + sw128(r, g * 8)) = hi;
      *reinterpret_cast<uint4*>(sm + C::XLO_OFF + sw128(r, g * 8)) = lo;
    }
    fence_proxy_async();
    consumers_sync();

    // ---- the forward chain
    for (int l = 0; l < plan.n; ++l) {
      const Layer& L = plan.l[l];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) sum[i] = 0.0f;
      trace_gemm<W>(sum, tmp, l == 0 ? x_hi : a_hi, l == 0 ? x_lo : a_lo, L.k_h / 16, ring, rg,
                    wg, leader);
      if (L.k_x > 0) trace_gemm<W>(sum, tmp, x_hi, x_lo, L.k_x / 16, ring, rg, wg, leader);
      consumers_sync();  // every product of both warpgroups has read the A tile
      const float* bias = wbuf + L.b + c0;
      const float sc = cfg.unscale[l];
      float h0, h1, h2, h3, s;
      if (l < plan.n - 1) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          softplus_sigmoid100(sum[4 * j] * sc + b.x, h0, s);
          softplus_sigmoid100(sum[4 * j + 1] * sc + b.y, h1, s);
          softplus_sigmoid100(sum[4 * j + 2] * sc + b.x, h2, s);
          softplus_sigmoid100(sum[4 * j + 3] * sc + b.y, h3, s);
          put_split<true, C::ACT>(arow, j, r0, h0, h1, h2, h3);
        }
        fence_proxy_async();
      } else {
        // the sdf column: this thread's NW / 4 columns of rows r0 and r0 + 8,
        // then the 4 lanes of a row, then the two warpgroups, in that order
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          const float2 w = __ldg(reinterpret_cast<const float2*>(wlast + c0 + 8 * j));
          softplus_sigmoid100(sum[4 * j] * sc + b.x, h0, s);
          softplus_sigmoid100(sum[4 * j + 1] * sc + b.y, h1, s);
          softplus_sigmoid100(sum[4 * j + 2] * sc + b.x, h2, s);
          softplus_sigmoid100(sum[4 * j + 3] * sc + b.y, h3, s);
          s0 += h0 * w.x + h1 * w.y;
          s1 += h2 * w.x + h3 * w.y;
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        if (lane % 4 == 0) {
          red[wg * TC_BM + r0] = s0;
          red[wg * TC_BM + r0 + 8] = s1;
        }
      }
      consumers_sync();
    }
  }

  if (tid == 0) {
    ctl[1] = 1;  // the producer stops
    atomicAdd(counters + 1, executed);
    atomicAdd(counters + 2, (unsigned long long)TC_BM * tiles - executed);
  }
}

// records of the forward chain at width W: per layer the h part then the x
// part, G k16 slices of N = W a record (one at 512, two at 256), hi then lo
// (K2's forward records)
template <int W>
inline int forward_records(const Plan& p) {
  constexpr int G = SplitCfg<W>::G;
  int r = 0;
  for (int l = 0; l < p.n; ++l) r += split_recs(p.l[l].k_h, G) + split_recs(p.l[l].k_x, G);
  return r;
}

template <int W>
int launch_trace(const Rays& R, const void* rec, int n_rec, const void* wbuf, const Plan& plan,
                 const void* wlast, const TraceCfg& cfg, void* pool, void* counters, int grid,
                 void* stream) {
  if (n_rec != forward_records<W>(plan)) return (int)cudaErrorInvalidValue;
  constexpr int SMEM = TraceLayout<W>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(sphere_trace_split_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  sphere_trace_split_kernel<W><<<grid, TC_THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      R, static_cast<const __half*>(rec), n_rec, static_cast<const float*>(wbuf), plan,
      static_cast<const float*>(wlast), cfg, static_cast<Slot*>(pool),
      static_cast<unsigned long long*>(counters));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nefii_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the compiled widths (widths[2]), the rays a pool, the rows a tile and the
// bytes of a pool slot
int nefii_fused_trace_config(int* widths, int* slots, int* tile_rows, int* slot_bytes) {
  widths[0] = 256;
  widths[1] = 512;
  *slots = TR_SLOTS;
  *tile_rows = TC_BM;
  *slot_bytes = (int)sizeof(Slot);
  return 0;
}

// One launch traces n_rays rays: cam, dirs [n_rays][3], isect (uint8 mask),
// near, far [n_rays] fp32 in; acc_s, acc_e [n_rays] fp32, unf, near_ray
// [n_rays] uint8 out (near_ray: a stop or sign decision of the ray's trace
// took an sdf within delta of its threshold). rec: n_rec records of the
// forward chain in split fp16 at `width` (256 or 512), layer l's weights
// times 2^shift[l] (trace_weights); pool: grid x TR_SLOTS slots of scratch;
// counters: 4 uint64 zeroed by the caller (the next ray, then out: the
// evaluations executed, the empty rows of the tiles, the near rays).
int nefii_sphere_trace(const void* cam, const void* dirs, const void* isect, const void* near,
                       const void* far, const void* rec, int n_rec, const int* shift,
                       const void* wbuf, const long long* desc, int n_layers, int x_cols,
                       int width, const void* wlast,
                       float b_last, float thresh, float delta, float ls_factor, int ls_iters,
                       int trace_iters, int multires, void* acc_s, void* acc_e, void* unf,
                       void* near_ray, void* pool, void* counters, long long n_rays, int grid,
                       void* stream) {
  Plan plan;
  const int d_emb = 3 * (1 + 2 * multires);
  if (!make_plan(desc, n_layers, x_cols, &plan, width) || x_cols > SP_NX || n_rays <= 0 ||
      n_rays > 0x7fffffffLL || grid <= 0 || multires < 0 || d_emb > x_cols || ls_iters < 0 ||
      trace_iters < 0 || !(delta >= 0.0f))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < plan.n; ++l)
    if (plan.l[l].k_h % 16 || plan.l[l].k_x % 16) return (int)cudaErrorInvalidValue;
  TraceCfg cfg{thresh, delta, ls_factor, ls_iters, trace_iters, d_emb, b_last, {}};
  for (int l = 0; l < plan.n; ++l) {
    if (shift[l] < -60 || shift[l] > 60) return (int)cudaErrorInvalidValue;
    cfg.unscale[l] = ldexpf(1.0f, -shift[l]);
  }
  const Rays R{static_cast<const float*>(cam), static_cast<const float*>(dirs),
               static_cast<const uint8_t*>(isect), static_cast<const float*>(near),
               static_cast<const float*>(far), static_cast<float*>(acc_s),
               static_cast<float*>(acc_e), static_cast<uint8_t*>(unf),
               static_cast<uint8_t*>(near_ray), static_cast<unsigned long long*>(counters) + 3,
               n_rays};
  if (width == 512)
    return launch_trace<512>(R, rec, n_rec, wbuf, plan, wlast, cfg, pool, counters, grid, stream);
  if (width == 256)
    return launch_trace<256>(R, rec, n_rec, wbuf, plan, wlast, cfg, pool, counters, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
