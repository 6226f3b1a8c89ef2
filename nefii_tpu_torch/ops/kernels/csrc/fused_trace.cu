// Whole bidirectional sphere trace for NVIDIA Hopper (sm_90a), bound through
// a plain C interface (ctypes) by nefii_tpu_torch/ops/kernels/fused_trace.py.
//
// Replaces the Pallas TPU kernel _trace_kernel (nefii_tpu/ops/pallas/
// fused_trace.py:81), reached through build_fused_sphere_trace. For a tile
// of rays it runs every iteration of the tracer in one launch: positional
// encoding of the start and end points, the SDF-MLP hidden chain, the sdf
// column, the step in from both ends, the back-step line search with factor
// (1 - step) 2^-j, and the per-tile early exit. Per-ray results equal the
// dense tracer's (converged rays are frozen by their masks); only the count
// of executed evaluations depends on the tiling.
//
// What bounds it on this card. Each evaluation is the 8x512 chain, ~3.7
// MFLOP per point, so the kernel is bound by the FP32 pipe like K1, whose
// layer loop it reuses (sdf_mlp.cuh): a block owns TR = 16 rays, i.e. a
// 32-row tile of start and end points, 64 KB of activations in shared
// memory, weights streamed through L2. The TPU kernel's tile of 256 rays
// came from 16 MB of VMEM and does not carry over. The design removes what
// the gathered PyTorch tracer pays besides the MLP: two host syncs per
// iteration and the gathers and scatters around every evaluation. The
// decisions that the TPU kernel took with lax.cond(any(...)) are
// __syncthreads_or over the tile; the masks are plain registers of the
// thread that owns the ray. The count of executed evaluations, which the TPU
// accumulated in one SMEM cell over grid steps that run in order, is added
// with one 64-bit atomicAdd per block into a counter the wrapper zeroes.
// Points and steps use explicitly rounded adds and multiplies (no FMA
// contraction), so they round as the plain PyTorch version does; the sdf
// column is reduced in a fixed order. fp32 only, as the TPU kernel.

#include "sdf_mlp.cuh"

namespace {

constexpr int TR = BM / 2;             // rays per block: start and end points fill the tile
constexpr int WARPS = THREADS / 32;
constexpr int COLS_PER_WARP = WIDTH / WARPS;

struct TraceCfg {
  float thresh;     // sdf_threshold
  float ls_factor;  // 1 - line_search_step; line-search step j scales it by 2^-j
  int ls_iters;     // line_step_iters
  int trace_iters;  // sphere_tracing_iters
  int multires;
  int d_emb;        // real embedding width, 3 (1 + 2 multires)
};

struct TileState {
  float cam[TR][3];
  float dir[TR][3];
  float t[BM];                 // distance of each row's point: rows [0, TR) start, [TR, BM) end
  float part[WARPS][BM];       // per-warp partial sums of the sdf column
  float sdf[BM];
};

// xs[c][r] = the embedding of row r's point, zero past d_emb
__device__ __forceinline__ void embed_tile(const TileState& st, const TraceCfg& cfg, float* xs,
                                           int x_cols) {
  for (int i = threadIdx.x; i < BM * x_cols; i += THREADS) {
    const int c = i / BM, r = i - c * BM;
    const int ray = r % TR;
    float v = 0.0f;
    if (c < cfg.d_emb) {
      int j = c, k = -1;
      bool use_cos = false;
      if (c >= 3) {
        const int q = c - 3;
        k = q / 6;
        j = q % 6;
        use_cos = j >= 3;
        if (use_cos) j -= 3;
      }
      const float p = __fadd_rn(st.cam[ray][j], __fmul_rn(st.t[r], st.dir[ray][j]));
      if (k < 0) {
        v = p;
      } else {
        const float a = __fmul_rn(p, ldexpf(1.0f, k));
        v = use_cos ? cosf(a) : sinf(a);
      }
    }
    xs[i] = v;
  }
}

// st.sdf[r] = sdf of row r's point; begins and ends with a barrier
__device__ void sdf_tile(TileState& st, const float* __restrict__ wbuf, const Plan& plan,
                         const float* __restrict__ wlast, float bl, const TraceCfg& cfg,
                         float* act, float* xs, int col0, int row0) {
  __syncthreads();  // the owners' distances are written
  embed_tile(st, cfg, xs, plan.x_cols);
  __syncthreads();
  for (int l = 0; l < plan.n; ++l)
    forward_layer(plan.l[l], l == 0 ? xs : act, xs, act, wbuf, col0, row0);
  // sdf column: warp w sums features [w COLS_PER_WARP, (w+1) COLS_PER_WARP)
  // for row = lane, then one thread per row adds the warps in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = warp * COLS_PER_WARP; c < (warp + 1) * COLS_PER_WARP; ++c)
    s = fmaf(act[c * BM + lane], __ldg(wlast + c), s);
  st.part[warp][lane] = s;
  __syncthreads();
  if (threadIdx.x < BM) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += st.part[w][threadIdx.x];
    st.sdf[threadIdx.x] = total + bl;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
sphere_trace_kernel(const float* __restrict__ cam, const float* __restrict__ dirs,
                    const uint8_t* __restrict__ isect, const float* __restrict__ near,
                    const float* __restrict__ far, const float* __restrict__ wbuf,
                    const __grid_constant__ Plan plan, const float* __restrict__ wlast,
                    float bl, const TraceCfg cfg, float* __restrict__ acc_s_out,
                    float* __restrict__ acc_e_out, uint8_t* __restrict__ unf_out,
                    unsigned long long* __restrict__ n_evals, long long n_rays) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;              // [WIDTH][BM]
  float* xs = smem + WIDTH * BM;  // [x_cols][BM]
  __shared__ TileState st;
  const int tid = threadIdx.x;
  const int tx = tid % (WIDTH / TN), ty = tid / (WIDTH / TN);
  const int col0 = tx * TN, row0 = ty * TM;
  const long long ray = (long long)blockIdx.x * TR + tid;
  // threads [0, TR) each own one ray's state, in registers
  const bool owner = tid < TR;
  const bool valid = owner && ray < n_rays;

  bool unf_s = false, unf_e = false;
  float acc_s = 0.0f, acc_e = 0.0f, curr_s = 0.0f, curr_e = 0.0f, next_s = 0.0f, next_e = 0.0f;
  if (owner) {
    const bool m = valid && isect[ray] != 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      st.cam[tid][j] = valid ? cam[ray * 3 + j] : 0.0f;
      st.dir[tid][j] = valid ? dirs[ray * 3 + j] : 0.0f;
    }
    acc_s = m ? near[ray] : 0.0f;
    acc_e = m ? far[ray] : 0.0f;
    unf_s = unf_e = m;
    st.t[tid] = acc_s;
    st.t[TR + tid] = acc_e;
  }
  auto head = [&]() {
    curr_s = unf_s ? next_s : 0.0f;
    if (curr_s <= cfg.thresh) curr_s = 0.0f;
    curr_e = unf_e ? next_e : 0.0f;
    if (curr_e <= cfg.thresh) curr_e = 0.0f;
    unf_s = unf_s && curr_s > cfg.thresh;
    unf_e = unf_e && curr_e > cfg.thresh;
  };

  sdf_tile(st, wbuf, plan, wlast, bl, cfg, act, xs, col0, row0);
  unsigned long long n_ev = 2 * TR;
  if (owner) {
    next_s = unf_s ? st.sdf[tid] : 0.0f;
    next_e = unf_e ? st.sdf[TR + tid] : 0.0f;
    head();
  }

  for (int it = 0; it < cfg.trace_iters; ++it) {
    if (!__syncthreads_or(owner && (unf_s || unf_e))) break;  // per-tile early exit
    if (owner) {
      acc_s = __fadd_rn(acc_s, curr_s);
      acc_e = __fsub_rn(acc_e, curr_e);
      st.t[tid] = acc_s;
      st.t[TR + tid] = acc_e;
    }
    sdf_tile(st, wbuf, plan, wlast, bl, cfg, act, xs, col0, row0);
    n_ev += 2 * TR;
    if (owner) {
      next_s = unf_s ? st.sdf[tid] : 0.0f;
      next_e = unf_e ? st.sdf[TR + tid] : 0.0f;
    }
    // back-step line search for the rays that crossed the surface
    for (int j = 0; j < cfg.ls_iters; ++j) {
      if (!__syncthreads_or(owner && (next_s < 0.0f || next_e < 0.0f))) break;
      const bool np_s = owner && next_s < 0.0f, np_e = owner && next_e < 0.0f;
      if (owner) {
        const float factor = ldexpf(cfg.ls_factor, -j);
        if (np_s) acc_s = __fsub_rn(acc_s, __fmul_rn(factor, curr_s));
        if (np_e) acc_e = __fadd_rn(acc_e, __fmul_rn(factor, curr_e));
        st.t[tid] = acc_s;
        st.t[TR + tid] = acc_e;
      }
      sdf_tile(st, wbuf, plan, wlast, bl, cfg, act, xs, col0, row0);
      n_ev += 2 * TR;
      if (np_s) next_s = st.sdf[tid];
      if (np_e) next_e = st.sdf[TR + tid];
    }
    if (owner) {
      const bool not_crossed = acc_s < acc_e;
      unf_s = unf_s && not_crossed;
      unf_e = unf_e && not_crossed;
      head();
    }
  }

  if (valid) {
    acc_s_out[ray] = acc_s;
    acc_e_out[ray] = acc_e;
    unf_out[ray] = unf_s ? 1 : 0;
  }
  if (tid == 0) atomicAdd(n_evals, n_ev);
}

}  // namespace

extern "C" {

const char* nefii_trace_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int nefii_fused_trace_config(int* width, int* rays_per_block, int* threads) {
  *width = WIDTH;
  *rays_per_block = TR;
  *threads = THREADS;
  return 0;
}

// One launch traces n_rays rays: cam, dirs [n_rays][3], isect (uint8 mask),
// near, far [n_rays] fp32 in; acc_s, acc_e [n_rays] fp32, unf [n_rays] uint8
// and the executed-evaluation count (uint64, zeroed by the caller) out.
int nefii_sphere_trace(const void* cam, const void* dirs, const void* isect, const void* near,
                       const void* far, const void* wbuf, const long long* desc, int n_layers,
                       int x_cols, const void* wlast, float bl, float thresh, float ls_factor,
                       int ls_iters, int trace_iters, int multires, void* acc_s, void* acc_e,
                       void* unf, void* n_evals, long long n_rays, void* stream) {
  Plan plan;
  const int d_emb = 3 * (1 + 2 * multires);
  if (!make_plan(desc, n_layers, x_cols, &plan) || n_rays <= 0 || multires < 0 ||
      d_emb > x_cols || ls_iters < 0 || trace_iters < 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n_rays + TR - 1) / TR;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const TraceCfg cfg{thresh, ls_factor, ls_iters, trace_iters, multires, d_emb};
  const int smem = (WIDTH + x_cols) * BM * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sphere_trace_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sphere_trace_kernel<<<(unsigned)grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cam), static_cast<const float*>(dirs),
      static_cast<const uint8_t*>(isect), static_cast<const float*>(near),
      static_cast<const float*>(far), static_cast<const float*>(wbuf), plan,
      static_cast<const float*>(wlast), bl, cfg, static_cast<float*>(acc_s),
      static_cast<float*>(acc_e), static_cast<uint8_t*>(unf),
      static_cast<unsigned long long*>(n_evals), n_rays);
  return (int)cudaGetLastError();
}

}  // extern "C"
