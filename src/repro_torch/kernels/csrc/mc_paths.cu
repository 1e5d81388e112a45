// Monte Carlo moments kernels for Hopper (sm_90a).
//
// mc_batch_kernel replaces the Pallas TPU kernel `_mc_batch_kernel` in
// src/repro/kernels/mc_paths.py (launched by `mc_moments_batch_kernel_call`).
// For every (task t, path block b) it simulates `block_paths` paths with
// global ids b * block_paths + i, drawing a Threefry-2x32 normal pair keyed
// (seed, task_id) on the counter (path id, step); integrates Black-Scholes
// log-Euler or Heston full-truncation Euler for `n_steps`; keeps the running
// sum, min and max; applies the coded five-kind payoff; masks paths with
// id >= n_active[t]; and writes (sum payoff, sum payoff^2) to out[t, b, :].
//
// mc_task_kernel replaces the single-task Pallas kernel `_mc_kernel` in the
// same file (launched by `mc_moments_kernel_call`): the same simulation for
// one task whose model and payoff kind are template parameters (the TPU
// kernel bakes the task in at trace time) and whose float32 scalars arrive
// by value as a kernel argument; no n_active mask, since n_paths is a whole
// number of blocks. It writes (sum, sumsq) per path block to out[b, :].
//
// What bounds both: operations. Per path-step they issue about 80 int32
// operations for Threefry (20 rounds of add, rotate, xor plus 5 key
// injections) and about 90 fp32 operations for logf, sincosf, expf and sqrtf
// and the Euler step, all on registers. Bytes are negligible: 56 B of
// parameters and 12 B of task scalars in per task, 8 B out per (task, block).
//
// Design: one thread per path, its state (S, v, sum, min, max) in registers
// for the whole time loop. In the batch kernel blockIdx.y is the task and
// blockIdx.x the path block; a CUDA block of 128 or 256 threads walks
// block_paths / blockDim.x paths per thread, and each block reads its own
// task's parameter row (the TPU kernel's SMEM scalar prefetch has no
// analogue). The task kernel's grid is the path blocks alone, with
// min(block_paths, 1024) threads a block, so one task's 64 blocks of 1024
// paths still put one path on each thread. Each block's (sum, sumsq)
// reduction is in a fixed order — a warp shuffle tree, then the warp
// partials summed in warp order by thread 0 — so two runs are bitwise equal.
//
// Numerics: build WITHOUT --use_fast_math and WITH --fmad=false. Fast math
// would swap logf/sincosf/expf/sqrtf for approximations and break the float32
// `inf` upper barrier; fmad=false keeps the float32 operation order of the
// reference, whose XLA CPU code does not contract to FMA. A later change may
// relax either flag once parity is measured with it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Column order of TaskBatch.params (pricing/contracts.py PARAM_COLS).
enum Col : int {
  SPOT = 0, RATE, DT, VOL, V0, KAPPA, THETA, XI, RHO,
  STRIKE, LOWER, UPPER, PAYOUT, CALL_SIGN, N_PARAMS
};

// Payoff codes (pricing/contracts.py EUROPEAN ... DIGITAL_DOUBLE_BARRIER).
enum Payoff : int {
  EUROPEAN = 0, ASIAN, BARRIER, DOUBLE_BARRIER, DIGITAL_DOUBLE_BARRIER
};

constexpr int kBlackScholes = 0;
constexpr int kHeston = 1;
constexpr int kMaxThreads = 256;       // batch kernel
constexpr int kMaxTaskThreads = 1024;  // task kernel
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979);
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;  // 2^-24

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four Threefry rounds with rotation constants r0..r3.
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int r0,
                                        int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// 20-round Threefry-2x32 on (x0, x1) in place; bit-equal to kernels/prng.py:
// after 4-round block j the key words ks[(j+1)%3] and ks[(j+2)%3] + j + 1
// are injected, with ks = (k0, k1, k0 ^ k1 ^ parity).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

// Two N(0,1) draws for counter (pid, step) by Box-Muller, as kernels/prng.py.
__device__ __forceinline__ void normal_pair(uint32_t k0, uint32_t k1,
                                            uint32_t pid, uint32_t step,
                                            float& z0, float& z1) {
  uint32_t a = pid, b = step;
  threefry2x32(k0, k1, a, b);
  const float u0 = (static_cast<float>(a >> 8) + 0.5f) * kTwoPow24Inv;
  const float u1 = (static_cast<float>(b >> 8) + 0.5f) * kTwoPow24Inv;
  const float r = sqrtf(-2.0f * logf(u0));
  const float theta = kTwoPi * u1;
  float sn, cs;
  sincosf(theta, &sn, &cs);
  z0 = r * cs;
  z1 = r * sn;
}

// payoff_from_stats_coded of pricing/contracts.py; `upper` may be inf.
__device__ __forceinline__ float coded_payoff(float s_t, float avg, float mn,
                                              float mx, const float* p,
                                              int kind) {
  const float call_sign = p[CALL_SIGN];
  const float vanilla = fmaxf(call_sign * (s_t - p[STRIKE]), 0.0f);
  const float asian = fmaxf(call_sign * (avg - p[STRIKE]), 0.0f);
  const bool alive_up = mx < p[UPPER];
  const bool alive = alive_up && (mn > p[LOWER]);
  switch (kind) {
    case EUROPEAN: return vanilla;
    case ASIAN: return asian;
    case BARRIER: return alive_up ? vanilla : 0.0f;
    case DOUBLE_BARRIER: return alive ? vanilla : 0.0f;
    default: return alive ? p[PAYOUT] : 0.0f;  // digital double barrier
  }
}

// Per-task constants of the Euler steps, in the reference's float32 order
// (bs_step_fn, heston_step_fn), from a PARAM_COLS row.
struct StepConsts {
  float spot, v0, rate, dt, drift, vol_dt, kappa, theta, xi, rho, rho_c,
      sqrt_dt;
};

__device__ __forceinline__ StepConsts step_consts(const float* p) {
  StepConsts c;
  c.spot = p[SPOT];
  c.v0 = p[V0];
  c.rate = p[RATE];
  c.dt = p[DT];
  const float vol = p[VOL];
  c.drift = (c.rate - 0.5f * vol * vol) * c.dt;
  c.vol_dt = vol * sqrtf(c.dt);
  c.kappa = p[KAPPA];
  c.theta = p[THETA];
  c.xi = p[XI];
  c.rho = p[RHO];
  c.rho_c = sqrtf(fmaxf(1.0f - c.rho * c.rho, 0.0f));
  c.sqrt_dt = sqrtf(c.dt);
  return c;
}

// One path `pid` through n_steps: terminal price, running average over the
// post-initial observations, and min/max including the initial spot.
template <int kModel>
__device__ __forceinline__ void simulate_path(const StepConsts& c, uint32_t k0,
                                              uint32_t k1, uint32_t pid,
                                              int n_steps, float& s_t,
                                              float& avg, float& mn,
                                              float& mx) {
  float s = c.spot, v = c.v0, acc = 0.0f;
  mn = c.spot;
  mx = c.spot;
  for (int step = 0; step < n_steps; ++step) {
    float z0, z1;
    normal_pair(k0, k1, pid, static_cast<uint32_t>(step), z0, z1);
    if (kModel == kBlackScholes) {
      s = s * expf(c.drift + c.vol_dt * z0);
    } else {
      const float z_v = c.rho * z0 + c.rho_c * z1;
      const float v_plus = fmaxf(v, 0.0f);
      const float sqrt_v = sqrtf(v_plus);
      const float s_new =
          s * expf((c.rate - 0.5f * v_plus) * c.dt + sqrt_v * c.sqrt_dt * z0);
      v = v + c.kappa * (c.theta - v_plus) * c.dt +
          c.xi * sqrt_v * c.sqrt_dt * z_v;
      s = s_new;
    }
    acc = acc + s;
    mn = fminf(mn, s);
    mx = fmaxf(mx, s);
  }
  s_t = s;
  avg = acc / static_cast<float>(n_steps);
}

// Fixed-order block reduction of (sum, sumsq): shuffle tree per warp, then
// the warp partials in warp order by thread 0, which writes o[0..1].
__device__ __forceinline__ void block_sum_store(float sum, float sumsq,
                                                float* warp_sum,
                                                float* warp_sq, float* o) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    sumsq += __shfl_down_sync(0xffffffffu, sumsq, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_sum[warp] = sum;
    warp_sq[warp] = sumsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, q = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      a += warp_sum[w];
      q += warp_sq[w];
    }
    o[0] = a;
    o[1] = q;
  }
}

template <int kModel>
__global__ void __launch_bounds__(kMaxThreads)
mc_batch_kernel(const float* __restrict__ params,
                const uint32_t* __restrict__ task_ids,
                const int32_t* __restrict__ payoff_kinds,
                const uint32_t* __restrict__ n_active, uint32_t seed,
                int n_steps, int block_paths, float* __restrict__ out) {
  __shared__ float warp_sum[kMaxThreads / 32];
  __shared__ float warp_sq[kMaxThreads / 32];

  const int t = blockIdx.y;
  const int b = blockIdx.x;
  const float* p = params + static_cast<size_t>(t) * N_PARAMS;
  const uint32_t k1 = task_ids[t];
  const int kind = payoff_kinds[t];
  const uint32_t n_act = n_active[t];
  const StepConsts c = step_consts(p);

  float sum = 0.0f, sumsq = 0.0f;
  const uint32_t base = static_cast<uint32_t>(b) * static_cast<uint32_t>(block_paths);
  for (int i = threadIdx.x; i < block_paths; i += blockDim.x) {
    const uint32_t pid = base + static_cast<uint32_t>(i);
    float s_t, avg, mn, mx;
    simulate_path<kModel>(c, seed, k1, pid, n_steps, s_t, avg, mn, mx);
    float pay = coded_payoff(s_t, avg, mn, mx, p, kind);
    if (pid >= n_act) pay = 0.0f;
    sum += pay;
    sumsq += pay * pay;
  }
  block_sum_store(sum, sumsq, warp_sum, warp_sq,
                  out + (static_cast<size_t>(t) * gridDim.x + b) * 2);
}

// One task's float32 scalars in PARAM_COLS order, passed by value.
struct TaskScalars {
  float p[N_PARAMS];
};

template <int kModel, int kPayoff>
__global__ void __launch_bounds__(kMaxTaskThreads)
mc_task_kernel(const TaskScalars task, uint32_t seed, uint32_t task_id,
               int n_steps, int block_paths, float* __restrict__ out) {
  __shared__ float warp_sum[kMaxTaskThreads / 32];
  __shared__ float warp_sq[kMaxTaskThreads / 32];

  const int b = blockIdx.x;
  const StepConsts c = step_consts(task.p);

  float sum = 0.0f, sumsq = 0.0f;
  const uint32_t base = static_cast<uint32_t>(b) * static_cast<uint32_t>(block_paths);
  for (int i = threadIdx.x; i < block_paths; i += blockDim.x) {
    const uint32_t pid = base + static_cast<uint32_t>(i);
    float s_t, avg, mn, mx;
    simulate_path<kModel>(c, seed, task_id, pid, n_steps, s_t, avg, mn, mx);
    const float pay = coded_payoff(s_t, avg, mn, mx, task.p, kPayoff);
    sum += pay;
    sumsq += pay * pay;
  }
  block_sum_store(sum, sumsq, warp_sum, warp_sq,
                  out + static_cast<size_t>(b) * 2);
}

template <int kModel>
void launch_task(const TaskScalars& task, uint32_t seed, uint32_t task_id,
                 int payoff_kind, int n_steps, int blocks, int block_paths,
                 int threads, float* out, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (payoff_kind) {
    case EUROPEAN:
      mc_task_kernel<kModel, EUROPEAN><<<grid, threads, 0, s>>>(
          task, seed, task_id, n_steps, block_paths, out);
      break;
    case ASIAN:
      mc_task_kernel<kModel, ASIAN><<<grid, threads, 0, s>>>(
          task, seed, task_id, n_steps, block_paths, out);
      break;
    case BARRIER:
      mc_task_kernel<kModel, BARRIER><<<grid, threads, 0, s>>>(
          task, seed, task_id, n_steps, block_paths, out);
      break;
    case DOUBLE_BARRIER:
      mc_task_kernel<kModel, DOUBLE_BARRIER><<<grid, threads, 0, s>>>(
          task, seed, task_id, n_steps, block_paths, out);
      break;
    default:
      mc_task_kernel<kModel, DIGITAL_DOUBLE_BARRIER><<<grid, threads, 0, s>>>(
          task, seed, task_id, n_steps, block_paths, out);
      break;
  }
}

}  // namespace

// Launches the kernel on `stream` over a (blocks, n_tasks) grid of
// `threads`-thread blocks and returns cudaGetLastError() (0 on success).
// All pointers are device pointers; out is (n_tasks, blocks, 2) float32.
extern "C" int mc_moments_batch_launch(
    const float* params, const uint32_t* task_ids, const int32_t* payoff_kinds,
    const uint32_t* n_active, uint32_t seed, int model_kind, int n_tasks,
    int n_steps, int blocks, int block_paths, int threads, float* out,
    void* stream) {
  if (n_tasks < 1 || n_tasks > 65535 || blocks < 1 || n_steps < 1 ||
      (threads != 128 && threads != 256) || block_paths % threads != 0 ||
      (model_kind != kBlackScholes && model_kind != kHeston)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_tasks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model_kind == kBlackScholes) {
    mc_batch_kernel<kBlackScholes><<<grid, threads, 0, s>>>(
        params, task_ids, payoff_kinds, n_active, seed, n_steps, block_paths, out);
  } else {
    mc_batch_kernel<kHeston><<<grid, threads, 0, s>>>(
        params, task_ids, payoff_kinds, n_active, seed, n_steps, block_paths, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the single-task kernel on `stream` over `blocks` blocks of
// `threads` threads and returns cudaGetLastError() (0 on success).
// `scalars` is a HOST pointer to the task's N_PARAMS float32 scalars in
// PARAM_COLS order, copied into the kernel argument; out is a device
// pointer to (blocks, 2) float32.
extern "C" int mc_moments_task_launch(const float* scalars, uint32_t seed,
                                      uint32_t task_id, int model_kind,
                                      int payoff_kind, int n_steps, int blocks,
                                      int block_paths, int threads, float* out,
                                      void* stream) {
  if (scalars == nullptr || blocks < 1 || n_steps < 1 || threads < 32 ||
      threads > kMaxTaskThreads || threads % 32 != 0 ||
      block_paths < threads ||
      (model_kind != kBlackScholes && model_kind != kHeston) ||
      payoff_kind < EUROPEAN || payoff_kind > DIGITAL_DOUBLE_BARRIER) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TaskScalars task;
  for (int i = 0; i < N_PARAMS; ++i) task.p[i] = scalars[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (model_kind == kBlackScholes) {
    launch_task<kBlackScholes>(task, seed, task_id, payoff_kind, n_steps,
                               blocks, block_paths, threads, out, s);
  } else {
    launch_task<kHeston>(task, seed, task_id, payoff_kind, n_steps, blocks,
                         block_paths, threads, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
