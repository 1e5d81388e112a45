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
// What bounds both on this card: instruction issue in the step loop. Per
// path-step a thread runs Threefry-2x32 (20 rounds of add, rotate, xor and
// 5 key injections: about 70 integer instructions, which go to the ALU
// pipe of 16 lanes per SM sub-partition, one warp instruction every two
// cycles) and the accurate logf, sqrtf, sincosf and expf of Box-Muller and
// the Euler step (FP32 pipe, and the MUFU pipe for ex2/rsqrt). Bytes are
// negligible: 68 B in per task, 8 B out per (task, block).
//
// Design. The work unit is kUnit = 128 paths: one path per thread of a
// 128-thread CTA, its state (S, v, sum, min, max) in registers for the
// whole step loop.
// - Padding. The batch kernel's grid is the flat list of ACTIVE (task,
//   block) pairs, those with b * block_paths < n_active[t], each split into
//   block_paths / kUnit units. The wrapper builds the int32 prefix offsets
//   of ceil(n_active[t] / block_paths) on the host, from host counts, and a
//   CTA finds its task by a binary search over them; a thread whose path id
//   is >= n_active[t] skips the step loop, so a warp past a task's last
//   path issues nothing. A launch simulates the paths asked for, rounded up
//   to whole warps, not every task up to the largest count.
// - Waves. A unit is one path per thread, so the last wave of CTAs is one
//   path long. __launch_bounds__ pins the registers at the counts that fit
//   16 (Black-Scholes) and 12 (Heston) CTAs on an SM. The step loop is
//   unrolled by two, so a thread has two steps' independent Threefry work
//   to issue where one step's transcendentals stall; this carries the
//   single-task kernel, whose 512 CTAs leave about 4 warps a scheduler.
// - SM fill. The single-task kernel also runs one CTA per unit: 512 CTAs
//   for 65,536 paths, on all 132 SMs.
// - Combine. Each CTA reduces its unit's (sum, sumsq) in a fixed order (a
//   warp shuffle tree, then the four warp partials in warp order) into a
//   scratch array; mc_combine_kernel then sums each (task, block)'s units
//   in unit order into out and writes exactly 0 to the slots of inactive
//   blocks. No atomics: two runs are bitwise equal.
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
constexpr int kUnit = 128;  // paths of a work unit = threads of a CTA
constexpr int kWarps = kUnit / 32;
constexpr int kCombineThreads = 256;
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
  // two steps a pass (see the note at the top)
#pragma unroll 2
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

// Fixed-order reduction of one unit's (sum, sumsq): shuffle tree per warp,
// then the kWarps warp partials in warp order by thread 0, which writes
// o[0..1]. Ends with a barrier, so the shared partials may be reused.
__device__ __forceinline__ void unit_sum_store(float sum, float sumsq,
                                               float* warp_sum, float* warp_sq,
                                               float* o) {
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
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += warp_sum[w];
      q += warp_sq[w];
    }
    o[0] = a;
    o[1] = q;
  }
  __syncthreads();
}

// The task of active block `a`: the last t with offsets[t] <= a, so that
// offsets[t] <= a < offsets[t + 1] (tasks with no active block are empty
// ranges and never match). offsets has n_tasks + 1 entries, offsets[0] = 0.
__device__ __forceinline__ int task_of_block(const int32_t* __restrict__ offsets,
                                             int n_tasks, int a) {
  int lo = 0, hi = n_tasks;  // offsets[lo] <= a < offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= a) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Registers pinned by __launch_bounds__ so that 16 (Black-Scholes, <= 32
// registers: the SM's 2,048 threads) or 12 (Heston, <= 40) CTAs of kUnit
// threads fit on an SM.
template <int kModel>
struct BatchOccupancy {
  static constexpr int kCtasPerSm = kModel == kBlackScholes ? 16 : 12;
};

// One CTA per unit u = blockIdx.x of the active-block list: unit u is part
// u % units_per_block of active block a = u / units_per_block. It writes
// the unit's (sum, sumsq) to partial[u, :].
template <int kModel>
__global__ void __launch_bounds__(kUnit, BatchOccupancy<kModel>::kCtasPerSm)
mc_batch_kernel(const float* __restrict__ params,
                const uint32_t* __restrict__ task_ids,
                const int32_t* __restrict__ payoff_kinds,
                const uint32_t* __restrict__ n_active,
                const int32_t* __restrict__ block_offsets, uint32_t seed,
                int n_tasks, int n_steps, int units_per_block,
                float* __restrict__ partial) {
  __shared__ float warp_sum[kWarps];
  __shared__ float warp_sq[kWarps];

  const int u = static_cast<int>(blockIdx.x);
  const int a = u / units_per_block;
  const int t = task_of_block(block_offsets, n_tasks, a);
  const uint32_t b = static_cast<uint32_t>(a - __ldg(block_offsets + t));
  const uint32_t pid = (b * static_cast<uint32_t>(units_per_block) +
                        static_cast<uint32_t>(u - a * units_per_block)) *
                           kUnit + threadIdx.x;
  const float* p = params + static_cast<size_t>(t) * N_PARAMS;
  float pay = 0.0f;
  if (pid < __ldg(n_active + t)) {
    const StepConsts c = step_consts(p);
    float s_t, avg, mn, mx;
    simulate_path<kModel>(c, seed, __ldg(task_ids + t), pid, n_steps, s_t,
                          avg, mn, mx);
    pay = coded_payoff(s_t, avg, mn, mx, p, __ldg(payoff_kinds + t));
  }
  unit_sum_store(pay, pay * pay, warp_sum, warp_sq,
                 partial + static_cast<size_t>(u) * 2);
}

// One task's float32 scalars in PARAM_COLS order, passed by value.
struct TaskScalars {
  float p[N_PARAMS];
};

// One CTA per unit: paths blockIdx.x * kUnit + threadIdx.x of the task.
template <int kModel, int kPayoff>
__global__ void __launch_bounds__(kUnit)
mc_task_kernel(const TaskScalars task, uint32_t seed, uint32_t task_id,
               int n_steps, float* __restrict__ partial) {
  __shared__ float warp_sum[kWarps];
  __shared__ float warp_sq[kWarps];

  const StepConsts c = step_consts(task.p);
  const uint32_t pid = blockIdx.x * static_cast<uint32_t>(kUnit) + threadIdx.x;
  float s_t, avg, mn, mx;
  simulate_path<kModel>(c, seed, task_id, pid, n_steps, s_t, avg, mn, mx);
  const float pay = coded_payoff(s_t, avg, mn, mx, task.p, kPayoff);
  unit_sum_store(pay, pay * pay, warp_sum, warp_sq,
                 partial + static_cast<size_t>(blockIdx.x) * 2);
}

// out[t, b, :] = the sum, in unit order, of the units_per_block unit
// partials of block b of task t, or exactly 0 if that block is inactive.
// block_offsets == nullptr means every block is active and unit partials
// lie in (t, b) order (the single-task kernel).
__global__ void __launch_bounds__(kCombineThreads)
mc_combine_kernel(const float* __restrict__ partial,
                  const int32_t* __restrict__ block_offsets, int n_tasks,
                  int blocks, int units_per_block, float* __restrict__ out) {
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= n_tasks * blocks) return;
  int first = i;
  if (block_offsets != nullptr) {
    const int t = i / blocks;
    const int b = i - t * blocks;
    const int start = __ldg(block_offsets + t);
    first = b < __ldg(block_offsets + t + 1) - start ? start + b : -1;
  }
  float sum = 0.0f, sumsq = 0.0f;
  if (first >= 0) {
    const float* p = partial + static_cast<size_t>(first) * units_per_block * 2;
    for (int k = 0; k < units_per_block; ++k) {
      sum += p[2 * k];
      sumsq += p[2 * k + 1];
    }
  }
  out[2 * static_cast<size_t>(i)] = sum;
  out[2 * static_cast<size_t>(i) + 1] = sumsq;
}

void launch_combine(const float* partial, const int32_t* block_offsets,
                    int n_tasks, int blocks, int units_per_block, float* out,
                    cudaStream_t s) {
  const int slots = n_tasks * blocks;
  mc_combine_kernel<<<(slots + kCombineThreads - 1) / kCombineThreads,
                      kCombineThreads, 0, s>>>(partial, block_offsets, n_tasks,
                                               blocks, units_per_block, out);
}

template <int kModel>
const void* task_kernel(int payoff_kind) {
  switch (payoff_kind) {
    case EUROPEAN: return reinterpret_cast<const void*>(&mc_task_kernel<kModel, EUROPEAN>);
    case ASIAN: return reinterpret_cast<const void*>(&mc_task_kernel<kModel, ASIAN>);
    case BARRIER: return reinterpret_cast<const void*>(&mc_task_kernel<kModel, BARRIER>);
    case DOUBLE_BARRIER:
      return reinterpret_cast<const void*>(&mc_task_kernel<kModel, DOUBLE_BARRIER>);
    default:
      return reinterpret_cast<const void*>(&mc_task_kernel<kModel, DIGITAL_DOUBLE_BARRIER>);
  }
}

bool valid_kinds(int model_kind, int payoff_kind) {
  return (model_kind == kBlackScholes || model_kind == kHeston) &&
         payoff_kind >= EUROPEAN && payoff_kind <= DIGITAL_DOUBLE_BARRIER;
}

constexpr int kMaxInt = 2147483647;

}  // namespace

// Launches the batch kernel, one CTA per unit, for the n_units =
// block_offsets[n_tasks] * block_paths / kUnit units of the active-block
// list, then the combine kernel, both on `stream`; returns
// cudaGetLastError() (0 on success). All pointers are device pointers:
// block_offsets is the (n_tasks + 1,) int32 prefix sum of each task's
// active blocks, partial is (n_units, 2) float32 scratch, and out is the
// (n_tasks, blocks, 2) float32 result, every slot of which is written.
extern "C" int mc_moments_batch_launch(
    const float* params, const uint32_t* task_ids, const int32_t* payoff_kinds,
    const uint32_t* n_active, const int32_t* block_offsets, uint32_t seed,
    int model_kind, int n_tasks, int n_steps, int blocks, int block_paths,
    int n_units, float* partial, float* out, void* stream) {
  if (n_tasks < 1 || blocks < 1 || n_steps < 1 || block_paths < kUnit ||
      block_paths % kUnit != 0 || n_units < 0 ||
      n_tasks > kMaxInt / blocks || !valid_kinds(model_kind, EUROPEAN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units_per_block = block_paths / kUnit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_units > 0) {
    const dim3 grid(static_cast<unsigned>(n_units));
    if (model_kind == kBlackScholes) {
      mc_batch_kernel<kBlackScholes><<<grid, kUnit, 0, s>>>(
          params, task_ids, payoff_kinds, n_active, block_offsets, seed,
          n_tasks, n_steps, units_per_block, partial);
    } else {
      mc_batch_kernel<kHeston><<<grid, kUnit, 0, s>>>(
          params, task_ids, payoff_kinds, n_active, block_offsets, seed,
          n_tasks, n_steps, units_per_block, partial);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_combine(partial, block_offsets, n_tasks, blocks, units_per_block, out, s);
  return static_cast<int>(cudaGetLastError());
}

// Launches the single-task kernel on `stream` over blocks * block_paths /
// kUnit CTAs, one per unit, then the combine kernel; returns
// cudaGetLastError() (0 on success). `scalars` is a HOST pointer to the
// task's N_PARAMS float32 scalars in PARAM_COLS order, copied into the
// kernel argument; partial is device scratch of (units, 2) float32 and out
// a device pointer to (blocks, 2) float32.
extern "C" int mc_moments_task_launch(const float* scalars, uint32_t seed,
                                      uint32_t task_id, int model_kind,
                                      int payoff_kind, int n_steps, int blocks,
                                      int block_paths, float* partial,
                                      float* out, void* stream) {
  if (scalars == nullptr || blocks < 1 || n_steps < 1 ||
      block_paths < kUnit || block_paths % kUnit != 0 ||
      blocks > kMaxInt / (block_paths / kUnit) ||
      !valid_kinds(model_kind, payoff_kind)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TaskScalars task;
  for (int i = 0; i < N_PARAMS; ++i) task.p[i] = scalars[i];
  const int units_per_block = block_paths / kUnit;
  const dim3 grid(static_cast<unsigned>(blocks * units_per_block));
  const void* kernel = model_kind == kBlackScholes
                           ? task_kernel<kBlackScholes>(payoff_kind)
                           : task_kernel<kHeston>(payoff_kind);
  void* args[] = {&task, &seed, &task_id, &n_steps, &partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kUnit), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_combine(partial, nullptr, 1, blocks, units_per_block, out, s);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of one kernel that an SM holds at once (the occupancy calculator's
// answer for kUnit-thread CTAs): the batch kernel if task_kernel is 0, else
// the single-task kernel for payoff_kind. Returns a cudaError_t code.
extern "C" int mc_ctas_per_sm(int task_kernel_of, int model_kind,
                              int payoff_kind, int* ctas) {
  if (ctas == nullptr || !valid_kinds(model_kind, payoff_kind)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel;
  if (task_kernel_of) {
    kernel = model_kind == kBlackScholes ? task_kernel<kBlackScholes>(payoff_kind)
                                         : task_kernel<kHeston>(payoff_kind);
  } else {
    kernel = model_kind == kBlackScholes
                 ? reinterpret_cast<const void*>(&mc_batch_kernel<kBlackScholes>)
                 : reinterpret_cast<const void*>(&mc_batch_kernel<kHeston>);
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kUnit, 0));
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
