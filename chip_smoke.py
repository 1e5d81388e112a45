#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Print the card (``nvidia-smi`` name and power limit, torch's device
   name) and build the kernels from ``src/repro_torch/kernels/csrc``.
2. Hold both CUDA kernels against their plain PyTorch versions on the card:
   the family-batched moments kernel at the calibration shape of each
   Table 1 launch group, on a ragged path-count case at three path-block
   sizes, with zero-count tasks, and with one 4,194,304-path task among
   short ones (the slots of inactive blocks must be exactly 0, in memory
   poisoned with NaN first); the single-task kernel on one task of each of
   the 10 (model, payoff) categories, at three path-block sizes, and
   against the batch kernel on the same task. Two runs of a kernel must be
   bitwise equal; the card must agree with the CPU on a small input.
3. Drive the main path: ``PricingSolver(table1_workload(), build_cluster())``
   — 128 tasks of 256 steps on the 16 simulated Table 2 platforms plus the
   local card — through characterise, allocate (MILP, heuristic and the
   simulated-annealing "ml" solver) and execute, counting kernel launches
   and the paths the card simulated against the paths asked for.
4. Drive the online loop on the same workload and cluster: a static "ml"
   plan and ``OnlineScheduler`` with "ml", both under a 4x slowdown of the
   busiest simulated platform at the plan's half-makespan.
5. Time both kernels, their plain versions and their bounds with CUDA
   events at the calibration shapes of phase 2 (the batch kernel also at
   the MILP plan's local execute launches of phase 3, those small enough
   and the smallest of each model held against the plain version as in
   phase 2), print each
   launch's CTAs and waves and the SM clock, and print one
   ``{"kernels": [...]}`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ACCURACY = 0.05
CALIB_PATHS = 65536
CALIB_SEED = 10_007
BLOCK_PATHS = 1024
# the long-tail case: one task of this many paths among <= 4,096-path ones
LONG_TAIL_PATHS = 4_194_304
# the card's paths simulated over paths asked, on the local execute launches
MAX_SIMULATED_OVER_ASKED = 1.01
# the MILP execute launches held against the plain version in phase 5: all
# whose plain version simulates at most this many paths (about 10 s each)
PLAIN_CHECK_PATHS = 2 ** 25
# LocalTorchPlatform.run_batch prices each shard list twice: an untimed
# warm-up, then the timed run
RUNS_PER_DISPATCH = 2
# kernel against plain version, both on the card: bit-equal Threefry draws
# through the same CUDA math library, so only the float32 summation order
# of the 1024-path block sums differs. rtol 3e-5 is the reference's own
# kernel-vs-oracle bar.
RTOL = 3e-5

# The kernel's work per path-step, counted from csrc/mc_paths.cu, with each
# transcendental call (logf, sqrtf, sincosf as two, expf) counted as one
# operation so the bound is a true lower bound:
#   int32: Threefry 2 key adds + 2 xors (k2) + 20 rounds x (add, rotate,
#          xor) + 5 injections x 3 adds = 79; uniforms 2 shifts -> 81
#   fp32:  uniforms 2 converts + 2 adds + 2 muls; Box-Muller log, mul,
#          sqrt, mul, sin, cos, 2 muls; running sum, min, max -> 17, plus
#          the step: BS mul, add, exp, mul = 4; Heston 21 (see the source)
INT_OPS_PER_STEP = 81
FP_OPS_PER_STEP = {"black-scholes": 17 + 4, "heston": 17 + 21}
# Per path after the loop: avg divide, payoff (2 sub, 2 mul, 2 max,
# 3 compares/selects), mask, sum, square, add -> 13.
OPS_PER_PATH = 13
# Peak rates of an H100 SXM (NVIDIA data sheet, at 700 W): 67 TFLOP/s fp32
# outside the tensor cores, 3.35 TB/s HBM3. The table lists no int32 rate
# outside the tensor cores, so int32 operations are charged at the fp32
# rate, which keeps the bound a lower bound.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# bytes per task in (14 float32 params, task id, payoff kind, n_active)
# and per (task, block) out (sum, sumsq)
BYTES_IN_PER_TASK = 14 * 4 + 3 * 4
BYTES_OUT_PER_BLOCK = 2 * 4
# the single-task kernel: 14 float32 scalars, seed and task id in; no mask
TASK_BYTES_IN = 14 * 4 + 2 * 4
TASK_OPS_PER_PATH = OPS_PER_PATH - 1
# one task of each (model, payoff) category for the single-task kernel
TASK_CATEGORIES = ["BS-E", "BS-A", "BS-B", "BS-DB", "BS-DDB",
                   "H-E", "H-A", "H-B", "H-DB", "H-DDB"]
# the online loop: rounds of the feedback controller, slowdown factor
ONLINE_ROUNDS = 8
SLOWDOWN = 4.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# GPU clock cycles (about 20 ms at 2 GHz) that the stream spins before a
# timed run, so the host enqueues the run's launches while the card waits
# and the events time the launches back to back, not the host's enqueue
SPIN_CYCLES = 40_000_000


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events around the whole run, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def partial_errors(got, want) -> tuple[float, float]:
    """(max abs, max rel) error of kernel partials against the plain
    version's; an exact match counts as zero relative error."""
    import torch

    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    rel = torch.where(diff == 0, torch.zeros_like(rel), rel)
    return float(diff.max()), float(rel.max())


def bound_ms(model_kind: str, n_tasks: int, paths: int, n_steps: int,
             out_blocks: int, ops_per_path: int = OPS_PER_PATH,
             bytes_in_per_task: int = BYTES_IN_PER_TASK) -> tuple[float, str, float]:
    """(bound ms, what bounds it, operations) for one launch of ``n_tasks``
    tasks that ask for ``paths`` paths in all and write ``out_blocks``
    (sum, sumsq) pairs: only the paths asked for are counted."""
    ops = paths * n_steps * (INT_OPS_PER_STEP + FP_OPS_PER_STEP[model_kind]) + paths * ops_per_path
    n_bytes = n_tasks * bytes_in_per_task + out_blocks * BYTES_OUT_PER_BLOCK
    t_ops = ops / PEAK_OPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


def waves(ctas: int, per_sm: int, sms: int) -> tuple[float, float]:
    """(waves, idle share of the last wave) of ``ctas`` CTAs on ``sms`` SMs
    that hold ``per_sm`` each at once."""
    w = ctas / (per_sm * sms)
    return w, (math.ceil(w) - w) / max(math.ceil(w), 1)


def poison(shape, device) -> None:
    """Allocate and free NaN-filled tensors of ``shape``, so the caching
    allocator hands the next allocations of that size back unzeroed."""
    import torch

    junk = [torch.full(shape, float("nan"), device=device) for _ in range(3)]
    del junk


def inactive_slots_zero(got, n_active, block_paths: int, mc_paths) -> bool:
    """True if every (task, block) slot past a task's active blocks is
    exactly 0 in the (T, blocks, 2) partials ``got``."""
    import numpy as np

    offsets = mc_paths.active_block_offsets(n_active, block_paths)
    active = np.diff(offsets)
    return all(bool((got[t, int(active[t]):] == 0).all()) for t in range(got.shape[0]))


def check_batch_case(mc_paths, key, batch, n_active, block: int, dev) -> tuple[float, float]:
    """Hold the batch kernel against its plain version on the card for one
    launch: two runs in NaN-poisoned memory must be bitwise equal, finite,
    exactly 0 in the slots of inactive blocks, and within ``RTOL`` of the
    plain version, slot by slot and summed. Returns (max abs, max rel)."""
    import torch

    n_max = -(-int(n_active.max()) // block) * block
    n_act = torch.from_numpy(n_active).to(dev)
    poison((batch.n_tasks, n_max // block, 2), dev)
    got = mc_paths.mc_moments_batch_kernel_call(batch, n_active, CALIB_SEED, n_max, block)
    again = mc_paths.mc_moments_batch_kernel_call(batch, n_active, CALIB_SEED, n_max, block)
    want = mc_paths.mc_moments_batch_ref(batch, n_act, CALIB_SEED, n_max, block)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{key}: two kernel runs differ")
    check(bool(torch.isfinite(got).all()), f"{key}: non-finite partials")
    check(inactive_slots_zero(got, n_active, block, mc_paths),
          f"{key}: a slot of an inactive block is not exactly 0")
    err_abs, err_rel = partial_errors(got, want)
    sums_rel = ((got.sum(1) - want.sum(1)).abs()
                / want.sum(1).abs().clamp_min(torch.finfo(torch.float32).tiny))
    log(f"kernel vs plain {key}: partials {tuple(got.shape)} max abs "
        f"{err_abs:.3e} max rel {err_rel:.3e}; summed "
        f"moments max rel {float(sums_rel.max()):.3e}; {mc_paths.last_launch_ctas()} "
        f"CTAs; bitwise repeat ok; inactive slots exactly 0")
    check(err_rel <= RTOL, f"{key}: partials differ beyond rtol {RTOL}")
    check(float(sums_rel.max()) <= RTOL, f"{key}: moments differ beyond rtol {RTOL}")
    return err_abs, err_rel


def time_kernels(mc_paths, groups, milp_launches, cat_tasks, sms: int, dev):
    """Phase 5's timings: (per calibration group, per execute launch, per
    single-task category), each a list of dicts, also logged."""
    import numpy as np
    import torch
    from repro_torch.pricing import TaskBatch

    per_group = []
    for key, batch in groups:
        n_act = np.full(batch.n_tasks, CALIB_PATHS, np.uint32)
        n_act_dev = torch.from_numpy(n_act).to(dev)
        per_sm = mc_paths.ctas_per_sm("mc_moments_batch", batch.model_kind)

        def kernel():
            mc_paths.mc_moments_batch_kernel_call(batch, n_act, CALIB_SEED, CALIB_PATHS,
                                                  BLOCK_PATHS)

        def plain():
            mc_paths.mc_moments_batch_ref(batch, n_act_dev, CALIB_SEED, CALIB_PATHS, BLOCK_PATHS)

        k_ms = cuda_ms(kernel, reps=20, warmup=2)
        ctas = mc_paths.last_launch_ctas()
        k_ms_again = cuda_ms(kernel, reps=20, warmup=0)
        p_ms = cuda_ms(plain, reps=2, warmup=1)
        b_ms, b_by, ops = bound_ms(batch.model_kind, batch.n_tasks, batch.n_tasks * CALIB_PATHS,
                                   batch.n_steps, batch.n_tasks * (CALIB_PATHS // BLOCK_PATHS))
        w, idle = waves(ctas, per_sm, sms)
        per_group.append(dict(group=f"{key[0]}/{key[1]}", tasks=batch.n_tasks,
                              paths=CALIB_PATHS, ms=k_ms, ms_repeat=k_ms_again,
                              plain_ms=p_ms, bound_ms=b_ms,
                              bound_by=b_by, ops=ops, ctas=ctas, ctas_per_sm=per_sm,
                              waves=w, last_wave_idle=idle))
        log(f"timing {key}: T={batch.n_tasks} paths={CALIB_PATHS}: kernel {k_ms:.4f} ms "
            f"(again {k_ms_again:.4f}), plain {p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{ops:.4e} ops), bound share {b_ms / k_ms:.3f}; {ctas} CTAs, {per_sm} per SM "
            f"on {sms} SMs: {w:.3f} waves, last wave {idle:.1%} idle")
    execute = []
    for tasks_k, ns in milp_launches:
        batch = TaskBatch.from_tasks(tasks_k, dev)
        n_max = -(-int(ns.max()) // BLOCK_PATHS) * BLOCK_PATHS
        per_sm = mc_paths.ctas_per_sm("mc_moments_batch", batch.model_kind)
        k_ms = cuda_ms(lambda: mc_paths.mc_moments_batch_kernel_call(
            batch, ns, CALIB_SEED, n_max, BLOCK_PATHS), reps=5, warmup=1)
        ctas = mc_paths.last_launch_ctas()
        b_ms, b_by, ops = bound_ms(batch.model_kind, batch.n_tasks, int(ns.sum()), batch.n_steps,
                                   batch.n_tasks * (n_max // BLOCK_PATHS))
        w, idle = waves(ctas, per_sm, sms)
        execute.append(dict(model=batch.model_kind, tasks=batch.n_tasks, paths=int(ns.sum()),
                            max_paths=int(ns.max()), ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                            ctas=ctas, ctas_per_sm=per_sm, waves=w, last_wave_idle=idle))
        log(f"timing milp local execute launch {batch.model_kind}: T={batch.n_tasks}, paths "
            f"asked {int(ns.sum())} ({int(ns.min())}..{int(ns.max())} a task): kernel "
            f"{k_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), bound share {b_ms / k_ms:.3f}; "
            f"{ctas} CTAs, {w:.3f} waves, last wave {idle:.1%} idle")
    per_task = []
    for task in cat_tasks:
        def task_kernel():
            mc_paths.mc_moments_kernel_call(task, CALIB_PATHS, CALIB_SEED, BLOCK_PATHS, dev)

        def task_plain():
            mc_paths.mc_moments_kernel_ref(task, CALIB_PATHS, CALIB_SEED, BLOCK_PATHS, dev)

        model_kind = "heston" if task.category.startswith("H-") else "black-scholes"
        k_ms = cuda_ms(task_kernel, reps=20, warmup=2)
        ctas = mc_paths.last_launch_ctas("mc_moments_task")
        per_sm = mc_paths.ctas_per_sm("mc_moments_task", model_kind, int(task.option.payoff))
        p_ms = cuda_ms(task_plain, reps=2, warmup=1)
        b_ms, b_by, ops_n = bound_ms(model_kind, 1, CALIB_PATHS, task.n_steps,
                                     CALIB_PATHS // BLOCK_PATHS, TASK_OPS_PER_PATH, TASK_BYTES_IN)
        w, idle = waves(ctas, per_sm, sms)
        per_task.append(dict(category=task.category, paths=CALIB_PATHS, ms=k_ms,
                             plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, ops=ops_n,
                             ctas=ctas, ctas_per_sm=per_sm, waves=w))
        log(f"timing task kernel {task.category}: paths={CALIB_PATHS}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{ops_n:.4e} ops), bound share {b_ms / k_ms:.3f}; {ctas} CTAs on {sms} SMs "
            f"({per_sm} fit on an SM): {w:.3f} waves")
    return per_group, execute, per_task


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ml_allocation, platform_latencies
    from repro_torch.kernels import mc_paths, ops
    from repro_torch.pricing import mc
    from repro_torch.pricing import (
        PricingSolver,
        SimulatedPlatform,
        TaskBatch,
        build_cluster,
        group_by_launch,
        launch_key,
        price_batch,
        table1_workload,
    )
    from repro_torch.runtime import (
        OnlineConfig,
        OnlineScheduler,
        Scenario,
        Scheduler,
        make_domain,
    )

    # -- phase 1: the card and the build -----------------------------------
    card = nvidia_smi("name,power.limit")
    device_name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{device_name}; count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    ptxas = mc_paths.build()
    log(f"built mc_paths.cu in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    dev = torch.device("cuda")
    tasks = table1_workload()
    check(len(tasks) == 128 and {t.n_steps for t in tasks} == {256},
          "Table 1 workload is not 128 tasks of 256 steps")
    groups = []
    group_tasks = []
    for key, group in group_by_launch(tasks):
        group_tasks.append([t for _, t in group])
        groups.append((key, TaskBatch.from_tasks(group_tasks[-1], dev)))

    # -- phase 2: kernel against plain version on the card -----------------
    t0 = time.perf_counter()
    max_abs = max_rel = 0.0
    rng = np.random.default_rng(12)
    cases = []
    for key, batch in groups:
        full = np.full(batch.n_tasks, CALIB_PATHS, np.uint32)
        cases.append((key, batch, full, BLOCK_PATHS))
    ragged_key, ragged_batch = groups[-1]
    ragged = rng.integers(64, 20_000, size=ragged_batch.n_tasks).astype(np.uint32)
    for block in (BLOCK_PATHS, 128, 2048):
        cases.append((ragged_key + ("ragged", block), ragged_batch, ragged, block))
    zero = ragged.copy()
    zero[::3] = 0  # every third task asks for no path
    cases.append((ragged_key + ("zero counts",), ragged_batch, zero, BLOCK_PATHS))
    # one long task among short ones and a zero: six tasks of the BS group
    tail_batch = TaskBatch.from_tasks(group_tasks[0][:6], dev)
    tail = np.array([4096, 0, LONG_TAIL_PATHS, 1, 2500, 1024], np.uint32)
    cases.append((groups[0][0] + ("long tail",), tail_batch, tail, BLOCK_PATHS))
    for key, batch, n_active, block in cases:
        err_abs, err_rel = check_batch_case(mc_paths, key, batch, n_active, block, dev)
        max_abs = max(max_abs, err_abs)
        max_rel = max(max_rel, err_rel)
    # the single-task kernel: one task of each (model, payoff) category at
    # the calibration shape, plus two other path-block sizes
    task_max_abs = task_max_rel = 0.0
    cat_tasks = table1_workload(categories=[(c, 1) for c in TASK_CATEGORIES])
    task_cases = [(t, BLOCK_PATHS) for t in cat_tasks]
    task_cases += [(cat_tasks[TASK_CATEGORIES.index("H-A")], 128),
                   (cat_tasks[TASK_CATEGORIES.index("BS-DB")], 2048)]
    for task, block in task_cases:
        got = mc_paths.mc_moments_kernel_call(task, CALIB_PATHS, CALIB_SEED, block, dev)
        again = mc_paths.mc_moments_kernel_call(task, CALIB_PATHS, CALIB_SEED, block, dev)
        want = mc_paths.mc_moments_kernel_ref(task, CALIB_PATHS, CALIB_SEED, block, dev)
        batch_sums = ops.mc_moments(task, CALIB_PATHS, CALIB_SEED, block, dev)
        torch.cuda.synchronize()
        name = f"task kernel {task.category} block {block}"
        check(torch.equal(got, again), f"{name}: two kernel runs differ")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite partials")
        check(tuple(got.shape) == (CALIB_PATHS // block, 2), f"{name}: shape {tuple(got.shape)}")
        err_abs, err_rel = partial_errors(got, want)
        summed = got.sum(0)
        batch_rel = max(abs(float(summed[k]) - float(batch_sums[k]))
                        / max(abs(float(batch_sums[k])), torch.finfo(torch.float32).tiny)
                        for k in range(2))
        task_max_abs = max(task_max_abs, err_abs)
        task_max_rel = max(task_max_rel, err_rel)
        log(f"{name}: partials {tuple(got.shape)} max abs {err_abs:.3e} "
            f"max rel {err_rel:.3e}; summed vs batch kernel rel "
            f"{batch_rel:.3e}; bitwise repeat ok")
        check(err_rel <= RTOL, f"{name}: partials differ beyond rtol {RTOL}")
        check(batch_rel <= RTOL, f"{name}: moments differ from the batch kernel beyond rtol {RTOL}")
    # the card against the CPU on a small input with continuous payoffs
    # (European, Asian: an ulp cannot flip a barrier indicator there)
    small = table1_workload(seed=7, n_steps=16,
                            categories=[("BS-A", 2), ("H-A", 2), ("H-E", 2)])
    on_card = price_batch(small, 4096, seed=5)
    on_cpu = price_batch(small, 4096, seed=5, device="cpu")
    for a, b in zip(on_card, on_cpu):
        check(math.isclose(float(a.price), float(b.price), rel_tol=RTOL),
              f"card {a} vs cpu {b}")
    log(f"card vs cpu on {len(small)} small tasks: prices within rtol {RTOL}")
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path --------------------------------------------
    t0 = time.perf_counter()
    cluster = build_cluster()
    check(len(cluster) == 17, "cluster is not 16 simulated + 1 local platform")
    local = cluster[-1]
    log(f"local platform: {local.spec.name} / {local.spec.device}")
    solver = PricingSolver(tasks, cluster)
    mc_paths.reset_launch_count()
    solver.characterise()
    launches_char = mc_paths.launch_count()
    main_launches = {k: mc_paths.launch_count(k) for k in mc_paths.KERNELS}
    log(f"characterise: {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{launches_char}")
    check(launches_char > 0, "characterise launched no kernel")
    check(bool(np.isfinite(solver._delta).all() and np.isfinite(solver._gamma).all()),
          "non-finite fitted models")
    local_rows = solver._delta[-1]
    log(f"fitted delta on {local.spec.name}: min {local_rows.min():.3e} "
        f"max {local_rows.max():.3e} s*$^2")
    for key, group in group_by_launch(tasks):
        # ladder records carry the launch latency split evenly over the
        # group's tasks (uniform path counts): scale back to the launch
        recs = solver.scheduler.characterise_records[(local.spec.name, group[0][1].task_id)]
        log(f"local ladder {key}: (paths per task, launch s): "
            f"{[(r.n_paths, round(r.latency * len(group), 6)) for r in recs]}")
    for j in np.flatnonzero(local_rows == 0.0):
        # a rung whose paths all paid the same gives a CI of exactly 0, and
        # the relative-error weighted accuracy fit then drives alpha to 0
        recs = solver.scheduler.characterise_records[(local.spec.name, tasks[j].task_id)]
        log(f"  delta 0: task {tasks[j].task_id} ({tasks[j].category}), rungs "
            f"(paths, CI): {[(r.n_paths, round(r.ci95, 6)) for r in recs]}")
    calib = cluster[0].moments
    task_by_id = {t.task_id: t for t in tasks}
    mc_paths.reset_launch_count()
    reports = {}
    allocs = {}
    milp_launches = []  # (tasks, path counts) of each local execute launch
    for method, kw in (("milp", dict(time_limit=60)), ("heuristic", {}), ("ml", {})):
        t1 = time.perf_counter()
        alloc = solver.allocate(ACCURACY, method=method, **kw)
        solve_s = time.perf_counter() - t1
        allocs[method] = alloc
        check(bool(np.allclose(alloc.A.sum(axis=0), 1.0)), f"{method}: shares do not sum to 1")
        units0 = mc_paths.units_launched()
        rep = solver.execute(alloc, ACCURACY)
        simulated = (mc_paths.units_launched() - units0) * mc_paths.BLOCK_QUANTUM
        reports[method] = rep
        worst = max(rep.measured_ci.values())
        local_share = float(alloc.A[-1].sum() / alloc.A.shape[1])
        log(f"{method}: solve {solve_s:.2f} s; predicted makespan "
            f"{rep.predicted_makespan:.6f} s; measured {rep.measured_makespan:.6f} s "
            f"(error {rep.makespan_error:.2%}); local share {local_share:.3f}; "
            f"local latency {rep.platform_latencies[local.spec.name]:.6f} s; "
            f"worst CI {worst:.5f} vs {ACCURACY}")
        # what the card simulated, from the units the batch kernel's launches
        # ran during this execute, against the paths the plan asked of it
        requested = RUNS_PER_DISPATCH * sum(
            r.n_paths for r in rep.records if r.platform == local.spec.name)
        ratio = simulated / max(requested, 1)
        log(f"{method}: local paths asked {requested} ({RUNS_PER_DISPATCH} runs of each "
            f"shard list), simulated by the launched units {simulated} ({ratio:.6f}x)")
        if requested == 0:
            check(simulated == 0, f"{method}: the card simulated {simulated} paths unasked")
        else:
            check(1.0 <= ratio <= MAX_SIMULATED_OVER_ASKED,
                  f"{method}: the card simulated {ratio:.4f}x the paths asked for")
        if method == "milp":
            # the local launches of this plan, one per ragged bucket of shards,
            # for phase 5
            for plat, launch_groups in solver.scheduler.shards(alloc, solver.problem(ACCURACY)):
                if plat is not local:
                    continue
                for group in launch_groups:
                    ns = [units for _, units in group]
                    for bucket in mc._ragged_buckets(ns):
                        milp_launches.append(([group[k][0] for k in bucket],
                                              np.array([ns[k] for k in bucket], np.int64)))
        by_group: dict = {}
        for r in rep.records:
            if r.platform == local.spec.name:
                key = launch_key(task_by_id[r.task_id])
                model = solver.models[(local.spec.name, r.task_id)].latency
                got = by_group.setdefault(key, [0.0, 0.0, 0])
                got[0] += r.latency
                got[1] += float(model(r.n_paths))
                got[2] += 1
        for key, (measured, modelled, n_tasks) in by_group.items():
            log(f"{method}: local {key}: {n_tasks} tasks, measured {measured:.6f} s, "
                f"latency model {modelled:.6f} s")
        check(math.isfinite(rep.predicted_makespan) and rep.predicted_makespan > 0,
              f"{method}: bad predicted makespan")
        check(math.isfinite(rep.measured_makespan) and rep.measured_makespan > 0,
              f"{method}: bad measured makespan")
        check(len(rep.prices) == 128 and all(math.isfinite(p) for p in rep.prices.values()),
              f"{method}: missing or non-finite prices")
        # the accuracy model is a fit: the achieved CI should land near the
        # target, well inside 20% of it
        check(worst <= ACCURACY * 1.2, f"{method}: worst CI {worst} misses {ACCURACY}")
        for t in tasks:
            p_cal, alpha = calib(t)
            se = math.hypot(rep.measured_ci[t.task_id],
                            alpha / math.sqrt(calib.calib_paths)) / (2 * 1.96)
            check(abs(rep.prices[t.task_id] - p_cal) <= 5 * se + 1e-6,
                  f"{method}: task {t.task_id} price {rep.prices[t.task_id]} vs "
                  f"calibration {p_cal} beyond 5 standard errors")
    launches_exec = mc_paths.launch_count()
    for k in mc_paths.KERNELS:
        main_launches[k] += mc_paths.launch_count(k)
    log(f"execute (three methods): kernel launches {launches_exec}")
    check(launches_exec > 0, "execute launched no kernel")
    log(f"improvement of milp over heuristic (measured makespan): "
        f"{reports['heuristic'].measured_makespan / reports['milp'].measured_makespan:.3f}x")
    ml = allocs["ml"]
    check(ml.makespan <= allocs["heuristic"].makespan * (1 + 1e-6),
          f"ml predicted makespan {ml.makespan} above the heuristic's "
          f"{allocs['heuristic'].makespan}")
    t1 = time.perf_counter()
    ml_cpu = ml_allocation(solver.problem(ACCURACY), device="cpu")
    ml_cpu_s = time.perf_counter() - t1
    log(f"ml: anneal {ml.meta['solve_s']:.2f} s of {ml.solve_time:.2f} s solve "
        f"(share {ml.meta['solve_s'] / ml.solve_time:.3f}) on the card; the same "
        f"problem with device='cpu': anneal {ml_cpu.meta['solve_s']:.2f} s of "
        f"{ml_cpu_s:.2f} s, predicted makespan {ml_cpu.makespan:.6f} s")
    log(f"ml/milp predicted makespan {ml.makespan / allocs['milp'].makespan:.4f}; "
        f"measured {reports['ml'].measured_makespan / reports['milp'].measured_makespan:.4f}")
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    # -- phase 4: the online loop at full width ------------------------------
    # For each solver, the busiest simulated platform of its phase 3 plan
    # slows down 4x at half the planned makespan; a static plan and the
    # online loop run under that scenario on fresh schedulers. "ml" is the
    # issue's solver here; it leaves the local card idle on this fleet (its
    # annealer, like the reference's, rarely moves a task onto the one
    # platform that is ~170x faster), so the loop's path through the kernel
    # is shown by the MILP run, whose plan puts ~92% of the work on the card.
    t0 = time.perf_counter()
    local_name = local.spec.name
    sim = [i for i, p in enumerate(cluster) if isinstance(p, SimulatedPlatform)]

    def fresh_scheduler(scenario):
        sched = Scheduler(make_domain("pricing", tasks, build_cluster()), trace=True)
        sched.characterise()
        for p in sched.domain.platforms:
            if isinstance(p, SimulatedPlatform):
                p.attach_scenario(scenario)
        return sched

    def online_run(method: str, kw: dict) -> int:
        plan = allocs[method]
        lat = platform_latencies(plan.A, solver.problem(ACCURACY))
        hot = max(sim, key=lambda i: lat[i])
        slow_name, t_half = cluster[hot].spec.name, plan.makespan / 2
        log(f"online {method}: {slow_name} (planned latency {lat[hot]:.6f} s) "
            f"slows {SLOWDOWN}x at t={t_half:.6f} s")
        s_static = fresh_scheduler(Scenario().slowdown(slow_name, t_half, SLOWDOWN))
        static = s_static.execute(s_static.allocate(ACCURACY, method=method, **kw),
                                  ACCURACY, seed=3)
        s_online = fresh_scheduler(Scenario().slowdown(slow_name, t_half, SLOWDOWN))
        mc_paths.reset_launch_count()
        adaptive = OnlineScheduler(s_online, OnlineConfig(rounds=ONLINE_ROUNDS)).run(
            ACCURACY, method=method, seed=3, **kw)
        launches = mc_paths.launch_count()
        for k in mc_paths.KERNELS:
            main_launches[k] += mc_paths.launch_count(k)
        per_round: dict = {}
        for e in s_online.ledger.entries("latency"):
            if e.platform == local_name:
                got = per_round.setdefault(e.round, [0.0, 0.0])
                got[0] += e.predicted
                got[1] += e.measured
        for r in adaptive.rounds:
            pred, meas = per_round.get(r.round, (0.0, 0.0))
            ratio = f"{pred / meas:.4f}" if meas > 0 else "n/a"
            log(f"online {method} round {r.round}: drifted {list(r.drifted)}, solve "
                f"{r.solve_outcome}, local paths {r.dispatched_units.get(local_name, 0)}, "
                f"local predicted/measured latency {ratio}")
        worst = max(adaptive.summary["measured_ci"].values())
        log(f"online {method}: static measured makespan {static.measured_makespan:.6f} s, "
            f"adaptive {adaptive.measured_makespan:.6f} s (static/adaptive "
            f"{static.measured_makespan / adaptive.measured_makespan:.4f}); drift rounds "
            f"{[r.round for r in adaptive.rounds if r.drifted]}; re-solves "
            f"{adaptive.n_resolves}, warm-start skips {adaptive.n_skipped}, refits "
            f"{adaptive.n_refits}; solver wall {adaptive.solve_wall_s:.2f} s; kernel "
            f"launches {launches}; worst CI {worst:.5f} vs {ACCURACY}")
        check(len(adaptive.summary["prices"]) == 128
              and all(math.isfinite(p) for p in adaptive.summary["prices"].values()),
              f"online {method}: missing or non-finite prices")
        check(worst <= ACCURACY * 1.2, f"online {method}: worst CI {worst} misses {ACCURACY}")
        check(math.isfinite(adaptive.measured_makespan) and adaptive.measured_makespan > 0,
              f"online {method}: bad measured makespan")
        return launches

    online_run("ml", {})
    check(online_run("milp", dict(time_limit=60)) > 0,
          "the online loop launched no kernel")
    log(f"phase 4 took {time.perf_counter() - t0:.1f} s")

    # -- phase 5: timing -----------------------------------------------------
    # first the MILP plan's own execute shapes against the plain version, as
    # in phase 2: every local launch whose plain version simulates at most
    # PLAIN_CHECK_PATHS paths, and the smallest launch of each model
    t0 = time.perf_counter()
    execute_launches = []
    for tasks_k, ns in milp_launches:
        batch = TaskBatch.from_tasks(tasks_k, dev)
        execute_launches.append((len(tasks_k) * -(-int(ns.max()) // BLOCK_PATHS) * BLOCK_PATHS,
                         batch, ns))
    check(bool(execute_launches), "the MILP plan gave the card no launch")
    execute_launches.sort(key=lambda x: x[0])
    models_seen = set()
    for plain_paths, batch, ns in execute_launches:
        if plain_paths > PLAIN_CHECK_PATHS and batch.model_kind in models_seen:
            continue
        models_seen.add(batch.model_kind)
        err_abs, err_rel = check_batch_case(
            mc_paths, (batch.model_kind, "milp execute", f"T={batch.n_tasks}", int(ns.sum())),
            batch, ns, BLOCK_PATHS, dev)
        max_abs = max(max_abs, err_abs)
        max_rel = max(max_rel, err_rel)
    log(f"milp execute launches against the plain version: {time.perf_counter() - t0:.1f} s")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the SM clock and power, sampled every 200 ms while the kernels run
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        per_group, execute, per_task = time_kernels(
            mc_paths, groups, milp_launches, cat_tasks, sms, dev)
    finally:
        clocks.terminate()
        samples = clocks.communicate(timeout=30)[0]
    mhz = [float(line.split(",")[0]) for line in samples.splitlines() if line.strip()]
    watts = [float(line.split(",")[1]) for line in samples.splitlines() if line.strip()]
    check(bool(mhz), "nvidia-smi gave no clock samples")
    log(f"SM clock during the timing: {len(mhz)} samples, min {min(mhz):.0f} MHz, "
        f"median {sorted(mhz)[len(mhz) // 2]:.0f} MHz, max {max(mhz):.0f} MHz; power "
        f"median {sorted(watts)[len(watts) // 2]:.1f} W, max {max(watts):.1f} W")
    log(f"card: {card}")
    kernels = [{
        "name": "mc_moments_batch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mc_paths.cu",
        "replaces": "src/repro/kernels/mc_paths.py:172",
        "launches": main_launches["mc_moments_batch"],
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        # one Table 1 calibration: the BS and the Heston launch
        "ms": sum(g["ms"] for g in per_group),
        "plain_ms": sum(g["plain_ms"] for g in per_group),
        "bound_ms": sum(g["bound_ms"] for g in per_group),
        "bound_by": "operations" if all(g["bound_by"] == "operations" for g in per_group) else "bytes",
        "library_ms": None,
        "per_group": per_group,
        # the MILP plan's local execute launches of phase 3
        "execute": execute,
    }, {
        "name": "mc_moments_task",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mc_paths.cu",
        "replaces": "src/repro/kernels/mc_paths.py:85",
        # as in the reference, only tests and this smoke reach the
        # single-task kernel: the main path launches it no time
        "launches": main_launches["mc_moments_task"],
        "max_abs_err": task_max_abs,
        "max_rel_err": task_max_rel,
        # one task of each of the 10 categories, 65,536 paths each
        "ms": sum(g["ms"] for g in per_task),
        "plain_ms": sum(g["plain_ms"] for g in per_task),
        "bound_ms": sum(g["bound_ms"] for g in per_task),
        "bound_by": "operations" if all(g["bound_by"] == "operations" for g in per_task) else "bytes",
        "library_ms": None,
        "per_category": per_task,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
