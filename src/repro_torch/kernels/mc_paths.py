"""The Monte Carlo moments kernels: CUDA wrappers + plain versions.

``mc_moments_batch_kernel_call`` launches the family-batched CUDA C++ kernel
of ``csrc/mc_paths.cu`` (the port of the reference's Pallas
``_mc_batch_kernel``) on CUDA tensors; ``mc_moments_batch_ref`` is its plain
PyTorch version, which runs on any device and returns the same
(T, blocks, 2) partial (sum payoff, sum payoff^2) per (task, path block).
The CPU path and the on-card comparison use the plain version; on a CUDA
tensor the main path always launches the kernel or raises.

``mc_moments_kernel_call`` launches the single-task kernel of the same
source (the port of the reference's Pallas ``_mc_kernel``, whose task is
baked in at trace time: here model and payoff kind are template
parameters) and returns the (blocks, 2) partials of one task;
``mc_moments_kernel_ref`` is its plain version. As in the reference, only
tests and the card's smoke run reach it.

The kernels are built with ``nvcc`` from the source at first use into
``kernels/build/`` (a shared library with a plain C interface, loaded with
``ctypes``), once per process under a lock: platforms launch from several
threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.pricing.contracts import (
    COL,
    N_PARAMS,
    PricingTask,
    TaskBatch,
    bs_step_fn,
    heston_step_fn,
    payoff_from_stats,
    payoff_from_stats_coded,
)
from .prng import normal_pair

__all__ = [
    "mc_moments_batch_kernel_call", "mc_moments_batch_ref",
    "mc_moments_kernel_call", "mc_moments_kernel_ref", "batch_path_stats",
    "validate_blocking", "build", "launch_count", "reset_launch_count",
    "KERNELS", "BLOCK_QUANTUM", "DEFAULT_BLOCK_PATHS",
]

#: The kernels of ``csrc/mc_paths.cu``, by the name their launches count under.
KERNELS = ("mc_moments_batch", "mc_moments_task")

#: ``block_paths`` must be a whole number of 128-thread CUDA blocks.
BLOCK_QUANTUM = 128

#: Threads of a single-task kernel block: one path each up to 1024 paths.
MAX_TASK_THREADS = 1024

#: The one path-block default shared by every engine entry point. A
#: 1024-path block gives each of 256 threads four paths; 65,536 calibration
#: paths of a 93-task family make 5,952 blocks, enough to fill 132 SMs.
DEFAULT_BLOCK_PATHS = 1024

_SOURCE = Path(__file__).resolve().parent / "csrc" / "mc_paths.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MODEL_CODES = {"black-scholes": 0, "heston": 1}


def validate_blocking(n_paths: int, block_paths: int) -> int:
    """The single divisibility check for path tiling; returns #blocks."""
    if block_paths <= 0 or block_paths % BLOCK_QUANTUM:
        raise ValueError(
            f"block_paths={block_paths} must be a positive multiple of "
            f"{BLOCK_QUANTUM}")
    if n_paths % block_paths:
        raise ValueError(
            f"n_paths={n_paths} must be a multiple of block_paths={block_paths}")
    return n_paths // block_paths


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def batch_path_stats(batch: TaskBatch, n_paths: int, seed: int,
                     path_offset: int = 0):
    """Simulate paths ``path_offset .. path_offset + n_paths`` of every task.

    Returns (s_t, avg, mn, mx), each (T, n_paths) float32. The running
    average is over the n_steps post-initial observations; min/max include
    the initial spot. The RNG key is (seed, task_id) and the counter
    (path id, step), so a task's draws do not depend on the batch.
    """
    p = batch.params
    T = batch.n_tasks

    def col(name: str) -> torch.Tensor:
        return p[:, COL[name], None]  # (T, 1): broadcasts over paths

    pid = path_offset + torch.arange(n_paths, dtype=torch.int64,
                                     device=p.device)[None, :]
    k1 = batch.task_ids.to(torch.int64)[:, None]
    spot = col("spot").expand(T, n_paths)
    if batch.model_kind == "black-scholes":
        step_fn = bs_step_fn(col("rate"), col("vol"), col("dt"))
        carry = spot
    else:
        step_fn = heston_step_fn(col("rate"), col("kappa"), col("theta"),
                                 col("xi"), col("rho"), col("dt"))
        carry = (spot, col("v0").expand(T, n_paths))
    acc = torch.zeros_like(spot)
    mn = mx = spot
    for step in range(batch.n_steps):
        carry = step_fn(carry, normal_pair(seed, k1, pid, step))
        s = carry[0] if isinstance(carry, tuple) else carry
        acc = acc + s
        mn = torch.minimum(mn, s)
        mx = torch.maximum(mx, s)
    s_t = carry[0] if isinstance(carry, tuple) else carry
    # a divisor on the device: CUDA divides by a CPU scalar as a multiply
    # by its reciprocal, which is not the kernel's float32 division
    n_steps = torch.tensor(float(batch.n_steps), dtype=torch.float32,
                           device=p.device)
    return s_t, acc / n_steps, mn, mx


def mc_moments_batch_ref(batch: TaskBatch, n_active: torch.Tensor, seed: int,
                         n_paths_max: int,
                         block_paths: int = DEFAULT_BLOCK_PATHS) -> torch.Tensor:
    """Plain version of the kernel: (T, blocks, 2) partial (sum, sumsq).

    Paths with id >= ``n_active[t]`` are simulated but masked to 0, as in
    the kernel.
    """
    blocks = validate_blocking(n_paths_max, block_paths)
    p = batch.params
    s_t, avg, mn, mx = batch_path_stats(batch, n_paths_max, seed)
    pay = payoff_from_stats_coded(
        s_t, avg, mn, mx,
        strike=p[:, COL["strike"], None], lower=p[:, COL["lower"], None],
        upper=p[:, COL["upper"], None], payout=p[:, COL["payout"], None],
        call_sign=p[:, COL["call_sign"], None],
        kind=batch.payoff_kinds[:, None])
    pid = torch.arange(n_paths_max, dtype=torch.int64, device=p.device)
    live = pid[None, :] < n_active.to(torch.int64)[:, None]
    pay = torch.where(live, pay, torch.zeros((), dtype=pay.dtype, device=pay.device))
    pay = pay.reshape(batch.n_tasks, blocks, block_paths)
    return torch.stack([pay.sum(dim=2), (pay * pay).sum(dim=2)], dim=2)


def mc_moments_kernel_ref(task: PricingTask, n_paths: int, seed: int,
                          block_paths: int = DEFAULT_BLOCK_PATHS,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """Plain version of the single-task kernel: (blocks, 2) partial
    (sum, sumsq) of paths ``0 .. n_paths`` of ``task``, with the non-coded
    payoff. Runs on ``device``."""
    blocks = validate_blocking(n_paths, block_paths)
    batch = TaskBatch.from_tasks([task], device)
    s_t, avg, mn, mx = (x[0] for x in batch_path_stats(batch, n_paths, seed))
    pay = payoff_from_stats(s_t, avg, mn, mx, task.option)
    pay = pay.reshape(blocks, block_paths)
    return torch.stack([pay.sum(dim=1), (pay * pay).sum(dim=1)], dim=1)


# --------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# --------------------------------------------------------------------------

class _KernelLibrary:
    """Builds ``libmc_paths`` from the source once and loads it with ctypes.

    The library's name carries a hash of the source and the flags, so an
    edited source never loads a stale build. The build writes to a
    temporary name and renames it, so concurrent processes sharing the
    build directory never load a half-written file.
    """

    def __init__(self, source: Path, build_dir: Path):
        self.source = source
        self.build_dir = build_dir
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.ptxas_log = ""

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
        return self.build_dir / f"libmc_paths_{digest}.so"

    def _nvcc(self) -> str:
        found = shutil.which("nvcc")
        if found:
            return found
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")

    def _build(self, out: Path) -> None:
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [self._nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        self.ptxas_log = proc.stderr
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                out = self.path()
                if not out.exists():
                    self._build(out)
                elif not self.ptxas_log and out.with_suffix(".ptxas.txt").exists():
                    self.ptxas_log = out.with_suffix(".ptxas.txt").read_text()
                lib = ctypes.CDLL(str(out))
                ptr = ctypes.c_void_p
                lib.mc_moments_batch_launch.argtypes = [
                    ptr, ptr, ptr, ptr, ctypes.c_uint32, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ptr, ptr]
                lib.mc_moments_batch_launch.restype = ctypes.c_int
                lib.mc_moments_task_launch.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
                    ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ptr]
                lib.mc_moments_task_launch.restype = ctypes.c_int
                lib.mc_error_string.argtypes = [ctypes.c_int]
                lib.mc_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


_LIBRARY = _KernelLibrary(_SOURCE, _BUILD_DIR)
_COUNT_LOCK = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


def build() -> str:
    """Build (if needed) and load the kernel library; returns ptxas's report."""
    _LIBRARY.get()
    return _LIBRARY.ptxas_log


def launch_count(kernel: str = "mc_moments_batch") -> int:
    """Launches of ``kernel`` (one of :data:`KERNELS`) since the last
    :func:`reset_launch_count`."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Set the launch count of every kernel to 0."""
    with _COUNT_LOCK:
        for name in KERNELS:
            _launches[name] = 0


def _count_launch(kernel: str) -> None:
    with _COUNT_LOCK:
        _launches[kernel] += 1


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mc_moments_batch_kernel_call(batch: TaskBatch, n_active: torch.Tensor,
                                 seed: int, n_paths_max: int,
                                 block_paths: int = DEFAULT_BLOCK_PATHS
                                 ) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.

    ``n_active`` is a (T,) uint32 tensor of per-task path counts on the
    batch's device; ``n_paths_max`` (a multiple of ``block_paths``) sets
    the padded grid. Returns the (T, blocks, 2) float32 partials. Raises
    unless every tensor is on a CUDA device.
    """
    device = batch.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}; "
                         "use mc_moments_batch_ref on the CPU")
    blocks = validate_blocking(n_paths_max, block_paths)
    T = batch.n_tasks
    if not 1 <= T <= 65535:
        raise ValueError(f"{T} tasks in one launch; the grid allows 1..65535")
    if n_paths_max >= 2 ** 32:
        raise ValueError(f"n_paths_max={n_paths_max} overflows uint32 path ids")
    if batch.model_kind not in _MODEL_CODES:
        raise ValueError(f"unknown model kind {batch.model_kind!r}")
    _check(batch.params, "params", torch.float32, (T, N_PARAMS), device)
    _check(batch.task_ids, "task_ids", torch.uint32, (T,), device)
    _check(batch.payoff_kinds, "payoff_kinds", torch.int32, (T,), device)
    _check(n_active, "n_active", torch.uint32, (T,), device)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed={seed} must fit in uint32")
    lib = _LIBRARY.get()
    out = torch.empty((T, blocks, 2), dtype=torch.float32, device=device)
    threads = 256 if block_paths % 256 == 0 else BLOCK_QUANTUM
    with torch.cuda.device(device):
        rc = lib.mc_moments_batch_launch(
            batch.params.data_ptr(), batch.task_ids.data_ptr(),
            batch.payoff_kinds.data_ptr(), n_active.data_ptr(), int(seed),
            _MODEL_CODES[batch.model_kind], T, batch.n_steps, blocks,
            block_paths, threads, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(lib, rc, "mc_moments_batch")
    _count_launch("mc_moments_batch")
    return out


def _raise_on_error(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({lib.mc_error_string(rc).decode()})")


def mc_moments_kernel_call(task: PricingTask, n_paths: int, seed: int,
                           block_paths: int = DEFAULT_BLOCK_PATHS,
                           device: str | torch.device = "cuda"
                           ) -> torch.Tensor:
    """Launch the single-task CUDA kernel on PyTorch's current stream.

    Simulates paths ``0 .. n_paths`` of ``task`` (``n_paths`` a multiple of
    ``block_paths``) and returns the (blocks, 2) float32 partials
    (sum payoff, sum payoff^2) on ``device``. Raises unless ``device`` is
    a CUDA device.
    """
    blocks = validate_blocking(n_paths, block_paths)
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {device}; "
                         "use mc_moments_kernel_ref on the CPU")
    if n_paths >= 2 ** 32:
        raise ValueError(f"n_paths={n_paths} overflows uint32 path ids")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed={seed} must fit in uint32")
    if not 0 <= task.task_id < 2 ** 32:
        raise ValueError(f"task_id={task.task_id} must fit in uint32")
    if task.n_steps < 1:
        raise ValueError(f"n_steps={task.n_steps} must be positive")
    # the same float32 scalars as the task's row of a TaskBatch
    row = TaskBatch.from_tasks([task], "cpu")
    scalars = (ctypes.c_float * N_PARAMS)(*row.params[0].tolist())
    lib = _LIBRARY.get()
    out = torch.empty((blocks, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.mc_moments_task_launch(
            scalars, int(seed), int(task.task_id),
            _MODEL_CODES[row.model_kind], int(task.option.payoff),
            task.n_steps, blocks, block_paths,
            min(block_paths, MAX_TASK_THREADS), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(lib, rc, "mc_moments_task")
    _count_launch("mc_moments_task")
    return out
