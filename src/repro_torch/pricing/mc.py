"""Monte Carlo pricing engine (paper §4.1.3's F3 execution layer, in PyTorch).

One engine: the family-batched moments kernel of ``repro_torch.kernels``,
the CUDA kernel on the card and its plain PyTorch version on the CPU. Both
draw the same Threefry stream per (task, path, step), so results agree
across devices and decompositions.

  * ``path_stats``            — per-path statistics of one task (plain torch)
  * ``price`` / ``price_batch`` — one launch per (model kind, n_steps) group

The engine returns the two domain metrics directly: the price estimate and
the 95% confidence interval (the *accuracy* metric, eq. 8).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# module imports: kernels.mc_paths imports this package's contracts, so it
# may still be initialising when this module is imported
from repro_torch.kernels import mc_paths, ops
from .contracts import PricingTask, TaskBatch, group_by_launch, resolve_device

__all__ = [
    "path_stats", "price", "price_batch", "PriceResult",
    "launch_count", "reset_launch_count",
]


def path_stats(task: PricingTask, n_paths: int, seed: int, path_offset: int = 0,
               device: str | torch.device = "cuda"):
    """Simulate ``n_paths`` paths; return (s_t, avg, mn, mx), each (n_paths,).

    Conventions (shared with the kernel): the running average is over the
    n_steps post-initial observations; min/max include the initial spot.
    The RNG counter is (path_index, step); the key is (seed, task_id), so
    the draw for a given (task, path, step) is decomposition-independent.
    """
    batch = TaskBatch.from_tasks([task], device)
    s_t, avg, mn, mx = mc_paths.batch_path_stats(batch, n_paths, seed,
                                                 path_offset)
    return s_t[0], avg[0], mn[0], mx[0]


def launch_count() -> int:
    """Launches of the CUDA moments kernel since the last reset."""
    return mc_paths.launch_count()


def reset_launch_count() -> None:
    mc_paths.reset_launch_count()


@dataclasses.dataclass(frozen=True)
class PriceResult:
    price: np.float32
    ci95: np.float32       # the paper's accuracy metric: size of the 95% CI
    std_error: np.float32
    n_paths: int

    def __repr__(self):
        return (f"PriceResult(price={float(self.price):.6f}, "
                f"ci95={float(self.ci95):.6f}, n={int(self.n_paths)})")


def _finalize(tasks: Sequence[PricingTask], pay_sum: torch.Tensor,
              pay_sq: torch.Tensor, ns: Sequence[int]) -> list[PriceResult]:
    """Price and CI (2 x 1.96 x stderr) per task, in float32 on the device.

    One copy to the host for the whole group.
    """
    dev = pay_sum.device

    def f32(values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float32, device=dev)

    n = f32([float(k) for k in ns])
    mean = pay_sum / n
    var = torch.clamp_min(pay_sq / n - mean * mean, 0.0)
    disc = f32([t.discount for t in tasks])
    stderr = disc * torch.sqrt(var / n)
    out = torch.stack([disc * mean, f32(2 * 1.96) * stderr, stderr]).cpu().numpy()
    return [PriceResult(price=out[0, k], ci95=out[1, k], std_error=out[2, k],
                        n_paths=int(ns[k])) for k in range(len(tasks))]


#: Max spread of per-task path counts co-batched into one padded launch.
#: Padding waste per task is bounded by this factor.
_RAGGED_RATIO = 4


def _ragged_buckets(ns: Sequence[int]) -> list[list[int]]:
    """Partition positions of ``ns`` into buckets with max/min <= ratio.

    Greedy over ascending counts; uniform inputs (the common case) always
    yield a single bucket. Returns lists of positions into ``ns``.
    """
    order = sorted(range(len(ns)), key=lambda k: ns[k])
    buckets: list[list[int]] = []
    bucket_min = None
    for k in order:
        n = max(int(ns[k]), 1)
        if bucket_min is None or n > bucket_min * _RAGGED_RATIO:
            buckets.append([])
            bucket_min = n
        buckets[-1].append(k)
    return buckets


def price_batch(tasks: Sequence[PricingTask], n_paths, seed: int = 0,
                block_paths: int | None = None,
                device: str | torch.device = "cuda") -> list[PriceResult]:
    """Price many tasks with one kernel launch per launch group.

    ``n_paths`` is an int (shared by all tasks) or a per-task sequence;
    ragged path counts within a group are padded to whole path blocks and
    masked, so every task's estimate uses exactly its own first ``n``
    counter-based draws.

    Tasks are grouped by :func:`launch_key` — (model kind, n_steps), the
    only structural task properties — so a full mixed Table 1 workload
    takes two launches. Within a group, wildly ragged path counts are split
    into magnitude buckets (max/min <= ``_RAGGED_RATIO``) before padding,
    so a 64-path shard never simulates a co-batched task's million paths.
    Every launch is issued before the first result is copied back.

    Returns one :class:`PriceResult` per task, in input order.
    """
    device = resolve_device(device)
    tasks = list(tasks)
    ns = np.broadcast_to(np.asarray(n_paths, dtype=np.int64), (len(tasks),))
    launched = []
    for _key, group in group_by_launch(tasks):
        for bucket in _ragged_buckets([int(ns[i]) for i, _ in group]):
            sub = [group[k] for k in bucket]
            batch = TaskBatch.from_tasks([t for _, t in sub], device)
            sums, sqs = ops.mc_moments_batch(batch, [ns[i] for i, _ in sub],
                                             seed, block_paths=block_paths)
            launched.append((sub, sums, sqs))
    results: list[PriceResult | None] = [None] * len(tasks)
    for sub, sums, sqs in launched:
        group_results = _finalize([t for _, t in sub], sums, sqs,
                                  [int(ns[i]) for i, _ in sub])
        for (i, _t), res in zip(sub, group_results):
            results[i] = res
    return results  # type: ignore[return-value]


def price(task: PricingTask, n_paths: int, seed: int = 0,
          block_paths: int | None = None,
          device: str | torch.device = "cuda") -> PriceResult:
    """Price one task — a thin wrapper over a batch of one.

    The CI convention follows the paper: accuracy = *size* of the 95%
    interval (2 x 1.96 x stderr), in pricing currency.
    """
    return price_batch([task], n_paths, seed=seed, block_paths=block_paths,
                       device=device)[0]
