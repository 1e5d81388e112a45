"""Public wrappers around the Monte Carlo moments kernel.

They pick the engine from the tensors' device: the CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors. There is no switch to
the plain version on a card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pricing.contracts import PricingTask, TaskBatch
# a module import: pricing.mc imports this module while mc_paths may still
# be initialising (mc_paths -> pricing.contracts -> pricing -> pricing.mc)
from . import mc_paths

__all__ = ["mc_moments", "mc_moments_batch"]


def mc_moments_batch(batch: TaskBatch, n_active, seed: int = 0,
                     block_paths: int | None = None):
    """Per-task (sum payoff, sum payoff^2) for a task family, one launch.

    ``n_active`` is a per-task path-count sequence; it is padded up to a
    whole number of path blocks (masked inside the kernel), and the
    (T, blocks, 2) partials are summed over blocks here. Returns two (T,)
    float32 tensors on the batch's device.
    """
    if block_paths is None:
        block_paths = mc_paths.DEFAULT_BLOCK_PATHS
    n_act = np.asarray(n_active, dtype=np.int64).reshape(-1)
    if n_act.shape != (batch.n_tasks,):
        raise ValueError(f"{n_act.size} path counts for {batch.n_tasks} tasks")
    if n_act.min() < 0 or n_act.max() >= 2 ** 32:
        raise ValueError("path counts must lie in [0, 2**32)")
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed={seed} must fit in uint32")
    n_pad = max(-(-int(n_act.max()) // block_paths), 1) * block_paths
    n_act_t = torch.from_numpy(n_act.astype(np.uint32)).to(batch.device)
    if batch.device.type == "cuda":
        partial = mc_paths.mc_moments_batch_kernel_call(
            batch, n_act_t, seed, n_pad, block_paths)
    elif batch.device.type == "cpu":
        partial = mc_paths.mc_moments_batch_ref(batch, n_act_t, seed, n_pad,
                                                block_paths)
    else:
        raise ValueError(f"no Monte Carlo engine for device {batch.device}")
    return partial[:, :, 0].sum(dim=1), partial[:, :, 1].sum(dim=1)


def mc_moments(task: PricingTask, n_paths: int, seed: int = 0,
               block_paths: int | None = None,
               device: str | torch.device = "cuda"):
    """(sum payoff, sum payoff^2) over ``n_paths`` paths of one task.

    A batch of one; with ``repro_torch.pricing.mc._finalize`` this yields
    price + 95% CI.
    """
    batch = TaskBatch.from_tasks([task], device)
    sums, sqs = mc_moments_batch(batch, [n_paths], seed, block_paths=block_paths)
    return sums[0], sqs[0]
