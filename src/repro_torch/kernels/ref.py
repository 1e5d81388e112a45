"""Plain PyTorch oracle for the Monte Carlo moments of one task.

Built on ``repro_torch.pricing.mc.path_stats`` and the non-coded
``payoff_from_stats``: the same Threefry stream per (task, path, step) as
the kernels, so kernels and oracle agree up to float32 summation order.
The blocked oracle is the single-task kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.pricing.contracts import PricingTask, payoff_from_stats
from repro_torch.pricing.mc import path_stats
from .mc_paths import mc_moments_kernel_ref

__all__ = ["mc_moments_ref", "mc_block_moments_ref"]


def mc_moments_ref(task: PricingTask, n_paths: int, seed: int = 0,
                   device: str | torch.device = "cuda"):
    """(sum payoff, sum payoff^2) — single flat reduction."""
    s_t, avg, mn, mx = path_stats(task, n_paths, seed, device=device)
    pay = payoff_from_stats(s_t, avg, mn, mx, task.option)
    return pay.sum(), (pay * pay).sum()


def mc_block_moments_ref(task: PricingTask, n_paths: int, seed: int,
                         block_paths: int, device: str | torch.device = "cuda"):
    """Per-block (sum, sumsq) with the kernel's blocking: (blocks, 2)."""
    return mc_moments_kernel_ref(task, n_paths, seed, block_paths, device)
