#!/usr/bin/env python3
"""Time the moments kernels of one checkout of the port on the card.

    python3 tools/time_kernels.py --src SRC_DIR

``SRC_DIR`` holds a ``repro_torch`` package (this checkout's ``src``, or
the ``src`` of an older commit unpacked with ``git archive``), so that two
versions can be timed in turns in one run on one card: parent, change,
change, parent. Shapes, all at 256 steps on the Table 1 workload:

- calibration: each launch group (BS, 35 tasks; Heston, 93 tasks) at
  65,536 paths a task;
- ragged: the same groups with path counts drawn log-uniform in
  [250,000, 1,000,000] (one ragged bucket of ``price_batch``, as the local
  platform's execute shards are);
- single task: one BS-E and one H-E task at 65,536 paths.

Prints one JSON line: the card, the source, and each shape's milliseconds
(``chip_smoke.cuda_ms``: CUDA events over repeated launches after a
warm-up and a GPU spin). The seed, path counts and block size are the
smoke's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import BLOCK_PATHS, CALIB_PATHS, CALIB_SEED, cuda_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, required=True)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import mc_paths
    from repro_torch.pricing import TaskBatch, group_by_launch, table1_workload

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    mc_paths.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    # a wrapper that lists active blocks takes host counts; the one before
    # it took the counts on the card
    host_counts = hasattr(mc_paths, "active_block_offsets")

    def batch_call(batch, counts: np.ndarray):
        n_max = -(-int(counts.max()) // BLOCK_PATHS) * BLOCK_PATHS
        n_act = counts if host_counts else torch.from_numpy(counts).to(dev)
        return lambda: mc_paths.mc_moments_batch_kernel_call(batch, n_act, CALIB_SEED, n_max,
                                                             BLOCK_PATHS)

    rng = np.random.default_rng(14)
    result = {}
    for key, group in group_by_launch(table1_workload()):
        batch = TaskBatch.from_tasks([t for _, t in group], dev)
        full = np.full(batch.n_tasks, CALIB_PATHS, np.uint32)
        ragged = np.exp(rng.uniform(np.log(250_000), np.log(1_000_000),
                                    batch.n_tasks)).astype(np.uint32)
        result[f"calibration {key[0]} T={batch.n_tasks}"] = cuda_ms(batch_call(batch, full), 20)
        result[f"ragged {key[0]} T={batch.n_tasks} paths={int(ragged.sum())}"] = cuda_ms(
            batch_call(batch, ragged), 3)
    for task in table1_workload(categories=[("BS-E", 1), ("H-E", 1)]):
        result[f"single task {task.category}"] = cuda_ms(
            lambda: mc_paths.mc_moments_kernel_call(task, CALIB_PATHS, CALIB_SEED, BLOCK_PATHS, dev),
            20)
    print(json.dumps({"card": card, "src": str(args.src), "build_s": build_s, "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
