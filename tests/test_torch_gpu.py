"""The CUDA moments kernels against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA card (decided inside the
``cuda`` fixture, so every xdist worker collects the same tests). Imports
only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mc_paths, ops
from repro_torch.pricing import (
    Heston,
    LocalTorchPlatform,
    PricingTask,
    TaskBatch,
    asian,
    price_batch,
    workload,
)

# bit-equal Threefry draws through the same CUDA math library on both
# sides: only the float32 summation order of the block sums differs, and
# rtol 3e-5 is the reference's kernel-vs-oracle bar
RTOL = 3e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("model", ["BS-DB", "H-B"])
def test_kernel_matches_plain_version(cuda, model):
    asian_of_model = model.split("-")[0] + "-A"
    tasks = workload.table1_workload(seed=4, n_steps=64,
                                     categories=[(model, 4), (asian_of_model, 3)])
    batch = TaskBatch.from_tasks(tasks, cuda)
    n_active = np.array([8192, 5000, 100, 8192, 1, 7000, 4097], np.uint32)
    before = mc_paths.launch_count()
    got = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 77, 8192, 1024)
    again = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 77, 8192, 1024)
    want = mc_paths.mc_moments_batch_ref(
        batch, torch.from_numpy(n_active).to(cuda), 77, 8192, 1024)
    torch.cuda.synchronize()
    assert mc_paths.launch_count() == before + 2
    assert torch.equal(got, again)  # fixed-order reduction: bitwise repeatable
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL)


@pytest.mark.parametrize("block_paths", [128, 256, 2048])
def test_kernel_block_sweep(cuda, block_paths):
    task = PricingTask(Heston(90.0, 0.02, 0.09, 1.5, 0.06, 0.4, -0.6),
                       asian(90.0), maturity=2.0, n_steps=64, task_id=13)
    s, s2 = ops.mc_moments(task, 8192, seed=2, block_paths=block_paths, device=cuda)
    rs, rs2 = ops.mc_moments(task, 8192, seed=2, device="cpu")
    # card against CPU: ulp-different transcendentals on continuous payoffs
    np.testing.assert_allclose(float(s), float(rs), rtol=RTOL)
    np.testing.assert_allclose(float(s2), float(rs2), rtol=RTOL)


def test_kernel_wrapper_checks_inputs(cuda):
    """The path counts are host counts: integers, one a task, within the
    partials' span; counts on the card are refused, since reading them
    would synchronise."""
    tasks = workload.table1_workload(seed=5, n_steps=8, categories=[("BS-A", 2)])
    batch = TaskBatch.from_tasks(tasks, cuda)
    with pytest.raises(TypeError, match="n_active"):
        mc_paths.mc_moments_batch_kernel_call(batch, np.array([1024.0, 1024.0]), 0, 1024)
    with pytest.raises(ValueError, match="n_active"):
        mc_paths.mc_moments_batch_kernel_call(batch, [1024], 0, 1024)
    with pytest.raises(ValueError, match="n_active is on cuda"):
        mc_paths.mc_moments_batch_kernel_call(
            batch, torch.tensor([1024, 1024], dtype=torch.uint32, device=cuda), 0, 1024)
    with pytest.raises(ValueError, match="n_active must lie"):
        mc_paths.mc_moments_batch_kernel_call(batch, [1024, 1025], 0, 1024)


def test_local_platform_on_card(cuda):
    tasks = workload.table1_workload(seed=6, n_steps=32,
                                     categories=[("BS-A", 2), ("H-E", 2)])
    plat = LocalTorchPlatform(device=cuda)
    assert plat.spec.category == "GPU"
    assert plat.spec.device == torch.cuda.get_device_name(cuda)
    before = mc_paths.launch_count()
    ns = [4096, 2048, 8192, 4096]  # within the ragged ratio: one launch a group
    recs = plat.run_batch(tasks, ns, seed=3)
    assert mc_paths.launch_count() == before + 4  # 2 groups, warm-up + timed
    want = price_batch(tasks, ns, seed=3, device="cpu")
    for r, w in zip(recs, want):
        assert r.latency > 0
        np.testing.assert_allclose(r.price, float(w.price), rtol=RTOL)


_TASK_CATEGORIES = ["BS-E", "BS-A", "BS-B", "BS-DB", "BS-DDB",
                    "H-E", "H-A", "H-B", "H-DB", "H-DDB"]


@pytest.mark.parametrize("category", _TASK_CATEGORIES)
def test_task_kernel_matches_plain_version(cuda, category):
    """The single-task kernel against its plain version, for every model x
    payoff instantiation; bitwise repeatable; and its summed moments agree
    with the batch kernel run on the task as a batch of one."""
    task = workload.table1_workload(seed=8, n_steps=64,
                                    categories=[(category, 1)])[0]
    before = mc_paths.launch_count("mc_moments_task")
    got = mc_paths.mc_moments_kernel_call(task, 8192, 21, 1024, device=cuda)
    again = mc_paths.mc_moments_kernel_call(task, 8192, 21, 1024, device=cuda)
    want = mc_paths.mc_moments_kernel_ref(task, 8192, 21, 1024, device=cuda)
    s, s2 = ops.mc_moments(task, 8192, seed=21, device=cuda)
    torch.cuda.synchronize()
    assert mc_paths.launch_count("mc_moments_task") == before + 2
    assert got.shape == (8, 2)
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL)
    np.testing.assert_allclose(got.sum(dim=0).cpu().numpy(),
                               [float(s), float(s2)], rtol=RTOL)


@pytest.mark.parametrize("block_paths", [128, 2048])
def test_task_kernel_block_sweep(cuda, block_paths):
    task = PricingTask(Heston(90.0, 0.02, 0.09, 1.5, 0.06, 0.4, -0.6),
                       asian(90.0), maturity=2.0, n_steps=64, task_id=13)
    got = mc_paths.mc_moments_kernel_call(task, 8192, 2, block_paths, device=cuda)
    want = mc_paths.mc_moments_kernel_ref(task, 8192, 2, block_paths, device=cuda)
    torch.cuda.synchronize()
    assert got.shape == (8192 // block_paths, 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL)


def test_task_kernel_checks_inputs(cuda):
    task = workload.table1_workload(seed=5, n_steps=8, categories=[("BS-A", 1)])[0]
    with pytest.raises(ValueError, match="multiple of 128"):
        mc_paths.mc_moments_kernel_call(task, 1000, 0, 100, device=cuda)
    with pytest.raises(ValueError, match="multiple of block_paths"):
        mc_paths.mc_moments_kernel_call(task, 1000, 0, 256, device=cuda)
    with pytest.raises(ValueError, match="seed"):
        mc_paths.mc_moments_kernel_call(task, 1024, -1, 256, device=cuda)


def _inactive_slots(n_active, block_paths, blocks):
    """Mask of the (T, blocks) slots past each task's active blocks."""
    active = np.diff(mc_paths.active_block_offsets(n_active, block_paths))
    return np.arange(blocks)[None, :] >= active[:, None]


def test_kernel_ragged_zero_counts_and_long_tail(cuda):
    """Zero-count tasks and one 4,194,304-path task among <= 4,096-path
    ones: the kernel simulates only active blocks and still matches the
    plain version, which simulates every block and masks."""
    tasks = workload.table1_workload(seed=9, n_steps=32,
                                     categories=[("H-B", 4), ("H-A", 3)])
    batch = TaskBatch.from_tasks(tasks, cuda)
    n_active = np.array([0, 4096, 1, 0, 4_194_304, 2500, 1024], np.uint32)
    n_max = 4_194_304
    units0 = mc_paths.units_launched()
    got = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 31, n_max, 1024)
    again = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 31, n_max, 1024)
    want = mc_paths.mc_moments_batch_ref(
        batch, torch.from_numpy(n_active).to(cuda), 31, n_max, 1024)
    torch.cuda.synchronize()
    # (4 + 1 + 4096 + 3 + 1) active blocks of 8 units each
    assert mc_paths.last_launch_ctas() == 4105 * 8
    assert mc_paths.units_launched() - units0 == 2 * 4105 * 8
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL)


def test_kernel_inactive_slots_exactly_zero(cuda):
    """Slots of inactive blocks are written as exactly 0, even where the
    caching allocator hands back memory poisoned with NaN."""
    tasks = workload.table1_workload(seed=10, n_steps=16,
                                     categories=[("BS-B", 3), ("BS-E", 2)])
    batch = TaskBatch.from_tasks(tasks, cuda)
    n_active = np.array([0, 300_000, 129, 0, 2048], np.uint32)
    n_max, block = 300_032, 128
    junk = [torch.full((len(tasks), n_max // block, 2), float("nan"), device=cuda)
            for _ in range(3)]
    del junk
    got = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 4, n_max, block)
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert (got[_inactive_slots(n_active, block, n_max // block)] == 0.0).all()


def test_price_batch_launches_only_the_paths_asked(cuda):
    """Through the main path's entry point, shards up to 4x apart in one
    launch: the units the kernel ran hold the paths asked for, rounded up
    to whole 1024-path blocks, not every task up to the largest count."""
    tasks = workload.table1_workload(seed=12, n_steps=16,
                                     categories=[("BS-A", 3), ("BS-E", 3)])
    ns = [250_000, 1_000_000, 400_000, 300_001, 999_999, 2048]
    units0 = mc_paths.units_launched()
    price_batch(tasks, ns, seed=6, device=cuda)
    torch.cuda.synchronize()
    blocks = sum(-(-n // 1024) for n in ns)
    assert mc_paths.units_launched() - units0 == blocks * 1024 // mc_paths.BLOCK_QUANTUM
    assert blocks * 1024 <= 1.01 * sum(ns)


def test_task_kernel_fills_every_sm(cuda):
    """At 65,536 paths the single-task kernel puts a CTA on every SM."""
    task = workload.table1_workload(seed=11, n_steps=64,
                                    categories=[("H-DB", 1)])[0]
    got = mc_paths.mc_moments_kernel_call(task, 65536, 5, 1024, device=cuda)
    want = mc_paths.mc_moments_kernel_ref(task, 65536, 5, 1024, device=cuda)
    torch.cuda.synchronize()
    ctas = mc_paths.last_launch_ctas("mc_moments_task")
    assert ctas == 65536 // mc_paths.BLOCK_QUANTUM
    assert ctas >= max(132, torch.cuda.get_device_properties(cuda).multi_processor_count)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL)
