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
    n_active = torch.tensor([8192, 5000, 100, 8192, 1, 7000, 4097],
                            dtype=torch.uint32, device=cuda)
    before = mc_paths.launch_count()
    got = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 77, 8192, 1024)
    again = mc_paths.mc_moments_batch_kernel_call(batch, n_active, 77, 8192, 1024)
    want = mc_paths.mc_moments_batch_ref(batch, n_active, 77, 8192, 1024)
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
    tasks = workload.table1_workload(seed=5, n_steps=8, categories=[("BS-A", 2)])
    batch = TaskBatch.from_tasks(tasks, cuda)
    with pytest.raises(TypeError, match="n_active"):
        mc_paths.mc_moments_batch_kernel_call(
            batch, torch.tensor([1024, 1024], dtype=torch.int64, device=cuda), 0, 1024)
    with pytest.raises(ValueError, match="n_active"):
        mc_paths.mc_moments_batch_kernel_call(
            batch, torch.tensor([1024], dtype=torch.uint32, device=cuda), 0, 1024)
    with pytest.raises(ValueError, match="n_active is on cpu"):
        mc_paths.mc_moments_batch_kernel_call(
            batch, torch.tensor([1024, 1024], dtype=torch.uint32), 0, 1024)


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
