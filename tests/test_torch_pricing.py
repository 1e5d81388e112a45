"""Port parity: repro_torch.pricing's engine and local platform against repro's."""
import numpy as np
import pytest
import torch

from repro.pricing import LocalJaxPlatform
from repro.pricing import mc as ref_mc
from repro.pricing import workload as ref_workload
from repro_torch.pricing.platforms import _TaskMoments
from repro_torch.pricing import (
    TABLE2_SPECS,
    LocalTorchPlatform,
    SimulatedPlatform,
    build_cluster,
    launch_count,
    mc,
    price,
    price_batch,
    workload,
)

ALL_CATS = [(c, 1) for c, _ in workload.TABLE1_CATEGORIES]

# Prices are the discounted mean of float32 payoff sums that agree to the
# kernel bar (rtol 3e-5). The CI takes sqrt(E[p^2] - E[p]^2): the
# subtraction can double a relative error and the sqrt halves it again, so
# CIs are held at rtol 6e-5.
PRICE_RTOL = 3e-5
CI_RTOL = 6e-5


def _assert_results_close(got, want):
    for g, w in zip(got, want):
        assert int(g.n_paths) == int(w.n_paths)
        np.testing.assert_allclose(float(g.price), float(w.price), rtol=PRICE_RTOL)
        np.testing.assert_allclose(float(g.ci95), float(w.ci95), rtol=CI_RTOL)
        np.testing.assert_allclose(float(g.std_error), float(w.std_error),
                                   rtol=CI_RTOL)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_price_batch_matches_reference_all_categories(backend):
    tasks = workload.table1_workload(seed=21, n_steps=8, categories=ALL_CATS)
    ref_tasks = ref_workload.table1_workload(seed=21, n_steps=8, categories=ALL_CATS)
    got = price_batch(tasks, 2048, seed=5, device="cpu")
    want = ref_mc.price_batch(ref_tasks, 2048, seed=5, backend=backend)
    _assert_results_close(got, want)


def test_price_batch_ragged_path_counts():
    """Padded/masked batching: each task uses exactly its own first n draws,
    and a ragged spread splits into buckets as in the reference."""
    cats = [("BS-A", 2), ("H-B", 2)]
    tasks = workload.table1_workload(seed=22, n_steps=8, categories=cats)
    ref_tasks = ref_workload.table1_workload(seed=22, n_steps=8, categories=cats)
    ns = [2048, 100, 4096, 64]
    _assert_results_close(price_batch(tasks, ns, seed=2, device="cpu"),
                          ref_mc.price_batch(ref_tasks, ns, seed=2))
    for counts in ([1024, 1024, 1024], [100_000, 64, 90_000, 80], [5, 0, 21, 84]):
        assert mc._ragged_buckets(counts) == ref_mc._ragged_buckets(counts)


def test_price_single_task_matches_batch():
    tasks = workload.table1_workload(seed=23, n_steps=8, categories=[("H-DDB", 2)])
    batch = price_batch(tasks, 3000, seed=4, device="cpu")
    one = price(tasks[1], 3000, seed=4, device="cpu")
    # the same paths through the same plain engine: bitwise
    assert (one.price, one.ci95) == (batch[1].price, batch[1].ci95)


def test_local_platform_cpu_matches_reference_prices():
    """Records of the local platform: prices and CIs only (latencies are
    wall clock and never compared)."""
    cats = [("BS-DB", 2), ("H-E", 2)]
    tasks = workload.table1_workload(seed=24, n_steps=8, categories=cats)
    ref_tasks = ref_workload.table1_workload(seed=24, n_steps=8, categories=cats)
    ns = [1024, 3072, 2048, 512]
    plat = LocalTorchPlatform(device="cpu")
    assert (plat.spec.name, plat.spec.category) == ("Local Torch", "CPU")
    before = launch_count()
    got = plat.run_batch(tasks, ns, seed=6)
    want = LocalJaxPlatform().run_batch(ref_tasks, ns, seed=6)
    assert launch_count() == before  # the CPU never reaches the CUDA kernel
    for g, w in zip(got, want):
        assert (g.task_id, g.n_paths) == (w.task_id, w.n_paths)
        assert g.latency > 0
        np.testing.assert_allclose(g.price, w.price, rtol=PRICE_RTOL)
        np.testing.assert_allclose(g.ci95, w.ci95, rtol=CI_RTOL)


def test_entry_points_refuse_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks = workload.table1_workload(seed=1, n_steps=8, categories=[("BS-A", 1)])
    for call in (lambda: price(tasks[0], 1024),
                 lambda: price_batch(tasks, 1024),
                 lambda: LocalTorchPlatform(),
                 lambda: build_cluster(),
                 # the calibration cache refuses at construction, not at
                 # its first launch
                 lambda: _TaskMoments(),
                 lambda: SimulatedPlatform(TABLE2_SPECS[0])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
