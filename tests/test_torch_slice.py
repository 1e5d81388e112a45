"""The slice end to end on the CPU: characterise -> allocate -> execute.

The port's ``PricingSolver`` and the reference's run the same Table 1
subset on the same simulated Table 2 platforms. Simulated latencies do not
depend on the engine, and simulated prices and CIs depend on it only
through the calibration moments (agreeing to ~3e-5), so the fitted models,
the allocations and the executed records must agree closely.
"""
import math

import numpy as np
import pytest

import repro.pricing as ref_pricing
import repro_torch.pricing as pricing

CATS = [("BS-A", 2), ("H-DB", 2)]
#: Desktop, AWS EC1, Local GPU 1, Local FPGA 1: CPU, cloud, GPU and FPGA rows
SPECS = [0, 4, 9, 14]
ACCURACY = 0.05


@pytest.fixture(scope="module")
def solvers():
    ref = ref_pricing.PricingSolver(
        ref_pricing.table1_workload(n_steps=8, categories=CATS),
        ref_pricing.build_cluster(include_local=False,
                                  specs=[ref_pricing.TABLE2_SPECS[i] for i in SPECS]))
    port = pricing.PricingSolver(
        pricing.table1_workload(n_steps=8, categories=CATS),
        pricing.build_cluster(include_local=False,
                              specs=[pricing.TABLE2_SPECS[i] for i in SPECS],
                              device="cpu"))
    ref.characterise()
    port.characterise()
    return ref, port


def test_fitted_models_match(solvers):
    # delta carries the calibration-moment error (~3e-5) through a
    # least-squares fit; rtol 1e-3 leaves a 30x margin
    ref, port = solvers
    np.testing.assert_allclose(port._delta, ref._delta, rtol=1e-3)
    np.testing.assert_allclose(port._gamma, ref._gamma, rtol=1e-3)


@pytest.mark.parametrize("method", ["milp", "heuristic"])
def test_allocate_and_execute_match(solvers, method):
    ref, port = solvers
    ref_alloc = ref.allocate(ACCURACY, method)
    alloc = port.allocate(ACCURACY, method)
    ref_rep = ref.execute(ref_alloc, ACCURACY)
    rep = port.execute(alloc, ACCURACY)
    # the makespan is a continuous function of the fitted models
    np.testing.assert_allclose(rep.predicted_makespan, ref_rep.predicted_makespan,
                               rtol=1e-3)
    # replayed latencies carry a 2% lognormal jitter keyed on the shard
    # size, which may differ by a path (below): five jitter sigmas
    np.testing.assert_allclose(rep.measured_makespan, ref_rep.measured_makespan,
                               rtol=0.1)
    assert len(rep.records) == len(ref_rep.records)
    for g, w in zip(rep.records, ref_rep.records):
        assert (g.platform, g.task_id) == (w.platform, w.task_id)
        # shard sizes are ceil(share x paths-for-accuracy): models that agree
        # to ~1e-6 move a million-path shard by at most a path or two
        np.testing.assert_allclose(g.n_paths, w.n_paths, rtol=1e-5)
        if g.n_paths == w.n_paths:
            # same estimator-noise draw (it is keyed on n): only the
            # calibration moments differ
            np.testing.assert_allclose(g.price, w.price, rtol=1e-3)
            np.testing.assert_allclose(g.ci95, w.ci95, rtol=1e-3)
        else:
            # a different n draws independent noise: the price within five
            # standard errors of the difference, the CI within five standard
            # deviations of its chi-square factor sqrt(chi2_k / k)
            se = w.ci95 / (2 * 1.96)
            assert abs(g.price - w.price) <= 5 * math.sqrt(2) * se
            k = min(w.n_paths - 1, 10 ** 6)
            np.testing.assert_allclose(g.ci95, w.ci95, rtol=5 / math.sqrt(k))
    assert max(rep.measured_ci.values()) <= ACCURACY * 1.1


def test_ml_solver_waits_for_its_port(solvers):
    """The "ml" solver is ported: it allocates the slice's problem, plain and
    clustered, within the reference tests' order milp <= ml <= heuristic."""
    _, port = solvers
    assert sorted(pricing.SOLVERS) == ["heuristic", "milp", "ml"]
    heur = port.allocate(ACCURACY, "heuristic")
    milp = port.allocate(ACCURACY, "milp", time_limit=30)
    for cluster in (False, True):
        ml = port.allocate(ACCURACY, "ml", cluster=cluster, chains=8,
                           steps=1500, rounds=1, device="cpu")
        assert ml.solver == "ml" or ml.meta.get("method") == "ml"
        np.testing.assert_allclose(ml.A.sum(axis=0), 1.0)
        assert ml.makespan <= heur.makespan * (1 + 1e-6)
        if milp.optimal:
            assert milp.makespan <= ml.makespan * (1 + 1e-4)


def test_local_platform_in_the_loop_cpu():
    """The local platform of the slice, on the CPU: one task group through
    characterise and execute, prices within their CIs of the reference's."""
    tasks = pricing.table1_workload(n_steps=8, categories=[("BS-A", 2)])
    ref_tasks = ref_pricing.table1_workload(n_steps=8, categories=[("BS-A", 2)])
    plat = pricing.LocalTorchPlatform(device="cpu")
    solver = pricing.PricingSolver(tasks, [plat])
    solver.characterise(path_ladder=[1024, 2048, 4096])
    rep = solver.execute(solver.allocate(0.5, "heuristic"), 0.5)
    want = ref_pricing.price_batch(ref_tasks, 1 << 16, seed=99)
    for t, w in zip(tasks, want):
        assert abs(rep.prices[t.task_id] - float(w.price)) <= 5 * rep.measured_ci[t.task_id]
    assert max(rep.measured_ci.values()) <= 0.5 * 1.2
