"""Port parity: the online re-allocation loop against the reference's.

The port's ``OnlineScheduler`` and the reference's run side by side on the
setup of ``tests/test_online.py``: a Table 1 subset on three simulated
Table 2 rows (Desktop, Local GPU 1, Local FPGA 1), calibrated on the CPU.
Simulated latencies do not depend on the engine and simulated prices only
through the calibration moments (agreeing to ~3e-5), so the two loops see
the same drift, take the same decisions and measure the same makespans.
"""
import dataclasses

import numpy as np
import pytest

import repro.pricing as ref_pricing
import repro.runtime as ref_runtime
from repro.pricing.platforms import _TaskMoments as RefMoments
import repro_torch.pricing as pricing
import repro_torch.runtime as runtime
from repro_torch.pricing.platforms import _TaskMoments

LADDER = (512, 2048, 8192)
ROWS = (0, 9, 14)  # Desktop, Local GPU 1, Local FPGA 1
CATS = [("BS-A", 3), ("H-A", 3)]
ACCURACY = 0.05
#: the measured makespan is a sum of replayed latencies over shards whose
#: sizes follow the fitted models; those carry the ~3e-5 calibration error
MAKESPAN_RTOL = 1e-3


def _fresh(port: bool, scenario=None, extra_task_id=None):
    """A characterised scheduler on fresh simulated platforms, in the port
    (``port=True``, calibrated on the CPU) or in the reference."""
    pkg, rt = (pricing, runtime) if port else (ref_pricing, ref_runtime)
    tasks = pkg.table1_workload(seed=12, n_steps=8, categories=CATS)
    if port:
        moments = _TaskMoments(calib_paths=4096, device="cpu")
        platforms = [pkg.SimulatedPlatform(pkg.TABLE2_SPECS[i], moments=moments,
                                           seed=7, device="cpu") for i in ROWS]
    else:
        moments = RefMoments(calib_paths=4096)
        platforms = [pkg.SimulatedPlatform(pkg.TABLE2_SPECS[i], moments=moments,
                                           seed=7) for i in ROWS]
    sched = rt.Scheduler(rt.make_domain("pricing", tasks, platforms))
    sched.characterise(seed=1, path_ladder=LADDER)
    if scenario is not None:
        for p in platforms:
            p.attach_scenario(scenario)
    return sched


def _extra(port: bool):
    pkg = pricing if port else ref_pricing
    task = pkg.table1_workload(seed=12, n_steps=8, categories=CATS)[0]
    return dataclasses.replace(task, task_id=100)


def _solver_kw(method: str, port: bool) -> dict:
    if method == "milp":
        return dict(time_limit=20)
    return dict(device="cpu") if port and method == "ml" else {}


def _run_pair(method, make_scenario=None, rounds=6, pass_scenario=False, **kw):
    """Run the online loop in both packages; returns (port, reference)."""
    reps = []
    for port in (True, False):
        rt = runtime if port else ref_runtime
        sc = make_scenario(rt.Scenario(), port) if make_scenario else None
        sched = _fresh(port, sc)
        run_kw = dict(_solver_kw(method, port), **kw)
        if pass_scenario:
            run_kw["scenario"] = sc
        reps.append(rt.OnlineScheduler(sched, rt.OnlineConfig(rounds=rounds)).run(
            ACCURACY, method=method, seed=3, **run_kw))
    return reps


def _decisions(rep):
    return ([(r.round, r.drifted, r.failed, r.resolved, r.solve_outcome)
             for r in rep.rounds],
            (rep.n_solves, rep.n_resolves, rep.n_skipped, rep.n_refits))


def test_no_drift_solves_exactly_once():
    port, ref = _run_pair("milp")
    assert port.n_solves == ref.n_solves == 1
    assert port.n_resolves == port.n_skipped == port.n_refits == 0
    assert _decisions(port) == _decisions(ref)
    np.testing.assert_allclose(port.measured_makespan, ref.measured_makespan,
                               rtol=MAKESPAN_RTOL)
    for ci in port.summary["measured_ci"].values():
        assert ci <= ACCURACY * 1.25


@pytest.fixture(scope="module")
def midpoint():
    """The reference's static plan: its busiest platform and half-makespan."""
    base = _fresh(port=False)
    alloc = base.allocate(ACCURACY, method="milp", time_limit=20)
    return "Local GPU 1", alloc.makespan / 2


@pytest.mark.parametrize("method", ["milp", "ml"])
def test_midpoint_slowdown_same_decisions(midpoint, method):
    """A 4x slowdown at the static plan's half-makespan: drift fires in the
    same rounds, with the same re-solve and refit counts, and the measured
    makespans agree."""
    name, t = midpoint
    port, ref = _run_pair(method, lambda sc, _: sc.slowdown(name, t, 4.0))
    assert ref.n_resolves >= 1
    assert _decisions(port) == _decisions(ref)
    np.testing.assert_allclose(port.measured_makespan, ref.measured_makespan,
                               rtol=MAKESPAN_RTOL)


def test_outage_recovery_completes_all_tasks():
    dead = "Local GPU 1"
    port, ref = _run_pair("milp", lambda sc, _: sc.outage(dead, t=0.02))
    assert port.dead_platforms == ref.dead_platforms == (dead,)
    assert _decisions(port) == _decisions(ref)
    assert sorted(port.summary["prices"]) == sorted(ref.summary["prices"])
    assert len(port.summary["prices"]) == 6
    for ci in port.summary["measured_ci"].values():
        assert ci <= ACCURACY * 1.25
    death_round = next(r.round for r in port.rounds if r.failed and r.resolved)
    for r in port.rounds:
        if r.round > death_round:
            assert dead not in r.dispatched_units


def test_streaming_arrival_takes_patch_path():
    port, ref = _run_pair(
        "milp", lambda sc, is_port: sc.arrive(t=0.05, task=_extra(is_port)),
        pass_scenario=True)
    assert port.n_patched == ref.n_patched == 1
    assert "patched" in [r.solve_outcome for r in port.rounds]
    assert _decisions(port) == _decisions(ref)
    assert any(m.get("incremental") == "patched" for m in port.solve_metas)
    assert port.summary["measured_ci"][100] <= ACCURACY * 1.25


def test_concurrent_sequential_bitwise_identical():
    def run(mode):
        sc = runtime.Scenario().slowdown("Local GPU 1", 0.05, 4.0)
        sched = _fresh(True, sc)
        return runtime.OnlineScheduler(sched, runtime.OnlineConfig(rounds=6)).run(
            ACCURACY, method="milp", seed=3, mode=mode, time_limit=20)

    conc, seq = run("concurrent"), run("sequential")
    assert conc.n_resolves == seq.n_resolves
    assert conc.records == seq.records
    assert conc.mode == "concurrent" and seq.mode == "sequential"


def test_reference_records_load_and_refit_same_models(tmp_path):
    """Execute-time records the reference dumped load into the port's
    record type and refit the same latency and accuracy models."""
    ref_sched = _fresh(port=False)
    rep = ref_runtime.OnlineScheduler(ref_sched, ref_runtime.OnlineConfig(rounds=4)).run(
        ACCURACY, method="heuristic", seed=3)
    flat = [r for recs in ref_sched.characterise_records.values() for r in recs]
    path = tmp_path / "reference.jsonl"
    ref_runtime.dump_records(flat + rep.records, path)
    loaded = runtime.load_records(path)
    assert len(loaded) == len(flat) + len(rep.records)
    assert all(type(r) is pricing.RunRecord for r in loaded)
    assert [dataclasses.astuple(r) for r in loaded] == \
        [dataclasses.astuple(r) for r in flat + rep.records]
    port_domain = _fresh(port=True).domain
    for key, recs in runtime.group_records(loaded).items():
        want = ref_sched.domain.fit_models(ref_runtime.group_records(flat + rep.records)[key])
        got = port_domain.fit_models(recs)
        for attr in ("beta", "gamma"):
            np.testing.assert_allclose(getattr(got.latency, attr),
                                       getattr(want.latency, attr), rtol=1e-9)
        np.testing.assert_allclose(got.accuracy.alpha, want.accuracy.alpha, rtol=1e-9)


def test_lm_kinds_wait_for_their_slice(tmp_path):
    path = tmp_path / "lm.jsonl"
    path.write_text('{"kind": "ServeRecord", "platform": "Cloud Pod"}\n')
    with pytest.raises(KeyError, match="ServeRecord.*LM-serving slice"):
        runtime.load_records(path)
    with pytest.raises(KeyError, match="lm_serving.*LM-serving slice"):
        runtime.make_domain("lm_serving", [], [])
    assert runtime.available_domains() == ["pricing"]
