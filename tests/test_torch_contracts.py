"""Port parity: repro_torch.pricing.contracts / workload against repro's."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.pricing import contracts as ref_contracts
from repro.pricing import workload as ref_workload
from repro_torch.pricing import contracts, workload

CATS = [(c, 1) for c, _ in workload.TABLE1_CATEGORIES]


def _fields(task):
    return (dataclasses.asdict(task.underlying), task.underlying.kind,
            dataclasses.asdict(task.option), task.maturity, task.n_steps,
            task.task_id, task.category)


@pytest.mark.parametrize("seed,n_steps,cats", [
    (2015, 256, None),  # the full 128-task Table 1 workload
    (21, 8, CATS),
])
def test_table1_workload_fields_equal(seed, n_steps, cats):
    # numpy-only generator copied verbatim: the same seed gives the same tasks
    want = ref_workload.table1_workload(seed=seed, n_steps=n_steps, categories=cats)
    got = workload.table1_workload(seed=seed, n_steps=n_steps, categories=cats)
    assert len(got) == len(want) == (128 if cats is None else len(cats))
    assert [_fields(t) for t in got] == [_fields(t) for t in want]


def test_param_layout_equal():
    assert contracts.PARAM_COLS == ref_contracts.PARAM_COLS
    assert contracts.COL == ref_contracts.COL
    assert contracts.N_PARAMS == 14


def test_task_batch_equals_reference():
    # same float64 -> float32 casts of the same rows: equal, inf barriers too
    tasks = workload.table1_workload(seed=5, n_steps=16)
    ref_tasks = ref_workload.table1_workload(seed=5, n_steps=16)
    for (key, group), (ref_key, ref_group) in zip(
            contracts.group_by_launch(tasks), ref_contracts.group_by_launch(ref_tasks)):
        assert key == ref_key
        batch = contracts.TaskBatch.from_tasks([t for _, t in group], "cpu")
        want = ref_contracts.TaskBatch.from_tasks([t for _, t in ref_group])
        np.testing.assert_array_equal(batch.params.numpy(), np.asarray(want.params))
        np.testing.assert_array_equal(batch.task_ids.numpy(), np.asarray(want.task_ids))
        np.testing.assert_array_equal(batch.payoff_kinds.numpy(),
                                      np.asarray(want.payoff_kinds))
        assert batch.params.dtype == torch.float32
        assert batch.task_ids.dtype == torch.uint32
        assert batch.payoff_kinds.dtype == torch.int32
        assert (batch.model_kind, batch.n_steps) == (want.model_kind, want.n_steps)
        assert np.isinf(batch.params[:, contracts.COL["upper"]].numpy()).any() == \
            any(math.isinf(t.option.upper) for _, t in group)


def test_groupings_equal():
    tasks = workload.table1_workload(seed=9, n_steps=8)
    ref_tasks = ref_workload.table1_workload(seed=9, n_steps=8)
    for fn, ref_fn in ((contracts.group_by_family, ref_contracts.group_by_family),
                       (contracts.group_by_launch, ref_contracts.group_by_launch)):
        got = [(k, [i for i, _ in g]) for k, g in fn(tasks)]
        want = [(k, [i for i, _ in g]) for k, g in ref_fn(ref_tasks)]
        assert got == want


def test_task_batch_rejects_mixed_and_unknown():
    tasks = workload.table1_workload(seed=1, n_steps=8,
                                     categories=[("BS-A", 1), ("H-A", 1)])
    with pytest.raises(ValueError, match="family-uniform"):
        contracts.TaskBatch.from_tasks(tasks, "cpu")
    with pytest.raises(ValueError, match="empty"):
        contracts.TaskBatch.from_tasks([], "cpu")
    bad = dataclasses.replace(tasks[0], option=contracts.Option(payoff=9))
    with pytest.raises(ValueError, match="unknown payoff"):
        contracts.TaskBatch.from_tasks([bad], "cpu")


@pytest.mark.parametrize("payoff", range(5))
def test_payoff_from_stats_equals_reference(payoff):
    # elementwise max/compare/select on equal float32 inputs: bitwise
    rng = np.random.default_rng(payoff)
    s_t, avg, mn, mx = (rng.uniform(50, 150, 512).astype(np.float32) for _ in range(4))
    mn = np.minimum(mn, s_t)
    mx = np.maximum(mx, s_t)
    option = contracts.Option(payoff, strike=100.0, lower=70.0,
                              upper=math.inf if payoff == 2 else 130.0,
                              payout=7.5, call=bool(payoff % 2))
    ref_option = ref_contracts.Option(**dataclasses.asdict(option))
    want = np.asarray(ref_contracts.payoff_from_stats(s_t, avg, mn, mx, ref_option))
    t = [torch.from_numpy(a) for a in (s_t, avg, mn, mx)]
    got = contracts.payoff_from_stats(*t, option)
    np.testing.assert_array_equal(got.numpy(), want)
    p = np.asarray(ref_contracts._task_param_row(ref_contracts.PricingTask(
        ref_contracts.BlackScholes(100.0, 0.05, 0.2), ref_option, 1.0, 8)), np.float32)
    col = ref_contracts.COL
    coded = contracts.payoff_from_stats_coded(
        *t, strike=torch.tensor(p[col["strike"]]), lower=torch.tensor(p[col["lower"]]),
        upper=torch.tensor(p[col["upper"]]), payout=torch.tensor(p[col["payout"]]),
        call_sign=torch.tensor(p[col["call_sign"]]),
        kind=torch.tensor(payoff, dtype=torch.int32))
    np.testing.assert_array_equal(coded.numpy(), want)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tasks = workload.table1_workload(seed=1, n_steps=8, categories=[("BS-A", 1)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        contracts.TaskBatch.from_tasks(tasks)
    assert contracts.resolve_device("cpu") == torch.device("cpu")
