"""Port parity: the Monte Carlo moments kernel module against repro's.

On the CPU the port's plain version (``mc_moments_batch_ref``) is held
against the reference's Pallas kernel in interpret mode and its jnp
oracle; the CUDA kernel itself is held against the plain version by
``tests/test_torch_gpu.py``, which runs only where a card is present.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import mc_paths as ref_mc_paths
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.pricing import BlackScholes as RefBS, Heston as RefHeston, PricingTask as RefTask
from repro.pricing import contracts as ref_contracts
from repro.pricing import mc as ref_mc
from repro.pricing import workload as ref_workload
from repro_torch.kernels import mc_paths, ops, ref
from repro_torch.pricing import (
    BlackScholes,
    Heston,
    PricingTask,
    TaskBatch,
    asian,
    barrier,
    digital_double_barrier,
    double_barrier,
    european,
    group_by_launch,
    mc,
    workload,
)

BS = dict(spot=100.0, rate=0.05, volatility=0.25)
HESTON = dict(spot=90.0, rate=0.02, v0=0.09, kappa=1.5, theta=0.06, xi=0.4, rho=-0.6)
OPTIONS = {
    "european": european(100.0),
    "asian": asian(95.0, call=False),
    "barrier": barrier(100.0, upper=135.0),
    "double_barrier": double_barrier(100.0, 60.0, 150.0),
    "digital": digital_double_barrier(7.5, 65.0, 145.0),
}

# Moments are float32 sums of 10^3..10^4 payoffs, drawn from bit-equal
# Threefry streams through transcendentals that differ by an ulp or two:
# rtol 3e-5 is the reference's own kernel-vs-oracle bar
# (tests/test_kernels.py), which covers the summation order as well.
RTOL = 3e-5


def _task_pair(underlying: str, option, maturity=1.0, n_steps=12, task_id=11):
    if underlying == "bs":
        u, ru = BlackScholes(**BS), RefBS(**BS)
    else:
        u, ru = Heston(**HESTON), RefHeston(**HESTON)
    return (PricingTask(u, option, maturity, n_steps, task_id),
            RefTask(ru, option_to_ref(option), maturity, n_steps, task_id))


def option_to_ref(option):
    return ref_contracts.Option(payoff=option.payoff, strike=option.strike,
                                lower=option.lower, upper=option.upper,
                                payout=option.payout, call=option.call)


def _ref_tasks(tasks):
    ids = {t.task_id for t in tasks}
    return [t for t in ref_workload.table1_workload(seed=31, n_steps=16,
                                                    categories=_CATS)
            if t.task_id in ids]


_CATS = [("BS-A", 2), ("BS-DB", 2), ("BS-DDB", 1), ("H-B", 2), ("H-DB", 1),
         ("H-E", 1), ("H-A", 1)]


@pytest.mark.parametrize("group_idx", [0, 1], ids=["bs", "heston"])
def test_plain_partials_match_pallas_interpret(group_idx):
    """(T, blocks, 2) partials with ragged n_active, against the Pallas
    kernel run in interpret mode on the same batch."""
    tasks = workload.table1_workload(seed=31, n_steps=16, categories=_CATS)
    key, group = group_by_launch(tasks)[group_idx]
    sub = [t for _, t in group]
    ref_sub = _ref_tasks(sub)
    rng = np.random.default_rng(group_idx)
    n_active = rng.integers(1, 4096, size=len(sub)).astype(np.uint32)
    n_active[0] = 4096
    want = np.asarray(ref_mc_paths.mc_moments_batch_kernel_call(
        ref_contracts.TaskBatch.from_tasks(ref_sub), jnp.asarray(n_active),
        jnp.asarray([9], jnp.uint32), 4096, block_paths=1024, interpret=True))
    got = mc_paths.mc_moments_batch_ref(
        TaskBatch.from_tasks(sub, "cpu"), torch.from_numpy(n_active), 9, 4096,
        1024).numpy()
    assert got.shape == want.shape == (len(sub), 4, 2)
    # a block past every path of its task sums to exactly 0 in both
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("underlying", ["bs", "heston"])
def test_moments_payoff_sweep(name, underlying):
    task, ref_task = _task_pair(underlying, OPTIONS[name])
    s, s2 = ops.mc_moments(task, 4096, seed=17, block_paths=1024, device="cpu")
    ks, ks2 = ref_ops.mc_moments(ref_task, 4096, seed=17, block_paths=1024,
                                 interpret=True)
    np.testing.assert_allclose(float(s), float(ks), rtol=RTOL)
    np.testing.assert_allclose(float(s2), float(ks2), rtol=RTOL)
    # and the port's per-task oracle (non-coded payoff) agrees with its
    # coded batch engine
    rs, rs2 = ref.mc_moments_ref(task, 4096, seed=17, device="cpu")
    np.testing.assert_allclose(float(s), float(rs), rtol=RTOL)
    np.testing.assert_allclose(float(s2), float(rs2), rtol=RTOL)


@pytest.mark.parametrize("block_paths", [128, 256, 1024, 2048])
def test_moments_block_shape_sweep(block_paths):
    """The result does not depend on the path block."""
    task, ref_task = _task_pair("bs", european(100.0), maturity=0.5,
                                n_steps=8, task_id=12)
    s, s2 = ops.mc_moments(task, 4096, seed=1, block_paths=block_paths,
                           device="cpu")
    rs, rs2 = ref_ref.mc_moments_ref(ref_task, 4096, seed=1)
    np.testing.assert_allclose(float(s), float(rs), rtol=RTOL)
    np.testing.assert_allclose(float(s2), float(rs2), rtol=RTOL)


def test_block_partials_match_reference_blocked_oracle():
    task, ref_task = _task_pair("bs", double_barrier(100.0, 70.0, 140.0),
                                n_steps=8, task_id=14)
    got = ref.mc_block_moments_ref(task, 2048, 3, 256, device="cpu").numpy()
    want = np.asarray(ref_ref.mc_block_moments_ref(ref_task, 2048, 3, 256))
    assert got.shape == (8, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("underlying", ["bs", "heston"])
def test_path_stats_per_path(underlying):
    """Continuous per-path statistics, free of the barrier-indicator noise
    an ulp can cause at small n: each is a float32 product or sum over 16
    steps of ulp-different factors, so rtol 1e-5 (~80 ulps) bounds them."""
    task, ref_task = _task_pair(underlying, european(100.0), n_steps=16,
                                task_id=21)
    got = mc.path_stats(task, 2048, 5, path_offset=1000, device="cpu")
    want = ref_mc.path_stats(ref_task, 2048, 5, path_offset=1000)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2048,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_validate_blocking_errors():
    assert mc_paths.validate_blocking(4096, 1024) == 4
    with pytest.raises(ValueError, match="multiple of 128"):
        mc_paths.validate_blocking(1000, 100)
    with pytest.raises(ValueError, match="multiple of block_paths"):
        mc_paths.validate_blocking(1000, 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        mc_paths.validate_blocking(0, 0)


def test_kernel_call_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are refused, and
    nothing is counted as a launch."""
    tasks = workload.table1_workload(seed=3, n_steps=8, categories=[("BS-A", 2)])
    batch = TaskBatch.from_tasks(tasks, "cpu")
    before = mc_paths.launch_count()
    units = mc_paths.units_launched()
    with pytest.raises(ValueError, match="CUDA tensors"):
        mc_paths.mc_moments_batch_kernel_call(
            batch, torch.tensor([1024, 1024], dtype=torch.uint32), 0, 1024)
    ops.mc_moments_batch(batch, [1024, 512], seed=0)
    assert mc_paths.launch_count() == before
    assert mc_paths.units_launched() == units


def test_launch_counts_sum_units_and_reset():
    """A launch adds one to its kernel's count and its grid's units to the
    unit total; a reset sets both to 0 for every kernel."""
    mc_paths.reset_launch_count()
    mc_paths._count_launch("mc_moments_batch", 40)
    mc_paths._count_launch("mc_moments_batch", 8)
    mc_paths._count_launch("mc_moments_task", 512)
    assert mc_paths.launch_count() == 2 and mc_paths.units_launched() == 48
    assert mc_paths.last_launch_ctas() == 8
    assert mc_paths.units_launched("mc_moments_task") == 512
    mc_paths.reset_launch_count()
    assert all(mc_paths.launch_count(k) == 0 and mc_paths.units_launched(k) == 0
               for k in mc_paths.KERNELS)


def test_ops_validates_inputs():
    tasks = workload.table1_workload(seed=3, n_steps=8, categories=[("BS-A", 2)])
    batch = TaskBatch.from_tasks(tasks, "cpu")
    with pytest.raises(ValueError, match="path counts"):
        ops.mc_moments_batch(batch, [1024], seed=0)
    with pytest.raises(ValueError, match=r"\[0, 2\*\*32\)"):
        ops.mc_moments_batch(batch, [1024, -1], seed=0)
    with pytest.raises(ValueError, match="seed"):
        ops.mc_moments_batch(batch, [1024, 1024], seed=-1)


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("underlying", ["bs", "heston"])
def test_task_partials_match_pallas_interpret(name, underlying):
    """The single-task kernel's plain version against the reference's
    ``_mc_kernel`` in interpret mode: (blocks, 2) partials, as
    tests/test_kernels.py runs it (2048 paths, 256-path blocks)."""
    task, ref_task = _task_pair(underlying, OPTIONS[name], n_steps=8, task_id=14)
    want = np.asarray(ref_mc_paths.mc_moments_kernel_call(
        ref_task, 2048, seed=3, block_paths=256, interpret=True))
    got = mc_paths.mc_moments_kernel_ref(task, 2048, 3, 256, device="cpu").numpy()
    assert got.shape == want.shape == (8, 2)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_task_kernel_rejects_bad_blocks():
    """tests/test_kernels.py's blocking errors, from both the plain version
    and the kernel wrapper (which checks before it needs a card)."""
    task, _ = _task_pair("bs", european(100.0), n_steps=4, task_id=15)
    for call in (mc_paths.mc_moments_kernel_ref, mc_paths.mc_moments_kernel_call):
        with pytest.raises(ValueError, match="multiple of 128"):
            call(task, 1000, 0, block_paths=100, device="cpu")
        with pytest.raises(ValueError, match="multiple of block_paths"):
            call(task, 1000, 0, block_paths=256, device="cpu")


def test_task_kernel_call_refuses_cpu():
    task, _ = _task_pair("heston", asian(95.0), n_steps=4, task_id=16)
    before = mc_paths.launch_count("mc_moments_task")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        mc_paths.mc_moments_kernel_call(task, 1024, 0, 256, device="cpu")
    assert mc_paths.launch_count("mc_moments_task") == before


# Host path counts of the active-block list cases: zero counts, exact
# multiples of the path block, one task far longer than the rest, one task.
_ACTIVE_CASES = {
    "zero_counts": [0, 1500, 0, 1024, 0],
    "exact_multiples": [1024, 2048, 4096, 3072],
    "long_tail": [4096, 100, 4_194_304, 3000, 1],
    "one_task": [5000],
}


@pytest.mark.parametrize("block_paths", [128, 1024])
@pytest.mark.parametrize("case", list(_ACTIVE_CASES))
def test_active_block_offsets_list_each_active_block_once(case, block_paths):
    """Every (t, b) with b * block_paths < n_active[t] is one entry of the
    list, found as the kernel finds it (the last t whose offset is <= the
    entry), and nothing else is."""
    n_active = np.asarray(_ACTIVE_CASES[case], np.uint32)
    offsets = mc_paths.active_block_offsets(n_active, block_paths)
    assert offsets.dtype == np.int32 and offsets.shape == (n_active.size + 1,)
    assert offsets[0] == 0 and (np.diff(offsets) >= 0).all()
    entries = np.arange(int(offsets[-1]))
    t = np.searchsorted(offsets, entries, side="right") - 1
    listed = list(zip(t.tolist(), (entries - offsets[t]).tolist()))
    want = [(k, b) for k, n in enumerate(n_active.tolist())
            for b in range(-(-n // block_paths))]
    assert sorted(listed) == want and len(set(listed)) == len(listed)
    assert all(b * block_paths < int(n_active[k]) for k, b in listed)


def test_active_block_offsets_refuse_negative_counts():
    with pytest.raises(ValueError, match="non-negative"):
        mc_paths.active_block_offsets([1024, -1], 1024)


@pytest.mark.parametrize("group_idx", [0, 1], ids=["bs", "heston"])
def test_plain_partials_exactly_zero_in_inactive_slots(group_idx):
    """The plain version, which simulates every block and masks, writes
    exactly 0 where the kernel's list has no block; the active slots of a
    task with paths hold its sums."""
    tasks = workload.table1_workload(seed=31, n_steps=8, categories=_CATS)
    _key, group = group_by_launch(tasks)[group_idx]
    sub = [t for _, t in group][:4]
    n_active = np.asarray([0, 1025, 4096, 1][:len(sub)], np.uint32)
    got = mc_paths.mc_moments_batch_ref(
        TaskBatch.from_tasks(sub, "cpu"), torch.from_numpy(n_active), 5, 4096,
        1024).numpy()
    active = np.diff(mc_paths.active_block_offsets(n_active, 1024))
    for t, n_blocks in enumerate(active.tolist()):
        assert (got[t, n_blocks:] == 0.0).all()
    # the squared sums of active blocks are positive wherever the sums are
    live = got[:, :, 0] != 0
    assert (got[:, :, 1][live] > 0).all()
