"""Port parity: repro_torch.kernels.prng against repro.kernels.prng.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

from repro.kernels import prng as ref_prng
from repro_torch.kernels import prng


def _words(seed: int, n: int):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
    x0 = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    return k, x0, x1


def _both(fn_ref, fn, seed: int, n: int = 4096):
    k, x0, x1 = _words(seed, n)
    want = fn_ref(k[0], k[1], x0, x1)
    got = fn(int(k[0]), int(k[1]), torch.from_numpy(x0.astype(np.int64)),
             torch.from_numpy(x1.astype(np.int64)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_bit_equal(seed):
    # integer arithmetic: exact by construction, so bitwise
    want, got = _both(ref_prng.threefry2x32, prng.threefry2x32, seed)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.astype(np.int64), g)


def test_threefry_broadcasts_tensor_keys():
    # the plain kernel keys each task's row with a (T, 1) task-id column
    k, x0, x1 = _words(3, 256)
    keys = np.array([k[1], 7, 0xFFFFFFFF], dtype=np.uint32)
    got0, got1 = prng.threefry2x32(
        int(k[0]), torch.from_numpy(keys.astype(np.int64))[:, None],
        torch.from_numpy(x0.astype(np.int64))[None, :],
        torch.from_numpy(x1.astype(np.int64))[None, :])
    for row, key in enumerate(keys):
        w0, w1 = ref_prng.threefry2x32(k[0], key, x0, x1)
        np.testing.assert_array_equal(np.asarray(w0).astype(np.int64), got0[row].numpy())
        np.testing.assert_array_equal(np.asarray(w1).astype(np.int64), got1[row].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_uniforms_bit_equal(seed):
    # a 24-bit integer to float32 is exact, then +0.5 and x2^-24 are exact
    want, got = _both(ref_prng.uniforms, prng.uniforms, seed)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(w, g)
        assert g.min() > 0.0 and g.max() < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_pair_close(seed):
    # the uniforms are bit-equal, but log/cos/sin differ by an ulp or two
    # between XLA's CPU code and PyTorch's: rtol 1e-6 is about 8 float32 ulps
    want, got = _both(ref_prng.normal_pair, prng.normal_pair, seed)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_normal_moments():
    z0, z1 = prng.normal_pair(3, 4, torch.arange(1 << 16, dtype=torch.int64), 0)
    z = torch.cat([z0, z1]).numpy()
    assert abs(z.mean()) < 0.01
    assert abs(z.std() - 1.0) < 0.01
    assert np.isfinite(z).all()
