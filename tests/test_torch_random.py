"""lightgbm_tpu_torch's keyed RNG (``utils/random.py``) against
``jax.random`` on the CPU: the same keys, the same uniform bits, and so
the same bagging and feature-fraction masks as the JAX package's
``_device_bag_mask`` / ``_device_feature_mask``.  Everything is compared
bitwise."""
import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting.gbdt import (_device_bag_mask,
                                        _device_feature_mask)

from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.utils import random as keyed

torch.set_num_threads(1)   # tiny tensors: more threads only spin

SEEDS = [0, 2, 3, 12345, -7, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    assert keyed.PRNGKey(seed) == tuple(int(v) for v in np.asarray(jk))
    for data in (0, 1, 7, 2 ** 32 - 1):
        got = keyed.fold_in(keyed.PRNGKey(seed), data)
        ref = jax.random.fold_in(jk, data)
        assert got == tuple(int(v) for v in np.asarray(ref))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 70001],
                         ids=lambda n: f"n{n}")
def test_uniform_bitwise(n):
    for seed, epoch in ((3, 0), (3, 5), (-7, 1), (2 ** 31 - 1, 12)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        ref = np.asarray(jax.random.uniform(jk, (n,)))
        got = keyed.uniform(keyed.fold_in(keyed.PRNGKey(seed), epoch), (n,))
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert got.numpy().tobytes() == ref.tobytes()


def test_seed_outside_int32_raises():
    with pytest.raises(OverflowError):
        keyed.PRNGKey(2 ** 31)


@pytest.mark.parametrize("seed,epoch,n,frac", [
    (3, 0, 3000, 0.8), (3, 1, 3000, 0.8), (11, 4, 65536, 0.5),
    (3, 2, 12345, 0.9)])
def test_bag_mask_bitwise(seed, epoch, n, frac):
    ref = np.asarray(_device_bag_mask(seed, epoch, n, frac))
    got = tgbdt.bag_mask(seed, epoch, n, frac, "cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed,F,frac", [(2, 6, 0.8), (2, 28, 0.8),
                                         (5, 28, 0.5), (9, 1, 0.8),
                                         (2, 200, 0.3)])
def test_feature_mask_exactly_k_bitwise(seed, F, frac):
    k = max(1, int(frac * F))
    for tree_idx in range(8):
        ref = np.asarray(_device_feature_mask(seed, tree_idx, F, k))
        got = tgbdt.feature_mask(seed, tree_idx, F, k).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.sum() == k
