"""lightgbm_tpu_torch binning and device data against the JAX package.

The port keeps its own copy of the binning and dataset code; on the same
X (NaNs, zeros, sparse columns that bundle under EFB, a constant column,
categorical columns) its BinMappers, bins, bundle layout and device
metadata must be byte-identical to
``lightgbm_tpu.io.dataset.BinnedDataset.from_raw``.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JDataset
from lightgbm_tpu.io.device import feature_meta_np as j_feature_meta
from lightgbm_tpu.ops.pallas_histogram import transpose_bins_host

from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import device_data_from_numpy
from lightgbm_tpu_torch.io.dataset import BinnedDataset as TDataset
from lightgbm_tpu_torch.io.device import feature_meta_np as t_feature_meta

torch.set_num_threads(1)   # tiny tensors: more threads only spin


def _matrix(seed=0, n=4000):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, 9))
    X[rng.rand(n) < 0.1, 1] = np.nan                 # NaN bin
    X[rng.rand(n) < 0.4, 2] = 0.0                    # many zeros
    rows = np.arange(n)
    for i, f in enumerate((5, 6, 7)):                # exclusive sparse
        X[(rows % 3 != i) | (rng.rand(n) < 0.7), f] = 0.0   # -> EFB
    X[:, 8] = 3.0                                    # constant: unused
    X[:, 3] = np.round(X[:, 3] * 3)                  # few distinct values
    return X


PARAMS = [
    {"max_bin": 63},
    {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 15, "use_missing": False, "enable_bundle": False},
]


def _both(params, seed=0):
    X = _matrix(seed)
    j = JDataset.from_raw(X, JConfig.from_params(dict(params)))
    t = TDataset.from_raw(X, TConfig.from_params(dict(params)))
    return j, t


@pytest.mark.parametrize("params", PARAMS,
                         ids=[str(sorted(p.items())) for p in PARAMS])
def test_binmappers_and_bins_byte_identical(params):
    j, t = _both(params)
    assert len(j.mappers) == len(t.mappers)
    for mj, mt in zip(j.mappers, t.mappers):
        dj, dt = mj.to_dict(), mt.to_dict()
        # the NaN bin's bound is NaN: compare bounds as arrays
        np.testing.assert_array_equal(dj.pop("bin_upper_bound"),
                                      dt.pop("bin_upper_bound"))
        assert dj == dt
    assert j.used_features == t.used_features
    assert j.bins.dtype == t.bins.dtype
    np.testing.assert_array_equal(j.bins, t.bins)
    assert (j.bundle is None) == (t.bundle is None)
    if j.bundle is not None:
        assert j.bundle.groups == t.bundle.groups
        np.testing.assert_array_equal(j.bundle.feat_offset,
                                      t.bundle.feat_offset)


def test_efb_bundles_the_sparse_columns():
    j, t = _both({"max_bin": 63})
    assert t.bundle is not None and t.bundle.is_bundled
    assert t.bins.shape[1] < len(t.used_features)


@pytest.mark.parametrize("params", PARAMS[:2],
                         ids=["max_bin63", "zero_as_missing"])
def test_device_data_matches_reference_layout(params):
    j, t = _both(params)
    mj, mt = j_feature_meta(j), t_feature_meta(t)
    assert mj.keys() == mt.keys()
    for k in mj:
        np.testing.assert_array_equal(np.asarray(mj[k]), np.asarray(mt[k]))
    dd = device_data_from_numpy(j.bins, mj, "cpu")
    # the kernels' transposed bins: the reference's [G, n_pad] layout
    np.testing.assert_array_equal(dd.bins_t.numpy(),
                                  transpose_bins_host(j.bins))
    assert dd.device == torch.device("cpu")
    assert dd.is_bundled == mj["is_bundled"]


@pytest.mark.parametrize("params", PARAMS[:2],
                         ids=["max_bin63", "zero_as_missing"])
def test_categorical_features_bin_as_reference(params):
    """Categorical columns — a few categories with negatives and NaNs,
    more categories than ``max_bin`` (the rarest fall into the cut), and
    a sparse column that EFB bundles — bin as the JAX package bins
    them: mappers, bins, bundles and device metadata byte-identical,
    and a valid set's and prediction mode's miss bins too."""
    X = _matrix()
    rng = np.random.RandomState(1)
    X[:, 4] = np.round(X[:, 4] * 2)                  # -5..5: negatives
    X[rng.rand(len(X)) < 0.05, 4] = np.nan
    X[:, 0] = rng.randint(0, 300, size=len(X))       # > max_bin categories
    X[:, 6] = np.where(X[:, 6] != 0, rng.randint(1, 9, size=len(X)), 0)
    cats = [0, 4, 6]
    j = JDataset.from_raw(X, JConfig.from_params(dict(params)),
                          categorical_features=cats)
    t = TDataset.from_raw(X, TConfig.from_params(dict(params)),
                          categorical_features=cats)
    for mj, mt in zip(j.mappers, t.mappers):
        dj, dt = mj.to_dict(), mt.to_dict()
        np.testing.assert_array_equal(dj.pop("bin_upper_bound"),
                                      dt.pop("bin_upper_bound"))
        assert dj == dt
    assert [t.mappers[c].bin_type for c in cats] == [1, 1, 1]
    assert t.mappers[0].num_bin < 300
    np.testing.assert_array_equal(j.bins, t.bins)
    assert t.bundle is not None and t.bundle.is_bundled
    assert j.bundle.groups == t.bundle.groups
    mj, mt = j_feature_meta(j), t_feature_meta(t)
    for k in mj:
        np.testing.assert_array_equal(np.asarray(mj[k]), np.asarray(mt[k]))
    assert mt["has_categorical"]
    dd = device_data_from_numpy(t.bins, mt, "cpu")
    assert dd.has_categorical and bool(dd.is_categorical[cats].all())
    # unseen categories: num_bin - 1 in a valid set, num_bin in
    # prediction mode (the reference's two miss bins)
    Xv = X[:500].copy()
    Xv[:, 0] = 1000 + np.arange(500)
    for pm in (False, True):
        vj = JDataset.from_raw(Xv, JConfig.from_params(dict(params)),
                               reference=j, prediction_mode=pm)
        vt = TDataset.from_raw(Xv, TConfig.from_params(dict(params)),
                               reference=t, prediction_mode=pm)
        np.testing.assert_array_equal(vj.bins, vt.bins)
