"""Seeded route waves of deep trees on synthetic bins, for the route
kernels' tests on the CPU (``test_torch_route.py``, against the JAX
package) and on the card (``test_torch_cuda.py``, against the plain
versions).  numpy only."""
import numpy as np

from lightgbm_tpu_torch.io.binning import MISSING_NAN


def deep_wave(seed, L, n, G, max_bin, n_live, n_sel, cat_share=0.0,
               int32=False, Bcat=64, bundled=0.4):
    """A wave of a deep tree on synthetic bins ``[G, n_pad]``: rows over
    ``n_live`` leaves (80% in the bag, padding rows -1), ``n_sel`` of
    them split with right children ``n_live + rank``; ``F = 2 G``
    features over the groups, a share of them EFB-bundled (offset >= 0),
    every missing type; about ``cat_share`` of the splits categorical,
    on features whose bins stay under ``Bcat`` with random masks.  ->
    ``(bins_t, leaf2, tables, metas)`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    F = 2 * G
    n_pad = -(-n // 2048) * 2048
    dt = np.int32 if int32 else np.uint8
    bins_t = np.zeros((G, n_pad), dt)
    bins_t[:, :n] = rng.randint(0, max_bin, (G, n))
    # the last group holds small bins only: categorical features live there
    bins_t[G - 1, :n] = rng.randint(0, Bcat, n)
    feat_group = rng.randint(0, G - 1, F).astype(np.int32)
    feat_group[-4:] = G - 1
    num_bins = rng.randint(2, max_bin + 1, F).astype(np.int32)
    num_bins[-4:] = rng.randint(2, Bcat + 1, 4)
    feat_offset = np.where(rng.rand(F) < bundled,
                           rng.randint(0, max_bin, F), -1).astype(
                               np.int32)
    feat_offset[-4:] = -1
    default_bins = (rng.randint(0, max_bin, F) % num_bins).astype(np.int32)
    missing_types = rng.randint(0, 3, F).astype(np.int32)
    nan_bins = np.where(missing_types == MISSING_NAN, num_bins - 1,
                        -1).astype(np.int32)
    metas = dict(missing_types=missing_types, nan_bins=nan_bins,
                 default_bins=default_bins, feat_group=feat_group,
                 feat_offset=feat_offset, num_bins=num_bins)

    leaf2 = np.full((2, n_pad), -1, np.int32)
    leaf2[0, :n] = rng.randint(0, n_live, n)
    leaf2[1, :n] = np.where(rng.rand(n) < 0.8, leaf2[0, :n], -1)
    sel = np.zeros(L, bool)
    sel[rng.permutation(n_live)[:n_sel]] = True
    is_cat = sel & (rng.rand(L) < cat_share)
    feature = rng.randint(0, F - 4, L).astype(np.int32)
    feature[is_cat] = rng.randint(F - 4, F, int(is_cat.sum()))
    nb = num_bins[feature]
    tables = dict(
        feature=feature,
        threshold=(rng.rand(L) * nb).astype(np.int32) - 1,
        default_left=rng.rand(L) < 0.5, is_categorical=is_cat,
        cat_mask=(rng.rand(L, Bcat) < 0.5) & is_cat[:, None], sel=sel,
        new_id=np.where(sel, n_live + np.cumsum(sel) - 1, 0).astype(
            np.int32))
    return bins_t, leaf2, tables, metas


CASES = {
    # 2,048 leaves: an early wave of 64 splits, and the last wave of
    # 1,024 with EFB-bundled and categorical leaves
    "2048-64": dict(seed=1, L=2048, n=6000, G=28, max_bin=63, n_live=64,
                    n_sel=64),
    "2048-1024-efb-cat": dict(seed=2, L=2048, n=6000, G=28, max_bin=63,
                              n_live=1024, n_sel=1024, cat_share=1 / 3),
    # the last wave of a 131,072-leaf tree: right children past 65,535
    "131072-efb-cat": dict(seed=3, L=131072, n=20000, G=8, max_bin=63,
                           n_live=65536, n_sel=65536, cat_share=1 / 3),
    # int32 bins past 70,000, 300 groups: thresholds, offsets, bin counts
    # and NaN bins past 65,535, group ids past 255, children past 65,535
    "131072-wide-fields": dict(seed=4, L=131072, n=8000, G=300,
                               max_bin=131072, n_live=65536, n_sel=40000,
                               cat_share=0.2, int32=True),
    # int32 bins at max_bin 70000 (a 131,072-bin stride), the headline's
    # 255 leaves
    "maxbin70000": dict(seed=5, L=255, n=20000, G=28, max_bin=70000,
                        n_live=127, n_sel=64, cat_share=1 / 3, int32=True),
}
