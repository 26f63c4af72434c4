"""Device-resident dataset: the binned matrix + static feature metadata.

Counterpart of the JAX package's ``io/device.py``: the binned matrix
(G = EFB group columns; G == F when nothing bundles) plus flat
per-feature metadata tensors, all on one ``torch.device``.  The device
holds the bins only TRANSPOSED (``bins_t`` ``[G, n_pad]``, rows
contiguous per column so neighbouring threads read neighbouring bytes),
which is what every kernel reads; the transpose is made once, on the
host, here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .binning import MISSING_NAN
from .dataset import BinnedDataset

# rows are padded to a multiple of this (the JAX package's DEFAULT_ROW_TILE),
# so the port's [2, n_pad] leaf vectors have the reference's shapes
ROW_TILE = 2048


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class DeviceData:
    """Training data on one device (tensors + static ints).

    Feature-indexed tensors describe the F *logical* features; ``bins``
    holds the G stored group columns; ``feat_group``/``feat_offset`` map
    logical features into group columns (`io/dataset.py` BundleInfo
    encoding, offset -1 = identity).
    """
    bins_t: torch.Tensor         # [G, n_pad] uint8 group columns, padding 0
    num_data: int                # n real rows (bins_t[:, n:] is padding)
    bin_offsets: torch.Tensor    # [F] int32 offsets into flat bin space
    num_bins: torch.Tensor       # [F] int32 (includes NaN bin)
    default_bins: torch.Tensor   # [F] int32 (bin of value 0.0)
    missing_types: torch.Tensor  # [F] int32
    is_categorical: torch.Tensor  # [F] bool
    nan_bins: torch.Tensor       # [F] int32 (num_bins-1 where NaN else -1)
    feat_group: torch.Tensor     # [F] int32 group column per feature
    feat_offset: torch.Tensor    # [F] int32 offset in group (-1: identity)
    total_bins: int
    max_bins: int                # max per-FEATURE bins
    has_categorical: bool = False
    max_group_bins: int = 0      # max per-GROUP bins (0 -> max_bins)
    is_bundled: bool = False
    has_missing: bool = True

    @property
    def device(self) -> torch.device:
        return self.bins_t.device

    @property
    def n_pad(self) -> int:
        return self.bins_t.shape[1]

    @property
    def num_features(self) -> int:
        return self.num_bins.shape[0]

    @property
    def num_groups(self) -> int:
        return self.bins_t.shape[0]

    @property
    def group_max_bins(self) -> int:
        return self.max_group_bins or self.max_bins


def feature_meta_np(ds: BinnedDataset) -> dict:
    """Per-feature metadata of :func:`to_device` as host numpy plus the
    static fields (the same dictionary the JAX package's
    ``feature_meta_np`` builds)."""
    info = ds.feature_info
    nan_bins = np.where(info.missing_types == MISSING_NAN,
                        info.num_bins - 1, -1).astype(np.int32)
    F = len(info.num_bins)
    if ds.bundle is not None:
        feat_group = ds.bundle.feat_group
        feat_offset = ds.bundle.feat_offset
        max_group_bins = int(ds.bundle.group_num_bins.max())
        is_bundled = bool(ds.bundle.is_bundled)
    else:
        feat_group = np.arange(F, dtype=np.int32)
        feat_offset = np.full(F, -1, np.int32)
        max_group_bins = int(info.max_num_bins)
        is_bundled = False
    return dict(
        bin_offsets=np.asarray(info.bin_offsets[:-1], np.int32),
        num_bins=np.asarray(info.num_bins, np.int32),
        default_bins=np.asarray(info.default_bins, np.int32),
        missing_types=np.asarray(info.missing_types, np.int32),
        is_categorical=np.asarray(info.is_categorical),
        nan_bins=nan_bins,
        feat_group=np.asarray(feat_group, np.int32),
        feat_offset=np.asarray(feat_offset, np.int32),
        total_bins=int(info.total_bins),
        max_bins=int(info.max_num_bins),
        has_categorical=bool(info.is_categorical.any()),
        max_group_bins=max_group_bins,
        is_bundled=is_bundled,
        has_missing=bool((info.missing_types != 0).any()),
    )


_META_TENSORS = ("bin_offsets", "num_bins", "default_bins", "missing_types",
                 "is_categorical", "nan_bins", "feat_group", "feat_offset")


def device_data_from_arrays(bins: np.ndarray, meta: dict,
                            device) -> DeviceData:
    """Build :class:`DeviceData` from host ``[n, G]`` bins and a
    :func:`feature_meta_np`-shaped dictionary."""
    device = torch.device(device)
    if meta["has_categorical"]:
        raise NotImplementedError(
            "categorical features are not supported by lightgbm_tpu_torch "
            "yet")
    bins = np.ascontiguousarray(bins)
    if bins.dtype != np.uint8:
        raise NotImplementedError(
            "the kernels read uint8 bins: groups with more than 256 bins "
            "are not supported yet")
    n, G = bins.shape
    n_pad = round_up(max(n, 1), ROW_TILE)
    bins_t = np.zeros((G, n_pad), np.uint8)
    bins_t[:, :n] = bins.T
    tensors = {k: torch.as_tensor(np.asarray(meta[k]), device=device)
               for k in _META_TENSORS}
    return DeviceData(
        bins_t=torch.as_tensor(bins_t, device=device),
        num_data=n,
        total_bins=int(meta["total_bins"]),
        max_bins=int(meta["max_bins"]),
        has_categorical=bool(meta["has_categorical"]),
        max_group_bins=int(meta["max_group_bins"]),
        is_bundled=bool(meta["is_bundled"]),
        has_missing=bool(meta["has_missing"]),
        **tensors)


def to_device(ds: BinnedDataset, device) -> DeviceData:
    return device_data_from_arrays(ds.bins, feature_meta_np(ds), device)
