"""Binned dataset — a copy of the JAX package's ``io/dataset.py`` (which
imports no JAX), so both packages bin and bundle identically.

Counterpart of the reference data layer
(reference `include/LightGBM/dataset.h:280-578`, `src/io/dataset.cpp`):
the reference keeps per-feature-group ``Bin`` objects (dense / sparse /
4-bit / ordered variants) plus EFB bundling; here the whole training
matrix is ONE dense ``[num_rows, num_groups]`` int array (uint8 when
every group has <=256 bins), moved to the device by ``io/device.py``.
EFB utilities (`dataset.cpp:48-210` equivalents) live in this module.

``Metadata`` mirrors the reference Metadata (`dataset.h:36-248`): labels,
weights, query boundaries, init scores.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..utils.log import log_info, log_warning, check
from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                      MISSING_NONE, MISSING_ZERO, BinMapper)


@dataclass
class Metadata:
    """Per-row side data (reference include/LightGBM/dataset.h:36-248)."""
    label: Optional[np.ndarray] = None           # float32 [n]
    weight: Optional[np.ndarray] = None          # float32 [n]
    query_boundaries: Optional[np.ndarray] = None  # int32 [num_queries+1]
    init_score: Optional[np.ndarray] = None      # float64 [n * num_class]

    @property
    def num_data(self) -> int:
        return 0 if self.label is None else len(self.label)

    def set_field(self, name: str, data) -> None:
        if data is None:
            setattr(self, {"label": "label", "weight": "weight",
                           "group": "query_boundaries", "query": "query_boundaries",
                           "init_score": "init_score"}[name], None)
            return
        arr = np.asarray(data)
        if name == "label":
            self.label = np.ascontiguousarray(arr, dtype=np.float32)
        elif name == "weight":
            self.weight = np.ascontiguousarray(arr, dtype=np.float32)
        elif name in ("group", "query"):
            # accept either per-query sizes or boundaries
            arr = np.ascontiguousarray(arr, dtype=np.int32)
            if len(arr) > 0 and arr[0] == 0:
                self.query_boundaries = arr
            else:
                self.query_boundaries = np.concatenate(
                    [np.zeros(1, np.int32), np.cumsum(arr, dtype=np.int32)])
        elif name == "init_score":
            self.init_score = np.ascontiguousarray(arr, dtype=np.float64)
        else:
            raise ValueError(f"unknown field {name!r}")

    def get_field(self, name: str):
        if name == "label":
            return self.label
        if name == "weight":
            return self.weight
        if name in ("group", "query"):
            return self.query_boundaries
        if name == "init_score":
            return self.init_score
        raise ValueError(f"unknown field {name!r}")

    def check_or_partition(self, num_all_data: int, used_indices: Optional[np.ndarray]) -> None:
        """Subset side-data to used rows (reference dataset.h:82, metadata.cpp)."""
        if used_indices is None:
            return
        if self.label is not None and len(self.label) == num_all_data:
            self.label = self.label[used_indices]
        if self.weight is not None and len(self.weight) == num_all_data:
            self.weight = self.weight[used_indices]
        if self.init_score is not None and len(self.init_score) == num_all_data:
            self.init_score = self.init_score[used_indices]
        if self.query_boundaries is not None:
            self.query_boundaries = _subset_query_boundaries(
                self.query_boundaries, np.asarray(used_indices))


def _map_columns(fn, features: Sequence[int]) -> List[np.ndarray]:
    """``[fn(f) for f in features]`` on a thread per core."""
    workers = max(1, min(len(features), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, features))


def _subset_query_boundaries(boundaries: np.ndarray,
                             used_indices: np.ndarray) -> np.ndarray:
    """Rebuild query boundaries for a row subset.  Selected rows must keep
    whole queries contiguous (the reference rejects query-splitting
    partitions in Metadata::CheckOrPartition)."""
    qid = np.searchsorted(boundaries, used_indices, side="right") - 1
    if len(qid) and (np.diff(qid) < 0).any():
        raise ValueError("row subset reorders ranking queries")
    sizes = boundaries[1:] - boundaries[:-1]
    taken = np.bincount(qid, minlength=len(sizes))
    partial = (taken > 0) & (taken != sizes)
    if partial.any():
        raise ValueError(
            "row subset splits ranking queries; subset whole queries instead")
    kept_sizes = sizes[taken > 0]
    return np.concatenate([np.zeros(1, np.int32),
                           np.cumsum(kept_sizes, dtype=np.int32)])


# ---------------------------------------------------------------------------
# Exclusive Feature Bundling (reference src/io/dataset.cpp:48-210)
# ---------------------------------------------------------------------------
def _get_conflict_count(mark: np.ndarray, nonzero_rows: np.ndarray,
                        max_cnt: int) -> int:
    """Count rows where this feature and the bundle are both nonzero
    (reference ``GetConfilctCount`` dataset.cpp:48-59); -1 if over budget."""
    cnt = int(mark[nonzero_rows].sum())
    return cnt if cnt <= max_cnt else -1


def find_feature_groups(nonzero_indices: List[np.ndarray], num_rows: int,
                        max_conflict_rate: float,
                        random_order: Optional[np.ndarray] = None) -> List[List[int]]:
    """Greedy graph-coloring of features into low-conflict bundles
    (reference ``FindGroups`` dataset.cpp:66-136)."""
    num_features = len(nonzero_indices)
    order = random_order if random_order is not None else np.arange(num_features)
    group_marks: List[np.ndarray] = []
    group_counts: List[int] = []
    groups: List[List[int]] = []
    total_budget = int(max_conflict_rate * num_rows)
    for fidx in order:
        fidx = int(fidx)
        nz = nonzero_indices[fidx]
        placed = False
        for gid in range(len(groups)):
            rest = total_budget - group_counts[gid]
            cnt = _get_conflict_count(group_marks[gid], nz, rest)
            if cnt >= 0:
                groups[gid].append(fidx)
                group_counts[gid] += cnt
                group_marks[gid][nz] = True
                placed = True
                break
        if not placed:
            mark = np.zeros(num_rows, dtype=bool)
            mark[nz] = True
            groups.append([fidx])
            group_counts.append(0)
            group_marks.append(mark)
    return groups


def fast_feature_bundling(bins: np.ndarray, mappers: List[BinMapper],
                          max_conflict_rate: float, seed: int,
                          sparse_threshold: float = 0.8,
                          max_group_bins: int = 255) -> List[List[int]]:
    """EFB driver (reference ``FastFeatureBundling`` dataset.cpp:138-210):
    bundle sufficiently sparse features; try natural and shuffled orders and
    keep whichever yields fewer groups.  Dense features stay solo."""
    num_rows, num_features = bins.shape
    sparse_f = [f for f in range(num_features)
                if mappers[f].sparse_rate >= sparse_threshold
                and mappers[f].num_bin > 1]
    dense_f = [f for f in range(num_features) if f not in set(sparse_f)]
    if len(sparse_f) < 2:
        return [[f] for f in range(num_features)]
    sample = bins if num_rows <= 50000 else bins[
        np.random.RandomState(seed).choice(num_rows, 50000, replace=False)]
    nz = [np.nonzero(sample[:, f] != mappers[f].default_bin)[0] for f in sparse_f]
    g1 = find_feature_groups(nz, len(sample), max_conflict_rate)
    rng = np.random.RandomState(seed)
    g2 = find_feature_groups(nz, len(sample), max_conflict_rate,
                             rng.permutation(len(sparse_f)))
    best = g1 if len(g1) <= len(g2) else g2
    groups = [[sparse_f[i] for i in grp] for grp in best]
    # cap total bins per bundle
    capped: List[List[int]] = []
    for grp in groups:
        cur: List[int] = []
        cur_bins = 0
        for f in grp:
            nb = mappers[f].num_bin
            if cur and cur_bins + nb > max_group_bins:
                capped.append(cur)
                cur, cur_bins = [], 0
            cur.append(f)
            cur_bins += nb
        if cur:
            capped.append(cur)
    capped.extend([[f] for f in dense_f])
    return capped


def find_mappers_from_sample(sample: np.ndarray, config: Config,
                             cat_set) -> List[BinMapper]:
    """Quantile bin mappers from a sampled row block ``[S, F]``
    (reference FindBin over sampled values, `bin.cpp:72-206`; the
    sampling contract drops zeros for numerical features)."""
    def mapper(f: int) -> BinMapper:
        m = BinMapper()
        col = sample[:, f].astype(np.float64)
        bin_type = BIN_CATEGORICAL if f in cat_set else BIN_NUMERICAL
        if bin_type == BIN_NUMERICAL:
            nz = col[(col != 0.0) | np.isnan(col)]
            m.find_bin(nz, len(col), config.max_bin,
                       config.min_data_in_bin, bin_type=bin_type,
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
        else:
            m.find_bin(col[~np.isnan(col)], len(col), config.max_bin,
                       config.min_data_in_bin, bin_type=bin_type,
                       use_missing=config.use_missing,
                       zero_as_missing=config.zero_as_missing)
        return m
    return _map_columns(mapper, range(sample.shape[1]))


@dataclass
class BundleInfo:
    """EFB group layout (our own encoding, replacing the reference's
    FeatureGroup bin-offset bookkeeping, `feature_group.h:30-75`).

    A stored column holds one *group*.  Singleton groups store the
    feature's bins unchanged (``feat_offset == -1``).  A multi-feature
    group column encodes: 0 = every member at its default bin; else the
    single non-default member ``f`` with bin ``b`` as
    ``off_f + b - (1 if b > default_f else 0)`` — each member owns the
    disjoint range ``[off_f, off_f + num_bin_f - 2]`` and the shared bin 0
    replaces its default (bin 0 reserved for defaults, the
    `feature_group.h:35-36` convention).  Conflicting rows (two members
    non-default; bounded by ``max_conflict_rate``) keep the last member's
    value, like the reference's push-order overwrite.
    """
    groups: List[List[int]]        # logical used-feature ids per group
    feat_group: np.ndarray         # int32 [F] group column per feature
    feat_offset: np.ndarray        # int32 [F] offset in group (-1: identity)
    group_num_bins: np.ndarray     # int32 [G]

    @property
    def is_bundled(self) -> bool:
        return bool((self.feat_offset >= 0).any())


def build_bundle_info(groups: List[List[int]],
                      num_bins: np.ndarray) -> BundleInfo:
    F = int(num_bins.shape[0])
    feat_group = np.zeros(F, np.int32)
    feat_offset = np.full(F, -1, np.int32)
    gnb = np.zeros(len(groups), np.int32)
    for g, members in enumerate(groups):
        if len(members) == 1:
            f = members[0]
            feat_group[f] = g
            gnb[g] = num_bins[f]
            continue
        off = 1
        for f in members:
            feat_group[f] = g
            feat_offset[f] = off
            off += int(num_bins[f]) - 1
        gnb[g] = off
    return BundleInfo(groups=groups, feat_group=feat_group,
                      feat_offset=feat_offset, group_num_bins=gnb)


def pack_group_columns(cols: List[np.ndarray], info: "FeatureInfo",
                       bundle: BundleInfo) -> np.ndarray:
    """Encode per-feature bin columns into group columns (the EFB
    push path, reference ``FeatureGroup::PushData``)."""
    n = len(cols[0])
    G = len(bundle.groups)
    dtype = np.uint8 if bundle.group_num_bins.max() <= 256 else np.int32
    out = np.zeros((n, G), dtype=dtype)
    for g, members in enumerate(bundle.groups):
        if len(members) == 1:
            out[:, g] = cols[members[0]].astype(dtype)
            continue
        col = np.zeros(n, np.int32)
        for f in members:
            b = cols[f].astype(np.int32)
            db = int(info.default_bins[f])
            off = int(bundle.feat_offset[f])
            nz = b != db
            enc = off + b - (b > db)
            col[nz] = enc[nz]
        out[:, g] = col.astype(dtype)
    return out


# ---------------------------------------------------------------------------
@dataclass
class FeatureInfo:
    """Static per-column metadata shipped to the device as plain arrays."""
    num_bins: np.ndarray          # int32 [F] bins per feature (incl. NaN bin)
    bin_offsets: np.ndarray       # int32 [F+1] prefix sum of num_bins
    default_bins: np.ndarray      # int32 [F]
    missing_types: np.ndarray     # int32 [F]
    is_categorical: np.ndarray    # bool  [F]

    @property
    def total_bins(self) -> int:
        return int(self.bin_offsets[-1])

    @property
    def max_num_bins(self) -> int:
        return int(self.num_bins.max()) if len(self.num_bins) else 1


class BinnedDataset:
    """The constructed training dataset (reference Dataset, dataset.h:280-578).

    Host-side numpy; pushed to device by the learner.  ``used_features``
    maps stored columns back to original feature indices (mirroring the
    reference's used_feature_map in `dataset.h`) so model output refers to
    the caller's column numbering.
    """

    def __init__(self) -> None:
        self.bins: np.ndarray = np.zeros((0, 0), dtype=np.uint8)  # [n, G]
        self.mappers: List[BinMapper] = []          # per original feature
        self.feature_info: Optional[FeatureInfo] = None
        self.bundle: Optional[BundleInfo] = None    # EFB layout (None: 1:1)
        self.metadata = Metadata()
        self.num_total_features: int = 0
        self.used_features: List[int] = []          # original idx per used column
        self.feature_names: List[str] = []
        self.config: Optional[Config] = None

    # -- construction ---------------------------------------------------
    @classmethod
    def from_raw(cls, X: np.ndarray, config: Config,
                 categorical_features: Sequence[int] = (),
                 feature_names: Optional[Sequence[str]] = None,
                 reference: Optional["BinnedDataset"] = None,
                 metadata: Optional[Metadata] = None,
                 prediction_mode: bool = False,
                 mappers: Optional[List[BinMapper]] = None,
                 bundle_allgather=None, rank: int = 0) -> "BinnedDataset":
        """Sample→FindBin→bin all rows (reference DatasetLoader::LoadFromFile
        stages, dataset_loader.cpp:159-219 + 744-993)."""
        X = np.asarray(X)
        if X.dtype == np.object_:
            X = X.astype(np.float64)
        n, num_features = X.shape
        ds = cls()
        ds.config = config
        ds.num_total_features = num_features
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(num_features)])
        cat_set = set(int(c) for c in categorical_features)

        if reference is not None:
            # align bin mappers with reference dataset (used for valid sets;
            # reference LoadFromFileAlignWithOtherDataset dataset_loader.cpp:221)
            if num_features != reference.num_total_features:
                raise ValueError(
                    f"validation data has {num_features} features, train data "
                    f"has {reference.num_total_features}")
            ds.mappers = reference.mappers
            ds.used_features = reference.used_features
            ds.feature_info = reference.feature_info
            ds.feature_names = reference.feature_names
            # prediction mode: unbundled columns + sentinel categorical
            # miss bins (raw-value CategoricalDecision semantics)
            ds.bundle = None if prediction_mode else reference.bundle
            cols = []
            for f in ds.used_features:
                cols.append(ds.mappers[f].value_to_bin(
                    X[:, f], prediction_mode=prediction_mode))
            if ds.bundle is not None and ds.bundle.is_bundled:
                ds.bins = pack_group_columns(cols, ds.feature_info, ds.bundle)
            else:
                # prediction mode's categorical miss sentinel is num_bin,
                # which overflows uint8 when num_bin == 256
                force_wide = (prediction_mode
                              and ds.feature_info.max_num_bins >= 256)
                ds.bins = cls._pack_columns(cols, ds.feature_info,
                                            force_int32=force_wide)
            ds.metadata = metadata or Metadata()
            return ds

        # 1-2. sample + find bins per feature (skipped when precomputed
        # mappers are supplied — the distributed bin-finding path,
        # io/distributed.py)
        if mappers is not None:
            if len(mappers) != num_features:
                raise ValueError(
                    f"got {len(mappers)} mappers for {num_features} features")
            ds.mappers = mappers
            ds.used_features = [f for f in range(num_features)
                                if not mappers[f].is_trivial]
            # EFB with distributed ingest (VERDICT r2 #6): conflict rates
            # are rank-LOCAL, so rank 0's group proposal is broadcast
            # through the ingest collective and applied by every rank —
            # identical layouts, so data-parallel histogram collectives
            # sum matching columns.  Without a collective, bundling
            # stays off (different layouts would corrupt the psum).
            return cls._finish_from_mappers(ds, X, config, metadata, n,
                                            num_features,
                                            allow_bundle=(
                                                bundle_allgather is not None),
                                            bundle_allgather=bundle_allgather,
                                            rank=rank)
        sample_cnt = min(n, config.bin_construct_sample_cnt)
        rng = np.random.RandomState(config.data_random_seed)
        sample_idx = (np.arange(n) if sample_cnt >= n
                      else np.sort(rng.choice(n, sample_cnt, replace=False)))
        ds.mappers = find_mappers_from_sample(X[sample_idx], config, cat_set)
        ds.used_features = [f for f in range(num_features)
                            if not ds.mappers[f].is_trivial]
        return cls._finish_from_mappers(ds, X, config, metadata, n,
                                        num_features)

    @classmethod
    def _finish_from_mappers(cls, ds: "BinnedDataset", X: np.ndarray,
                             config: Config, metadata: Optional[Metadata],
                             n: int, num_features: int,
                             allow_bundle: bool = True,
                             bundle_allgather=None,
                             rank: int = 0,
                             cols: Optional[List[np.ndarray]] = None,
                             packed: Optional[np.ndarray] = None
                             ) -> "BinnedDataset":
        """Steps 3-4 of construction: bin all rows through ``ds.mappers``,
        apply EFB, pack columns (shared by the local and distributed
        bin-finding paths).  With ``bundle_allgather``, rank 0's group
        proposal is broadcast so every rank bundles identically (the
        mod-rank row shuffle makes rank 0's conflict estimate unbiased).
        ``cols`` supplies PRE-binned per-used-feature columns (the
        two-round loader bins chunk-by-chunk and never holds raw X —
        its ``X`` argument is then an empty placeholder)."""
        mappers = ds.mappers
        if not ds.used_features:
            log_warning("all features are trivial (constant); nothing to train on")
        # 3. bin every row (vectorized per column, on a thread per core:
        #    numpy releases the GIL in the searches)
        if cols is None:
            cols = _map_columns(lambda f: mappers[f].value_to_bin(X[:, f]),
                                ds.used_features)
        ds.feature_info = cls._build_feature_info(
            [mappers[f] for f in ds.used_features])
        # 4. EFB: bundle sufficiently sparse features into shared columns
        #    (reference FastFeatureBundling, dataset.cpp:138-210)
        ds.bundle = None
        used_mappers = [mappers[f] for f in ds.used_features]
        # (feature-parallel composes since r4: each shard gathers its
        # features' group columns — reference bundles identically on
        # every rank for all learner types, dataset.cpp:138-210)
        if (allow_bundle and config.enable_bundle
                and len(ds.used_features) >= 2):
            n_sparse = sum(m.sparse_rate >= config.sparse_threshold
                           and m.num_bin > 1 for m in used_mappers)
            if n_sparse >= 2:
                if bundle_allgather is None or rank == 0:
                    feat_matrix = cls._pack_columns(cols, ds.feature_info)
                    groups = fast_feature_bundling(
                        feat_matrix, used_mappers, config.max_conflict_rate,
                        config.data_random_seed, config.sparse_threshold,
                        max_group_bins=256)
                else:
                    groups = None      # rank 0's proposal arrives below
                if bundle_allgather is not None:
                    # every eligible rank reaches this collective (the
                    # gates above depend only on the shared mappers)
                    proposals = bundle_allgather(
                        [[int(f) for f in grp] for grp in groups]
                        if groups is not None else None)
                    groups = [[int(f) for f in grp] for grp in proposals[0]]
                if len(groups) < len(ds.used_features):
                    ds.bundle = build_bundle_info(
                        groups, ds.feature_info.num_bins)
        if ds.bundle is not None and ds.bundle.is_bundled:
            ds.bins = pack_group_columns(cols, ds.feature_info, ds.bundle)
            log_info(f"EFB bundled {len(ds.used_features)} features into "
                     f"{ds.bins.shape[1]} groups")
        else:
            ds.bundle = None
            # `packed` (two-round loader): cols are views of an already
            # correctly-packed matrix — adopt it, don't copy
            ds.bins = (packed if packed is not None
                       else cls._pack_columns(cols, ds.feature_info))
        ds.metadata = metadata or Metadata()
        log_info(f"constructed dataset: {n} rows, "
                 f"{len(ds.used_features)}/{num_features} used features, "
                 f"{ds.feature_info.total_bins} total bins")
        return ds

    @staticmethod
    def _build_feature_info(mappers: Sequence[BinMapper]) -> FeatureInfo:
        num_bins = np.asarray([m.num_bin for m in mappers], dtype=np.int32)
        offsets = np.concatenate([np.zeros(1, np.int32),
                                  np.cumsum(num_bins, dtype=np.int32)])
        return FeatureInfo(
            num_bins=num_bins,
            bin_offsets=offsets,
            default_bins=np.asarray([m.default_bin for m in mappers], np.int32),
            missing_types=np.asarray([m.missing_type for m in mappers], np.int32),
            is_categorical=np.asarray(
                [m.bin_type == BIN_CATEGORICAL for m in mappers], bool),
        )

    @staticmethod
    def _pack_columns(cols: List[np.ndarray], info: FeatureInfo,
                      force_int32: bool = False) -> np.ndarray:
        if not cols:
            return np.zeros((0, 0), dtype=np.uint8)
        dtype = (np.int32 if force_int32 or info.max_num_bins > 256
                 else np.uint8)
        out = np.empty((len(cols[0]), len(cols)), dtype=dtype)
        for j, c in enumerate(cols):
            out[:, j] = c.astype(dtype)
        return out

    # -- views / accessors ----------------------------------------------
    @property
    def num_data(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        return self.bins.shape[1]

    def create_valid(self, X: np.ndarray, metadata: Optional[Metadata] = None,
                     prediction_mode: bool = False) -> "BinnedDataset":
        """Bin a validation matrix with THIS dataset's mappers
        (reference Dataset::CreateValid, dataset.h:398).

        ``prediction_mode`` produces an unbundled matrix with sentinel
        categorical miss bins — use for predict paths, not valid-set
        training eval."""
        return BinnedDataset.from_raw(np.asarray(X), self.config,
                                      reference=self, metadata=metadata,
                                      prediction_mode=prediction_mode)

    def subset(self, used_indices: np.ndarray) -> "BinnedDataset":
        """Row subset copy (reference CopySubset dataset.h:375)."""
        used_indices = np.asarray(used_indices, dtype=np.int64)
        out = BinnedDataset()
        out.bins = self.bins[used_indices]
        out.mappers = self.mappers
        out.feature_info = self.feature_info
        out.bundle = self.bundle
        out.num_total_features = self.num_total_features
        out.used_features = self.used_features
        out.feature_names = self.feature_names
        out.config = self.config
        md = Metadata()
        if self.metadata.label is not None:
            md.label = self.metadata.label[used_indices]
        if self.metadata.weight is not None:
            md.weight = self.metadata.weight[used_indices]
        if self.metadata.init_score is not None:
            md.init_score = self.metadata.init_score[used_indices]
        if self.metadata.query_boundaries is not None:
            md.query_boundaries = _subset_query_boundaries(
                self.metadata.query_boundaries, used_indices)
        out.metadata = md
        return out

    # -- binary serialization (reference SaveBinaryFile dataset.h:394) ---
    def save_binary(self, path: str) -> None:
        meta = {
            "version": 1,
            "num_total_features": self.num_total_features,
            "used_features": self.used_features,
            "feature_names": self.feature_names,
            "mappers": [m.to_dict() for m in self.mappers],
            "groups": (self.bundle.groups if self.bundle is not None
                       else None),
        }
        np.savez_compressed(
            path, header=json.dumps(meta).encode(),
            bins=self.bins,
            label=self.metadata.label if self.metadata.label is not None else np.zeros(0, np.float32),
            weight=self.metadata.weight if self.metadata.weight is not None else np.zeros(0, np.float32),
            query=self.metadata.query_boundaries if self.metadata.query_boundaries is not None else np.zeros(0, np.int32),
            init_score=self.metadata.init_score if self.metadata.init_score is not None else np.zeros(0, np.float64),
        )

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        meta = json.loads(bytes(z["header"]).decode())
        ds = cls()
        ds.num_total_features = meta["num_total_features"]
        ds.used_features = list(meta["used_features"])
        ds.feature_names = list(meta["feature_names"])
        ds.mappers = [BinMapper.from_dict(d) for d in meta["mappers"]]
        ds.feature_info = cls._build_feature_info(
            [ds.mappers[f] for f in ds.used_features])
        if meta.get("groups"):
            ds.bundle = build_bundle_info(
                [list(g) for g in meta["groups"]], ds.feature_info.num_bins)
        ds.bins = z["bins"]
        md = Metadata()
        if len(z["label"]):
            md.label = z["label"]
        if len(z["weight"]):
            md.weight = z["weight"]
        if len(z["query"]):
            md.query_boundaries = z["query"]
        if len(z["init_score"]):
            md.init_score = z["init_score"]
        ds.metadata = md
        return ds
