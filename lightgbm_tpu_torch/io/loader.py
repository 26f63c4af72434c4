"""Text dataset loading: CSV, TSV and libsvm files with their side files
(a copy of the JAX package's ``io/loader.py``, under its function
names).

Counterpart of the reference ``DatasetLoader`` + ``Parser``
(``src/io/dataset_loader.cpp:159-219``, ``src/io/parser.cpp``): format
detection, ``label_column`` / ``weight_column`` / ``group_column`` /
``ignore_column`` / ``categorical_column`` (an index ``N`` or
``name:<column>``, with ``has_header``), the side files ``.weight``,
``.query`` and ``.init`` (``src/io/metadata.cpp``), the ``.bin.npz``
binary cache (``BinnedDataset.save_binary`` / ``load_binary``), and
two-round loading (``use_two_round_loading``: bounded chunks of the
native parser, binned chunk by chunk, so the raw float64 matrix never
exists).  Values are parsed into float64 and stay float64 up to
binning, so a model trained from a file equals one trained from the
same array.  Parsing runs through the native parser (``native/``);
without it, through numpy.  The shard store's ingest
(``io/outofcore.py``) shares the format detection, the row count and
the column plan.  Distributed loading (``num_machines > 1`` with an
``allgather`` collective, ``io/distributed.py``): each rank keeps its
mod-rank rows (every row under ``is_pre_partition``, where each rank
reads its own file), and the bin mappers are found feature-sharded over
the ranks' local rows and allgathered, so every rank bins identically
(reference ``dataset_loader.cpp:639-742``, ``:816-880``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..config import Config
from ..utils.file_io import localize, release
from ..utils.log import log_info, log_warning
from .dataset import BinnedDataset, Metadata, find_mappers_from_sample


def detect_format(path: str, has_header: bool) -> str:
    """CSV vs TSV vs LibSVM auto-detection (reference
    ``Parser::CreateParser`` format sniffing)."""
    with open(path) as f:
        lines = []
        for _ in range(32):
            ln = f.readline()
            if not ln:
                break
            lines.append(ln.rstrip("\n"))
    if has_header and lines:
        lines = lines[1:]
    if not lines:
        return "csv"
    sample = lines[0]
    if ":" in sample.split(",")[0].split("\t")[0].split(" ")[-1] \
            and any(":" in tok for tok in sample.split()[1:2]):
        return "libsvm"
    n_tab = sample.count("\t")
    n_comma = sample.count(",")
    if any(":" in tok for tok in sample.split()[1:]):
        return "libsvm"
    if n_tab >= n_comma and n_tab > 0:
        return "tsv"
    if n_comma > 0:
        return "csv"
    if " " in sample:
        return "libsvm" if ":" in sample else "tsv"
    return "csv"


def _parse_column_spec(spec: str, header_names: Optional[List[str]]) -> int:
    """Column spec: integer index or ``name:colname``."""
    if spec.startswith("name:"):
        name = spec[5:]
        if not header_names:
            raise ValueError(f"column {spec!r} needs a header")
        return header_names.index(name)
    return int(spec)


def _parse_multi_spec(spec: str, header_names) -> List[int]:
    if not spec:
        return []
    if spec.startswith("name:"):
        names = spec[5:].split(",")
        return [header_names.index(n) for n in names]
    return [int(s) for s in spec.replace(";", ",").split(",") if s != ""]


def _column_plan(ncol: int, config: Config, header_names):
    """Row-independent column bookkeeping of a delimited file: -> (label
    index, weight index, group index, kept columns, feature names,
    categorical columns among the kept ones)."""
    label_idx = (_parse_column_spec(config.label_column, header_names)
                 if config.label_column else 0)
    drop = {label_idx}
    weight_idx = query_idx = None
    if config.weight_column:
        weight_idx = _parse_column_spec(config.weight_column, header_names)
        drop.add(weight_idx)
    if config.group_column:
        query_idx = _parse_column_spec(config.group_column, header_names)
        drop.add(query_idx)
    for ig in _parse_multi_spec(config.ignore_column, header_names):
        drop.add(ig)
    keep = [i for i in range(ncol) if i not in drop]
    if header_names:
        names = [header_names[i] for i in keep]
    else:
        names = [f"Column_{i}" for i in range(len(keep))]
    cat_cols = []
    if config.categorical_column:
        cat_orig = _parse_multi_spec(config.categorical_column, header_names)
        remap = {orig: j for j, orig in enumerate(keep)}
        cat_cols = [remap[c] for c in cat_orig if c in remap]
    return label_idx, weight_idx, query_idx, keep, names, cat_cols


def raw_data_row_count(path: str, skip: int) -> int:
    """Data row count by a raw byte scan (no parsing; bounded reads).
    Blank lines are not rows: the chunk parser skips them, and the
    ingest's global sample indices need every file's exact count before
    any file is parsed."""
    n = 0
    pending = False      # the current line has non-whitespace content
    with open(path, "rb") as f:
        while True:
            chunk = f.read(4 << 20)
            if not chunk:
                break
            filtered = chunk.translate(None, delete=b"\r \t")
            arr = np.frombuffer(filtered, np.uint8)
            nls = np.flatnonzero(arr == 10)
            if len(nls):
                gaps = np.diff(np.concatenate([[-1], nls])) > 1
                if nls[0] == 0 and pending:
                    gaps[0] = True   # a line continued from the prior chunk
                n += int(gaps.sum())
                pending = bool(len(arr) - 1 - nls[-1] > 0)
            else:
                pending = pending or len(arr) > 0
    if pending:
        n += 1                      # an unterminated final line
    return n - skip


def parse_file(path: str, config: Config
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                          Optional[np.ndarray], List[str], List[int]]:
    """-> (X float64, label float32, inline weight, inline query ids,
    feature names, categorical columns among X's)."""
    from ..obs import span
    with span("io.parse_file", path=os.path.basename(path)):
        return _parse_file(path, config)


def _parse_file(path: str, config: Config):
    from ..utils.faults import fault_point
    from ..utils.retry import retry_call

    def _localize(p):
        # the ``loader.read`` fault point and a retried fetch: a flaky
        # remote filesystem read is a transient, not a lost run
        fault_point("loader.read")
        return localize(p)

    # a registered scheme -> a temp copy
    path = retry_call(_localize, path, what="loader.read")
    fmt = detect_format(path, config.has_header)
    header_names: Optional[List[str]] = None
    skip = 0
    if config.has_header:
        with open(path) as f:
            first = f.readline().rstrip("\n")
        sep = {"csv": ",", "tsv": "\t", "libsvm": " "}[fmt]
        header_names = first.split(sep)
        skip = 1

    weight_inline = None
    query_inline = None
    if fmt == "libsvm":
        got = native.parse_libsvm(path, skip)
        X, label = got if got is not None else _parse_libsvm(path, skip)
        feature_names = [f"Column_{i}" for i in range(X.shape[1])]
        cat_cols: List[int] = []
    else:
        sep = "," if fmt == "csv" else "\t"
        raw = native.parse_delimited(path, sep, skip)
        if raw is None:
            raw = np.genfromtxt(path, delimiter=sep, skip_header=skip,
                                dtype=np.float64)
        if raw.ndim == 1:
            raw = raw.reshape(-1, 1)
        label_idx, weight_idx, query_idx, keep, feature_names, cat_cols = \
            _column_plan(raw.shape[1], config, header_names)
        if weight_idx is not None:
            weight_inline = raw[:, weight_idx].astype(np.float32)
        if query_idx is not None:
            query_inline = raw[:, query_idx]
        label = raw[:, label_idx].astype(np.float32)
        X = raw[:, keep]
    release(path)                      # free a localized copy now
    return X, label, weight_inline, query_inline, feature_names, cat_cols


def _parse_libsvm(path: str, skip: int) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy path of a libsvm file: ``(X [rows, max index + 1]
    float64, labels float32)``; absent entries are 0."""
    labels: List[float] = []
    rows: List[List[Tuple[int, float]]] = []
    max_idx = -1
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip:
                continue
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            labels.append(float(toks[0]))
            feats = []
            for tok in toks[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                idx = int(k)
                feats.append((idx, float(v)))
                max_idx = max(max_idx, idx)
            rows.append(feats)
    X = np.zeros((len(rows), max_idx + 1), np.float64)
    for r, feats in enumerate(rows):
        for idx, v in feats:
            X[r, idx] = v
    return X, np.asarray(labels, np.float32)


def load_file_two_round(path: str, config: Config, rank: int = 0,
                        num_machines: int = 1,
                        allgather=None) -> BinnedDataset:
    """Two-round low-memory ingest (reference ``dataset_loader.cpp:698-742``
    + ``utils/pipeline_reader.h:26+``) through the native chunk parser:
    round 1 streams bounded chunks and keeps the bin-finding sample (the
    row count from a raw scan, so the sample indices are the in-memory
    path's draw and the mappers are byte-identical); round 2 streams
    again and bins each chunk straight into the column store.  Peak
    memory is the binned matrix plus one chunk.  libsvm chunks arrive
    as ``[rows, 1 + F]``, the label in column 0, so the delimited column
    plan applies unchanged.

    Distributed (``num_machines > 1``): this rank keeps global rows
    ``r = rank (mod num_machines)`` of the same chunk stream (all rows
    under ``is_pre_partition``), the bin-finding sample is drawn over the
    local rows with the per-rank RNG of :func:`find_bins_distributed`,
    and the sampled rows feed its feature-sharded mapper allgather, so
    every rank bins identically."""
    path = localize(path)
    S = max(1, num_machines)
    # pre-partition: each rank has its own file, and keeps every row
    stride = 1 if (S > 1 and config.is_pre_partition) else S
    fmt = detect_format(path, config.has_header)
    header_names = None
    skip = 1 if config.has_header else 0
    chunk_bytes = 4 << 20              # about 4 MB of text per chunk
    if fmt == "libsvm":
        scanned = native.scan_libsvm(path, skip)
        if scanned is None:
            raise ValueError("native libsvm scan failed")
        n, fcols = scanned
        if S > 1:
            # every rank bins against the same column count
            fcols = max(int(c) for c in allgather(int(fcols)))

        def chunk_stream():
            return native.parse_libsvm_chunks(path, skip, fcols,
                                              chunk_bytes=chunk_bytes)
    else:
        sep = {"csv": ",", "tsv": "\t"}[fmt]
        if config.has_header:
            with open(path) as f:
                header_names = f.readline().rstrip("\n").split(sep)
        n = raw_data_row_count(path, skip)

        def chunk_stream():
            return native.parse_delimited_chunks(path, sep, skip,
                                                 chunk_bytes=chunk_bytes)
    if n <= 0:
        raise ValueError(f"no data rows in {path!r}")
    n_full = n
    if config.group_column and stride > 1:
        raise ValueError(_SPLIT_QUERIES)
    # this rank's rows: global rows rank, rank + stride, ...
    local_n = len(range(rank % stride if stride > 1 else 0, n, stride))
    if S == 1:
        sample_cnt = min(n, config.bin_construct_sample_cnt)
        rng = np.random.RandomState(config.data_random_seed)
        sample_idx = (np.arange(n) if sample_cnt >= n
                      else np.sort(rng.choice(n, sample_cnt, replace=False)))
    else:
        # find_bins_distributed's own draw over the local rows
        sample_cnt = min(local_n, config.bin_construct_sample_cnt)
        rng = np.random.RandomState(config.data_random_seed + rank)
        local_sample = (np.arange(local_n) if sample_cnt >= local_n
                        else np.sort(rng.choice(local_n, sample_cnt,
                                                replace=False)))
        sample_idx = (local_sample if stride == 1
                      else rank + local_sample * stride)

    # round 1: stream the chunks, keep only the sampled rows
    sample_rows = []
    base = 0
    plan = None
    for chunk in chunk_stream():
        if plan is None:
            plan = _column_plan(chunk.shape[1], config, header_names)
        lo = np.searchsorted(sample_idx, base)
        hi = np.searchsorted(sample_idx, base + len(chunk))
        if hi > lo:
            sample_rows.append(chunk[sample_idx[lo:hi] - base])
        base += len(chunk)
    if base != n:
        raise ValueError(
            f"chunked parse saw {base} rows, raw scan counted {n}")
    label_idx, weight_idx, query_idx, keep, names, cat_cols = plan
    if query_idx is not None and stride > 1:
        raise ValueError(_SPLIT_QUERIES)
    sample = np.concatenate(sample_rows)[:, keep]
    if S > 1:
        from .distributed import find_bins_distributed
        mappers = find_bins_distributed(sample, config, rank, S, allgather,
                                        cat_cols)
        if len(mappers) < sample.shape[1]:
            keep = keep[:len(mappers)]
            names = names[:len(mappers)]
            cat_cols = [c for c in cat_cols if c < len(mappers)]
    else:
        mappers = find_mappers_from_sample(sample, config, set(cat_cols))
    del sample, sample_rows
    used = [f for f in range(len(keep)) if not mappers[f].is_trivial]

    # round 2: bin each chunk into the column store, in the dtype
    # _pack_columns would choose, so an unbundled matrix is adopted as is
    max_nb = max((mappers[f].num_bin for f in used), default=2)
    prebinned = np.zeros((local_n, len(used)),
                         np.uint8 if max_nb <= 256 else np.int32)
    label = np.zeros(local_n, np.float32)
    weight = (np.zeros(local_n, np.float32) if weight_idx is not None
              else None)
    query = np.zeros(local_n, np.float64) if query_idx is not None else None
    base = 0       # global row index at the chunk's start
    lbase = 0      # this rank's rows written so far
    for chunk in chunk_stream():
        if stride > 1:
            chunk_loc = chunk[np.arange(-(base - rank) % stride, len(chunk),
                                        stride)]
        else:
            chunk_loc = chunk
        m = len(chunk_loc)
        label[lbase:lbase + m] = chunk_loc[:, label_idx]
        if weight is not None:
            weight[lbase:lbase + m] = chunk_loc[:, weight_idx]
        if query is not None:
            query[lbase:lbase + m] = chunk_loc[:, query_idx]
        for j, f in enumerate(used):
            prebinned[lbase:lbase + m, j] = mappers[f].value_to_bin(
                chunk_loc[:, keep[f]])
        base += len(chunk)
        lbase += m
    if lbase != local_n:
        raise ValueError(f"sharded chunk stream yielded {lbase} rows, "
                         f"expected {local_n}")
    n = local_n
    release(path)

    md = Metadata()
    md.set_field("label", label)
    if weight is not None:
        md.set_field("weight", weight)
    if query is not None:
        md.query_boundaries = _query_boundaries(query)
    ds = BinnedDataset()
    ds.config = config
    ds.num_total_features = len(keep)
    ds.feature_names = names
    ds.mappers = mappers
    ds.used_features = used
    cols = [prebinned[:, j] for j in range(len(used))]
    ds = BinnedDataset._finish_from_mappers(
        ds, np.zeros((n, 0)), config, md, n, len(keep), cols=cols,
        packed=prebinned, allow_bundle=(S == 1 or allgather is not None),
        bundle_allgather=(allgather if S > 1 else None), rank=rank)
    ds._global_rows = n_full    # the row count before sharding
    log_info(f"two-round loading: {n} rows streamed"
             + (f" (rank {rank}/{S})" if S > 1 else "")
             + ", peak holds the binned store only")
    return ds


def _query_boundaries(query_ids: np.ndarray) -> np.ndarray:
    """A group column: consecutive equal ids form one query."""
    change = np.nonzero(np.diff(query_ids))[0] + 1
    return np.concatenate([[0], change, [len(query_ids)]]).astype(np.int32)


def load_raw_matrix(path: str, has_header: bool = False
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A prediction input file -> ``(X, label or None)``, with the
    training files' format detection and label column (reference
    ``predictor.hpp:115+`` reuses the training parser, so column 0 or
    the libsvm label is not a feature)."""
    cfg = Config.from_params({"has_header": has_header})
    X, label, _, _, _, _ = parse_file(path, cfg)
    return X, label


def _load_side_file(path: str, dtype=np.float32) -> Optional[np.ndarray]:
    """A side file's values, flat, or None when there is none."""
    try:
        local = localize(path)
    except FileNotFoundError:
        return None
    if not os.path.exists(local):
        return None
    try:
        return np.loadtxt(local, dtype=dtype).reshape(-1)
    finally:
        release(local)


def load_file(path: str, config: Config,
              reference: Optional[BinnedDataset] = None,
              rank: int = 0, num_machines: int = 1,
              allgather=None) -> BinnedDataset:
    """A text file -> ``BinnedDataset`` (reference
    ``DatasetLoader::LoadFromFile``, ``dataset_loader.cpp:159-219``):
    the binary cache ``<path>.bin.npz`` when it is newer than the file
    (``enable_load_from_binary_file``), two-round loading when asked
    for, else a whole parse; then the side files, and binning (with
    ``reference``'s mappers for a valid set).  ``is_save_binary_file``
    writes the cache.  With ``num_machines > 1`` and an ``allgather``
    collective (``io/distributed.py``), this rank keeps its mod-rank rows
    (every row under ``is_pre_partition``) and bin finding runs
    distributed: feature-sharded over the ranks' local rows, the mappers
    allgathered so every rank bins identically (``dataset_loader.cpp:
    816-880``)."""
    from ..obs import span
    with span("io.load_file", path=os.path.basename(path)):
        return _load_file(path, config, reference, rank, num_machines,
                          allgather)


def _side_files(path: str, md: Metadata) -> None:
    """``.weight``, ``.init`` and ``.query`` beside ``path`` into
    ``md`` (reference ``metadata.cpp`` LoadWeights / LoadInitialScore /
    LoadQueryBoundaries)."""
    w = _load_side_file(path + ".weight")
    if w is not None:
        md.set_field("weight", w)
    init = _load_side_file(path + ".init", np.float64)
    if init is not None:
        md.set_field("init_score", init)
    q = _load_side_file(path + ".query", np.int64)
    if q is not None:
        md.set_field("group", q.astype(np.int32))


_SPLIT_QUERIES = ("mod-rank row sharding would split ranking queries; use "
                  "is_pre_partition=true with per-rank files (reference "
                  "dataset_loader.cpp:639-742 contract)")


def _shard_side_files(path: str, md: Metadata, n_full: int, rank: int,
                      num_machines: int) -> None:
    """The side files of a mod-rank shard: ``.weight`` and ``.init``
    (class-major ``[n_full * K]``) sliced to this rank's rows; a
    ``.query`` file raises (sharding would split queries)."""
    sel = np.arange(rank, n_full, num_machines)
    w = _load_side_file(path + ".weight")
    if w is not None:
        md.set_field("weight", w[sel])
    init = _load_side_file(path + ".init", np.float64)
    if init is not None:
        K = max(1, len(init) // n_full)
        md.set_field("init_score", np.concatenate(
            [init[k * n_full + sel] for k in range(K)]))
    if _load_side_file(path + ".query", np.int64) is not None:
        raise ValueError(_SPLIT_QUERIES)


def _load_file(path: str, config: Config,
               reference: Optional[BinnedDataset], rank: int = 0,
               num_machines: int = 1, allgather=None) -> BinnedDataset:
    bin_path = path + ".bin.npz"
    is_local = "://" not in path
    distributed = num_machines > 1 and allgather is not None
    # the cache holds what one process binned: single machine only
    if (config.enable_load_from_binary_file and reference is None
            and num_machines == 1 and is_local and os.path.exists(bin_path)
            and os.path.getmtime(bin_path) >= os.path.getmtime(path)):
        log_info(f"loading binary cache {bin_path}")
        return BinnedDataset.load_binary(bin_path)
    # mod-rank rows (pre-partition: this rank's own file, every row);
    # without a collective the mappers come from the local rows alone
    sharded = num_machines > 1 and not config.is_pre_partition

    if config.use_two_round_loading:
        if reference is not None or (num_machines > 1 and allgather is None):
            log_warning("use_two_round_loading is ignored for aligned "
                        "valid sets (and distributed loading without a "
                        "collective); using the in-memory path")
        elif native.available():
            local = localize(path)
            try:
                ds = load_file_two_round(local, config, rank=rank,
                                         num_machines=num_machines,
                                         allgather=allgather)
            finally:
                release(local)
            if sharded:
                _shard_side_files(path, ds.metadata, ds._global_rows, rank,
                                  num_machines)
            else:
                _side_files(path, ds.metadata)
            if config.is_save_binary_file and is_local:
                ds.save_binary(bin_path[:-4])
                log_info(f"saved binary cache {bin_path}")
            return ds
        else:
            log_warning("use_two_round_loading needs the native parser; "
                        "falling back to in-memory loading")

    X, label, weight, query_inline, feature_names, cat_cols = \
        parse_file(path, config)
    md = Metadata()
    if sharded:
        if query_inline is not None:
            raise ValueError(_SPLIT_QUERIES)
        n_full = len(X)
        sel = np.arange(rank, n_full, num_machines)
        X, label = X[sel], label[sel]
        weight = weight[sel] if weight is not None else None
    md.set_field("label", label)
    if weight is not None:
        md.set_field("weight", weight)
    if query_inline is not None:
        md.query_boundaries = _query_boundaries(query_inline)
    if sharded:
        _shard_side_files(path, md, n_full, rank, num_machines)
    else:
        _side_files(path, md)
    if reference is not None:
        return BinnedDataset.from_raw(X, config, reference=reference,
                                      metadata=md)
    mappers = None
    if distributed:
        from .distributed import find_bins_distributed
        mappers = find_bins_distributed(X, config, rank, num_machines,
                                        allgather, cat_cols)
        if len(mappers) < X.shape[1]:
            # the feature count synced down to the ranks' minimum
            X = X[:, :len(mappers)]
            feature_names = feature_names[:len(mappers)]
            cat_cols = [c for c in cat_cols if c < len(mappers)]
    ds = BinnedDataset.from_raw(X, config, categorical_features=cat_cols,
                                feature_names=feature_names, metadata=md,
                                mappers=mappers,
                                bundle_allgather=(allgather if distributed
                                                  else None),
                                rank=rank)
    if config.is_save_binary_file:
        ds.save_binary(bin_path[:-4])
        log_info(f"saved binary cache {bin_path}")
    return ds
