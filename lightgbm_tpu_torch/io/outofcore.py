"""The binned shard store of out-of-core training (a port of the JAX
package's ``io/outofcore.py``; both packages read and write the same
store).

The fork's addition to upstream LightGBM is per-rank sharded fetch of
data too large for one machine (``DownloadData``, reference
`application.cpp:168-237`), and the reference's ``.bin`` dataset cache
is what makes training beyond RAM practical.  The store is both:

* **multi-file sampled bin finding** — the bin-finding sample is drawn
  over the concatenated global row space of a file list with the
  in-memory path's ``data_random_seed`` draw, so the mappers equal
  ``BinnedDataset.from_raw`` over the concatenation;
* **an mmap-able binned shard cache** — per source file, binned uint8
  rows in ``shard-<k>.bins`` (labels in ``.label``, weights in
  ``.weight``), written under ``.tmp`` names and published with
  ``os.replace``; a per-shard JSON sidecar published after the blobs;
  the ``manifest.json`` written last with :func:`atomic_write`.  An
  interrupted ingest leaves either a complete store or one without a
  manifest whose finished shards the next ingest reuses.

The store is keyed on source fingerprints and the binning knobs
(:func:`cache_key`): :func:`load_store` refuses a stale store.  CSV and
TSV sources parse through a pure-Python chunk parser, libsvm sources
through the port's native parser (``native/``: a bounded scan, then
bounded chunks), as the JAX package's do.  ``LGBM_TPU_STREAM_CACHE``
places the store of a file list (:func:`default_cache_dir`).  Telemetry:
the spans ``ingest.find_bins`` and ``ingest.shard``, the counters
``ingest.shards`` and ``ingest.rows``.  Training against the store is
``boosting/streaming.py``.
"""
from __future__ import annotations

import hashlib
import io as _io
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..obs import counter_add, span
from ..utils.file_io import atomic_write, localize, release
from ..utils.log import log_info, log_warning
from .binning import BIN_NUMERICAL, BinMapper
from .dataset import BinnedDataset, Metadata, find_mappers_from_sample
from .loader import _column_plan, detect_format, raw_data_row_count

STORE_VERSION = 1
MANIFEST = "manifest.json"
_CHUNK_BYTES = 4 << 20

# binning-relevant config knobs the cache key covers: any change here
# changes the mappers, so it must invalidate the store
_KEY_KNOBS = ("max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
              "data_random_seed", "use_missing", "zero_as_missing",
              "categorical_column", "label_column", "weight_column",
              "ignore_column", "has_header", "two_round_chunk_bytes")


def _sha256_bytes(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def mapper_digest(mappers) -> str:
    """Canonical sha256 over the BinMapper set (the bin-boundary identity
    the manifest records)."""
    payload = json.dumps([m.to_dict() for m in mappers], sort_keys=True,
                         default=float).encode()
    return _sha256_bytes(payload)


def _config_key(config: Config) -> Dict:
    return {k: getattr(config, k, None) for k in _KEY_KNOBS}


def _source_fingerprint(path: str) -> Dict:
    """Cheap per-source identity: name and byte size (the content sha256
    is recorded per shard during ingest)."""
    return {"path": os.path.basename(path),
            "bytes": os.path.getsize(path) if os.path.exists(path) else -1}


def cache_key(sources: List[str], config: Config) -> str:
    """The store identity: source fingerprints and binning knobs."""
    payload = json.dumps({
        "version": STORE_VERSION,
        "sources": [_source_fingerprint(s) for s in sources],
        "config": _config_key(config),
    }, sort_keys=True, default=str).encode()
    return _sha256_bytes(payload)


def shard_sources(sources: List[str], rank: int, num_ranks: int
                  ) -> List[str]:
    """Per-rank file-list sharding: rank ``r`` of ``S`` owns
    ``sources[r::S]``."""
    return list(sources)[rank::max(1, num_ranks)]


# ---------------------------------------------------------------------------
# chunked parse of delimited files
# ---------------------------------------------------------------------------
def _file_plan(path: str, config: Config):
    """-> (separator, header names, chunk stream, data row count).  A
    libsvm source streams ``[rows, 1 + columns]`` chunks, the label in
    column 0, from the native parser (the JAX package's plan)."""
    fmt = detect_format(path, config.has_header)
    skip = 1 if config.has_header else 0
    if fmt == "libsvm":
        from .. import native
        scanned = (native.scan_libsvm(path, skip) if native.available()
                   else None)
        if scanned is None:
            raise ValueError(
                "out-of-core ingest needs the native parser for libsvm "
                f"sources ({path!r})")
        n, fcols = scanned

        def libsvm_stream():
            return native.parse_libsvm_chunks(path, skip, fcols,
                                              chunk_bytes=_CHUNK_BYTES)
        return " ", None, libsvm_stream, int(n)
    sep = {"csv": ",", "tsv": "\t"}[fmt]
    header_names = None
    if config.has_header:
        with open(path) as f:
            header_names = f.readline().rstrip("\n").split(sep)
    n = raw_data_row_count(path, skip)

    def stream():
        with open(path) as f:
            for _ in range(skip):
                f.readline()
            while True:
                lines = f.readlines(_CHUNK_BYTES)
                if not lines:
                    break
                body = "".join(ln for ln in lines if ln.strip())
                if not body:
                    continue
                arr = np.genfromtxt(_io.StringIO(body), delimiter=sep,
                                    dtype=np.float64)
                yield (arr.reshape(-1, arr.shape[-1]) if arr.ndim
                       else arr.reshape(1, -1))
    return sep, header_names, stream, int(n)


def find_mappers_multi(files: List[str], config: Config
                       ) -> Tuple[list, List[int], List[str], int,
                                  List[int], tuple]:
    """Bin finding over a file list: the sample is drawn over the
    concatenated global row space with the in-memory path's RNG draw,
    every file streams keeping only sampled rows, and the mappers come
    from ``find_mappers_from_sample``.

    -> (mappers, used_features, feature_names, num_total_features,
        per_file_rows, _column_plan)"""
    plans = [_file_plan(p, config) for p in files]
    rows = [pl[3] for pl in plans]
    n = int(sum(rows))
    if n <= 0:
        raise ValueError(f"no data rows in shard list {files!r}")
    sample_cnt = min(n, config.bin_construct_sample_cnt)
    rng = np.random.RandomState(config.data_random_seed)
    sample_gidx = (np.arange(n) if sample_cnt >= n
                   else np.sort(rng.choice(n, sample_cnt, replace=False)))

    sample_rows = []
    plan = None
    base = 0
    for (sep, header_names, stream, n_f), path in zip(plans, files):
        seen = 0
        for chunk in stream():
            if plan is None:
                plan = _column_plan(chunk.shape[1], config, header_names)
            lo = np.searchsorted(sample_gidx, base + seen)
            hi = np.searchsorted(sample_gidx, base + seen + len(chunk))
            if hi > lo:
                sample_rows.append(
                    np.array(chunk[sample_gidx[lo:hi] - base - seen]))
            seen += len(chunk)
        if seen != n_f:
            raise ValueError(f"chunked parse of {path!r} saw {seen} rows, "
                             f"raw scan counted {n_f}")
        base += n_f
    label_idx, weight_idx, query_idx, keep, names, cat_cols = plan
    if query_idx is not None:
        raise ValueError("out-of-core ingest does not support ranking group "
                         "columns (streamed row blocks would split queries)")
    sample = np.concatenate(sample_rows)[:, keep]
    mappers = find_mappers_from_sample(sample, config, set(cat_cols))
    used = [f for f in range(len(keep)) if not mappers[f].is_trivial]
    return mappers, used, names, len(keep), rows, plan


# ---------------------------------------------------------------------------
# the shard store
# ---------------------------------------------------------------------------
class ShardStore:
    """An opened (complete, key-validated) shard store.  Row blocks are
    numpy views of the per-shard memmaps, so host memory holds only the
    pages a block touches, never the whole binned matrix."""

    def __init__(self, cache_dir: str, manifest: Dict):
        self.cache_dir = cache_dir
        self.manifest = manifest
        self.mappers = [BinMapper.from_dict(d) for d in manifest["mappers"]]
        self.used_features = list(manifest["used_features"])
        self.feature_names = list(manifest["feature_names"])
        self.num_total_features = int(manifest["num_total_features"])
        self.dtype = np.dtype(manifest["dtype"])
        self.feature_info = BinnedDataset._build_feature_info(
            [self.mappers[f] for f in self.used_features])
        self._shards = manifest["shards"]
        self._rows = [int(s["rows"]) for s in self._shards]
        self._offsets = np.concatenate(
            [[0], np.cumsum(self._rows)]).astype(np.int64)
        self.n = int(self._offsets[-1])
        self._bins: List[Optional[np.memmap]] = [None] * len(self._shards)
        self._label: List[Optional[np.memmap]] = [None] * len(self._shards)
        self._weight: List[Optional[np.memmap]] = [None] * len(self._shards)
        self.has_weight = any(s.get("has_weight") for s in self._shards)

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def _mm(self, cache, k: int, suffix: str, shape, dtype):
        if cache[k] is None:
            if shape[0] == 0:
                cache[k] = np.zeros(shape, dtype)
            else:
                path = os.path.join(self.cache_dir,
                                    self._shards[k]["name"] + suffix)
                cache[k] = np.memmap(path, dtype=dtype, mode="r",
                                     shape=shape)
        return cache[k]

    def _shard_bins(self, k: int) -> np.ndarray:
        return self._mm(self._bins, k, ".bins",
                        (self._rows[k], self.num_features), self.dtype)

    def _shard_label(self, k: int) -> np.ndarray:
        return self._mm(self._label, k, ".label", (self._rows[k],),
                        np.float32)

    def _shard_weight(self, k: int) -> Optional[np.ndarray]:
        if not self._shards[k].get("has_weight"):
            return None
        return self._mm(self._weight, k, ".weight", (self._rows[k],),
                        np.float32)

    def _gather(self, start: int, stop: int, per_shard) -> np.ndarray:
        """``[start, stop)`` of the global row space from per-shard arrays
        (a view when the range stays inside one shard)."""
        k = int(np.searchsorted(self._offsets, start, side="right") - 1)
        parts = []
        pos = start
        while pos < stop:
            s0, s1 = self._offsets[k], self._offsets[k + 1]
            a, b = pos - s0, min(stop, s1) - s0
            parts.append(per_shard(k)[a:b])
            pos += b - a
            k += 1
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def read_rows(self, start: int, stop: int
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """-> (bins [m, G], label [m], weight [m] or None)."""
        bins = self._gather(start, stop, self._shard_bins)
        label = self._gather(start, stop, self._shard_label)
        weight = (self._gather(start, stop, self._shard_weight)
                  if self.has_weight else None)
        return bins, label, weight

    def labels_array(self) -> np.ndarray:
        return self._gather(0, self.n, self._shard_label)

    def weights_array(self) -> Optional[np.ndarray]:
        if not self.has_weight:
            return None
        return self._gather(0, self.n, self._shard_weight)

    def to_binned_dataset(self, config: Config) -> BinnedDataset:
        """A resident ``BinnedDataset`` of the whole store (unbundled):
        what in-memory training of the same rows reads."""
        packed = np.array(self._gather(0, self.n, self._shard_bins))
        md = Metadata()
        md.set_field("label", np.array(self.labels_array()))
        w = self.weights_array()
        if w is not None:
            md.set_field("weight", np.array(w))
        ds = BinnedDataset()
        ds.config = config
        ds.num_total_features = self.num_total_features
        ds.feature_names = list(self.feature_names)
        ds.mappers = self.mappers
        ds.used_features = list(self.used_features)
        cols = [packed[:, j] for j in range(self.num_features)]
        return BinnedDataset._finish_from_mappers(
            ds, np.zeros((self.n, 0)), config, md, self.n,
            self.num_total_features, cols=cols, packed=packed,
            allow_bundle=False)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------
def _shard_paths(cache_dir: str, k: int) -> Dict[str, str]:
    name = f"shard-{k:04d}"
    base = os.path.join(cache_dir, name)
    return {"name": name, "bins": base + ".bins", "label": base + ".label",
            "weight": base + ".weight", "sidecar": base + ".json"}


def _sidecar_valid(cache_dir: str, k: int, key: str, source: Dict,
                   itemsize_x_cols: int) -> Optional[Dict]:
    """A shard is reusable iff its sidecar parses, matches this store key
    and source fingerprint, and the published blob sizes agree with the
    recorded row count: a torn or foreign blob is ingested again."""
    p = _shard_paths(cache_dir, k)
    try:
        with open(p["sidecar"]) as f:
            sc = json.load(f)
    except (OSError, ValueError):
        return None
    if sc.get("key") != key or sc.get("source") != source:
        return None
    rows = int(sc.get("rows", -1))
    if rows < 0:
        return None
    try:
        if rows and os.path.getsize(p["bins"]) != rows * itemsize_x_cols:
            return None
        if rows and os.path.getsize(p["label"]) != rows * 4:
            return None
        if sc.get("has_weight") and rows and \
                os.path.getsize(p["weight"]) != rows * 4:
            return None
    except OSError:
        return None
    return sc


def _write_blob(path: str, payload: bytes) -> None:
    """``payload`` under ``path + ".tmp"``, fsynced (published later)."""
    with open(path + ".tmp", "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _ingest_one_shard(k: int, path: str, config: Config, cache_dir: str,
                      mappers, used, plan, key: str, dtype) -> Dict:
    """Parse one source file chunk by chunk into the store: blobs under
    ``.tmp`` names, published with ``os.replace``, the sidecar (the
    shard's validity marker) last."""
    p = _shard_paths(cache_dir, k)
    local = localize(path)
    _, _, stream, n_f = _file_plan(local, config)
    source = _source_fingerprint(local)
    source["path"] = os.path.basename(path)
    with span("ingest.shard", shard=k, rows=n_f):
        sc = _write_shard(path, p, stream, n_f, mappers, used, plan, key,
                          dtype, source)
    counter_add("ingest.shards")
    counter_add("ingest.rows", sc["rows"])
    if local != path:
        release(local)
    return sc


def _write_shard(path: str, p: Dict[str, str], stream, n_f: int, mappers,
                 used, plan, key: str, dtype, source: Dict) -> Dict:
    label_idx, weight_idx, _, keep, _, _ = plan
    sha = hashlib.sha256()
    rows = 0
    has_weight = weight_idx is not None
    fb = open(p["bins"] + ".tmp", "wb")
    fl = open(p["label"] + ".tmp", "wb")
    fw = open(p["weight"] + ".tmp", "wb") if has_weight else None
    try:
        for chunk in stream():
            binned = np.empty((len(chunk), len(used)), dtype)
            for j, f in enumerate(used):
                binned[:, j] = mappers[f].value_to_bin(chunk[:, keep[f]])
            payload = np.ascontiguousarray(binned).tobytes()
            sha.update(payload)
            fb.write(payload)
            fl.write(np.ascontiguousarray(
                chunk[:, label_idx].astype(np.float32)).tobytes())
            if fw is not None:
                fw.write(np.ascontiguousarray(
                    chunk[:, weight_idx].astype(np.float32)).tobytes())
            rows += len(chunk)
        for f in (fb, fl) + ((fw,) if fw else ()):
            f.flush()
            os.fsync(f.fileno())
    finally:
        fb.close()
        fl.close()
        if fw is not None:
            fw.close()
    if rows != n_f:
        raise ValueError(f"shard {path!r}: chunked parse yielded {rows} "
                         f"rows, raw scan counted {n_f}")
    os.replace(p["bins"] + ".tmp", p["bins"])
    os.replace(p["label"] + ".tmp", p["label"])
    if has_weight:
        os.replace(p["weight"] + ".tmp", p["weight"])
    sc = {"key": key, "rows": rows, "sha256": sha.hexdigest(),
          "source": source, "has_weight": has_weight, "name": p["name"]}
    atomic_write(p["sidecar"], json.dumps(sc, indent=1))
    return sc


def load_store(cache_dir: str, sources: List[str], config: Config,
               rank: int = 0, num_ranks: int = 1) -> Optional[ShardStore]:
    """Open an existing store iff its manifest matches this (sources,
    config) key and every shard blob still matches its sidecar; a stale
    or torn store is refused (None), never trained on."""
    path = os.path.join(cache_dir, MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    files = shard_sources(sources, rank, num_ranks)
    if manifest.get("key") != cache_key(files, config):
        log_warning(f"shard cache at {cache_dir!r} is stale (source bytes or "
                    "binning config changed); ingesting again")
        return None
    store = ShardStore(cache_dir, manifest)
    itemsize = store.dtype.itemsize * store.num_features
    for k in range(len(files)):
        if _sidecar_valid(cache_dir, k, manifest["key"],
                          manifest["shards"][k]["source"], itemsize) is None:
            log_warning(f"shard cache at {cache_dir!r}: shard {k} is torn; "
                        "ingesting again")
            return None
    return store


def ingest(sources: List[str], config: Config, cache_dir: str,
           rank: int = 0, num_ranks: int = 1) -> ShardStore:
    """Build (or resume, or reuse) the shard store of this rank's share
    of ``sources``.  Finished shards (valid sidecars) are reused, torn
    ones ingested again, and the manifest is written only after every
    shard is valid."""
    files = shard_sources(sources, rank, num_ranks)
    if not files:
        raise ValueError(f"rank {rank}/{num_ranks} owns no source files")
    os.makedirs(cache_dir, exist_ok=True)
    hit = load_store(cache_dir, sources, config, rank, num_ranks)
    if hit is not None:
        log_info(f"shard cache hit at {cache_dir!r} ({hit.n} rows, "
                 f"{len(files)} shards)")
        return hit
    key = cache_key(files, config)
    with span("ingest.find_bins", files=len(files)):
        mappers, used, names, num_total, _, plan = find_mappers_multi(
            files, config)
    max_nb = max((mappers[f].num_bin for f in used), default=2)
    dtype = np.dtype(np.uint8 if max_nb <= 256 else np.int32)
    itemsize = dtype.itemsize * len(used)
    shards = []
    reused = 0
    for k, path in enumerate(files):
        sc = _sidecar_valid(cache_dir, k, key, _source_fingerprint(path),
                            itemsize)
        if sc is not None:
            reused += 1
        else:
            sc = _ingest_one_shard(k, path, config, cache_dir, mappers, used,
                                   plan, key, dtype)
        shards.append(sc)
    if reused:
        log_info(f"resumed ingest: reused {reused}/{len(files)} "
                 "already-valid shards")
    manifest = {
        "version": STORE_VERSION,
        "key": key,
        "mapper_digest": mapper_digest(mappers),
        "mappers": [m.to_dict() for m in mappers],
        "used_features": list(map(int, used)),
        "feature_names": list(names),
        "num_total_features": int(num_total),
        "dtype": dtype.name,
        "config": _config_key(config),
        "shards": shards,
        "total_rows": int(sum(s["rows"] for s in shards)),
    }
    atomic_write(os.path.join(cache_dir, MANIFEST),
                 json.dumps(manifest, indent=1))
    log_info(f"ingested {manifest['total_rows']} rows into {len(shards)} "
             f"shard(s) at {cache_dir!r}")
    return ShardStore(cache_dir, manifest)


def default_cache_dir(sources: List[str]) -> str:
    """``LGBM_TPU_STREAM_CACHE`` when set, else a ``.lgbm_shards``
    directory next to the first source."""
    override = os.environ.get("LGBM_TPU_STREAM_CACHE")
    if override:
        return override
    first = sources[0]
    base = os.path.dirname(first) if "://" not in first else "."
    return os.path.join(base or ".", ".lgbm_shards")


def ingest_synthetic(cache_dir: str, rows: int, features: int,
                     config: Config, seed: int = 0,
                     shard_rows: int = 1 << 22) -> ShardStore:
    """Write a synthetic pre-binned store (the bench's stream data):
    uniform bins and a label that a threshold on the first two columns
    decides, shard by shard, so peak host memory is one shard.  The same
    sidecar and manifest discipline as :func:`ingest` (resumable), keyed
    on (rows, features, seed, max_bin); bitwise the JAX package's."""
    os.makedirs(cache_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    mappers = []
    for _ in range(features):
        m = BinMapper()
        m.find_bin(rng.uniform(size=256), 256, config.max_bin, 1,
                   bin_type=BIN_NUMERICAL, use_missing=False,
                   zero_as_missing=False)
        mappers.append(m)
    key = _sha256_bytes(json.dumps(
        {"synthetic": [rows, features, seed, int(config.max_bin)]},
        sort_keys=True).encode())
    max_nb = max(m.num_bin for m in mappers)
    dtype = np.dtype(np.uint8 if max_nb <= 256 else np.int32)
    shards = []
    for k in range(-(-rows // shard_rows)):
        m_rows = min(shard_rows, rows - k * shard_rows)
        src = {"path": f"synthetic-{k}", "bytes": m_rows}
        sc = _sidecar_valid(cache_dir, k, key, src,
                            dtype.itemsize * features)
        if sc is None:
            p = _shard_paths(cache_dir, k)
            r = np.random.RandomState(seed + 1 + k)
            bins = r.randint(0, max(2, max_nb - 1),
                             size=(m_rows, features)).astype(dtype)
            label = (bins[:, 0].astype(np.float32) + 0.5 * bins[:, 1]
                     > 0.75 * (max_nb - 2)).astype(np.float32)
            _write_blob(p["bins"], bins.tobytes())
            _write_blob(p["label"], label.tobytes())
            os.replace(p["bins"] + ".tmp", p["bins"])
            os.replace(p["label"] + ".tmp", p["label"])
            sc = {"key": key, "rows": int(m_rows),
                  "sha256": hashlib.sha256(bins.tobytes()).hexdigest(),
                  "source": src, "has_weight": False, "name": p["name"]}
            atomic_write(p["sidecar"], json.dumps(sc))
        shards.append(sc)
    manifest = {
        "version": STORE_VERSION, "key": key,
        "mapper_digest": mapper_digest(mappers),
        "mappers": [m.to_dict() for m in mappers],
        "used_features": list(range(features)),
        "feature_names": [f"Column_{i}" for i in range(features)],
        "num_total_features": features, "dtype": dtype.name,
        "config": _config_key(config), "shards": shards,
        "total_rows": int(rows),
    }
    atomic_write(os.path.join(cache_dir, MANIFEST), json.dumps(manifest))
    return ShardStore(cache_dir, manifest)
