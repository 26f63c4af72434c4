"""Streamed out-of-core training and elastic training (a port of the JAX
package's ``boosting/streaming.py``).

Rows live in the mmap-able shard store (``io/outofcore.py``), not on
the device: per tree, row blocks stream host -> device once per wave;
each block is routed through the partial tree (the route kernel K2) and
its active-leaf histograms fold into one carried accumulator (the
seeded wide kernel K5, or the seeded leaf-compacted kernel K3 on
quantized waves wider than 32 slots), unpacked once per wave.  Past the
kernels' domain (groups of more than 256 bins, trees of more than 1,024
leaves) the carry is the exact-f32 ``[A, G, B, 3]`` grid that the seeded
wide histogram adds each block into (``hist_wide_raw(..., acc=)``), and
every wave takes ``build_tree_unfused``'s plan, ``round8(L / 2)`` slots;
the bins stream as the store holds them, uint8 or int32.  Device memory
follows the block size, never the row count: only the gradients,
hessians, scores and each block's two leaf vectors live on the host.

With one protocol shard the streamed model equals the in-memory one
(``lgb.train`` on the same rows) bitwise on the quantized modes, scores
included:

1. **Carried folds.**  The quantized kernels add int32 values, exact in
   any order, and every block of a tree quantizes with one scale pair,
   the host absmax over all rows of its shard (:func:`_fold_scales`),
   bitwise the
   device absmax the in-memory pack computes.  The float modes (taken
   past 16,909,320 rows, where int8 cells could overflow int32) sum in a
   fixed order that does not depend on the block size
   (``ops/histogram.py:hist_active_float_raw``).
2. **Chunked root statistics.**  The root sums reduce fixed chunks of
   8,192 rows by a fixed pairwise tree (``learner/serial.py
   root_chunk_sums``); blocks are whole chunks, so the streamed chunk
   sums are the in-memory ones.
3. **The same scan and score update.**  The split scan keys on the
   global row count (the template ``DeviceData`` carries it), and each
   block's last route emits the row values with the route-values kernel
   K4, added to the scores with the in-memory update's
   ``add_(row_value, alpha=lr)``.

**The upload pipeline** (``pipeline=True``, the default): a staging
thread reads block k+1 from the store into a pinned host buffer while
block k folds, and block k+1's host -> device copy runs on its own
stream, issued before block k's fold is awaited.  The fold order never
changes, so ``pipeline=False`` (stage and copy each block after the
previous one is done) builds the same model.  Each copy is issued under
the shared retry policy behind the ``stream.upload`` fault point, before
any kernel reads the block, so a retried upload never tears a fold.

**The JAX package's seams**: ``LGBM_TPU_STREAM_ROWS`` is the block size
when the caller passes none (rounded up to whole ``STREAM_CHUNK``
chunks; 1,048,576 rows when unset), ``LGBM_TPU_STREAM_PIPELINE=0``
(``off``, ``false``) is ``pipeline=False``.  Neither changes the model.

**Telemetry** (``obs/telemetry.py``): the spans ``stream.train``,
``stream.gradients``, ``stream.prefetch`` (the staging thread's read),
``stream.upload`` and ``stream.fold``; the counters ``stream.waves``,
``stream.trees`` and ``stream.pipeline.overlap_s`` (the host time spent
waiting for block k+1's staging and issuing its copy after block k's
kernels were launched).  Spans are host wall clock and add no device
synchronization.

**Protocol shards.**  The rows split into ``S`` contiguous shards
(``parallel/mesh.py:shard_row_ranges``; ``S`` is ``num_shards``, else
the elastic run's, else ``mesh_shape[0]`` under ``tree_learner=data``,
else 1: a stream trains on one device).  Blocks subdivide each shard's
range and never straddle two.  Each shard keeps its own root chunk sums,
reduced per shard, its own quantization scales (the absmax over its
rows) and its own histogram carry, unpacked per shard; the shards'
partials then combine in shard order, elementwise adds.  With ``S = 1``
this is the one-shard stream above; with ``S > 1`` it is the JAX
package's ``StreamTrainer(num_shards=S)``, bit for bit.

**Elastic training** (:func:`train_elastic`) rides these shards, because
all of its communication is an explicit host combination of per-shard
partials.  ``S`` is fixed for the run's lifetime
(:func:`elastic_shards`); each rank owns the shards ``s % world ==
rank``, folds only their blocks, and the per-shard partials (root
statistics, each wave's histograms) are gathered through the elastic
coordinator (``parallel/elastic.py``) and combined in shard order.  The
model is therefore a function of ``(data, config, S)`` only: any world
size, any membership history and any recovery from a committed barrier
snapshot (``boosting/snapshot.py``) give the same bytes.  On a
``RankLostError``, ``GenerationChanged`` or ``EvictedError`` survivors
re-rendezvous, own the shards again at the new world size, and resume
from the newest barrier every member can read.  A plain stream with
``snapshot_freq`` writes the same barriers (a world of one), and
``train_streaming(..., resume_from=)`` restores the newest one.

Supported: gbdt boosting with the row-wise objectives (the regression,
binary, multiclass and cross-entropy families: a block's gradients are
its rows' gradients), K trees an iteration for the multiclass ones (one
set of gradients an iteration, each class's tree streamed in turn, its
feature mask keyed on ``iter * K + k``), weights, ``feature_fraction``,
``tree_learner`` serial or data.  These raise, as in the JAX package:
leaf-renewal objectives (L1, quantile, MAPE re-fit leaves from every
row's score), ranking (row blocks would split queries), bagging (its
``[n]`` device mask breaks the memory contract), ``boosting != gbdt``,
custom objectives, EFB-bundled resident sources, ``tree_learner``
feature or voting, and ``num_machines > 1`` (a stream over several
processes is :func:`train_elastic`).
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, canonicalize_params
from ..io.dataset import BinnedDataset, Metadata
from ..io.device import device_data_from_arrays, feature_meta_np
from ..learner.serial import (STREAM_CHUNK, _apply_wave, _pending_tables,
                              final_leaf_values, finished_tree, kernels_fit,
                              make_hist_fold_fn, reduce_chunk_sums,
                              rescan_changed, root_chunk_sums, root_state,
                              stage_plan, wide_hist_bytes, wide_wave_slots)
from ..obs import counter_add, event, span
from ..objective.objectives import create_objective
from ..ops.histogram import bin_stride, hist_wide_scratch_bytes
from ..ops.route import route_rows, route_rows_values
from ..utils.faults import fault_point
from ..utils.log import log_info, log_warning
from ..utils.retry import retry_call
from .gbdt import (GBDT, check_unported_options, feature_mask,
                   growth_params_from_config)

_SCALE_CHUNK = 1 << 24
DEFAULT_BLOCK_ROWS = 1 << 20


def stream_rows() -> int:
    """The block size of ``LGBM_TPU_STREAM_ROWS``, rounded up to a
    multiple of ``STREAM_CHUNK`` (block boundaries must fall on the root
    statistics' chunk boundaries), or 0 when unset (the JAX package's
    ``stream_rows``)."""
    r = int(os.environ.get("LGBM_TPU_STREAM_ROWS", "0"))
    if r <= 0:
        return 0
    return -(-r // STREAM_CHUNK) * STREAM_CHUNK


def stream_pipeline_env() -> bool:
    """False when ``LGBM_TPU_STREAM_PIPELINE`` is ``0``, ``off`` or
    ``false`` (the serial escape), else True."""
    return os.environ.get("LGBM_TPU_STREAM_PIPELINE", "1").strip().lower() \
        not in ("0", "off", "false")


def _fold_scales(grad: np.ndarray, hess: np.ndarray) -> np.ndarray:
    """A tree's quantization scales for the seeded folds: ``[|g|max,
    |h|max]`` clamped to 1e-30, f32.  Every block of the tree quantizes
    with this one pair.  float32 absmax is exact and does not depend on
    the order, so this chunked host reduction is bitwise the device
    absmax the in-memory pack computes."""
    out = np.empty(2, np.float32)
    for i, arr in enumerate((grad, hess)):
        m = np.float32(0.0)
        for lo in range(0, arr.shape[0], _SCALE_CHUNK):
            m = np.maximum(m, np.float32(
                np.max(np.abs(arr[lo:lo + _SCALE_CHUNK]))))
        out[i] = np.maximum(m, np.float32(1e-30))
    return out


class _Source:
    """Block reader over a ShardStore or a resident BinnedDataset (the
    resident form streams exactly the arrays in-memory training reads)."""

    def __init__(self, obj, config: Config):
        from ..io.outofcore import ShardStore
        self._store = obj if isinstance(obj, ShardStore) else None
        self._ds = obj if isinstance(obj, BinnedDataset) else None
        if self._store is None and self._ds is None:
            raise TypeError(f"unsupported stream source {type(obj)!r}")
        if self._ds is not None and self._ds.bundle is not None \
                and self._ds.bundle.is_bundled:
            raise ValueError("streaming does not support EFB-bundled "
                             "resident sources (the shard store ingests "
                             "unbundled)")
        self.config = config

    @property
    def n(self) -> int:
        return (self._store.n if self._store is not None
                else self._ds.num_data)

    @property
    def num_features(self) -> int:
        return (self._store.num_features if self._store is not None
                else self._ds.num_features)

    @property
    def dtype(self) -> np.dtype:
        """The bins' type: uint8, or int32 past 256 bins a group."""
        return np.dtype(self._store.dtype if self._store is not None
                        else self._ds.bins.dtype)

    def read_rows(self, start: int, stop: int):
        """-> (bins [m, G], label [m], weight [m] or None)."""
        if self._store is not None:
            return self._store.read_rows(start, stop)
        md = self._ds.metadata
        return (self._ds.bins[start:stop],
                md.label[start:stop] if md.label is not None else
                np.zeros(stop - start, np.float32),
                md.weight[start:stop] if md.weight is not None else None)

    def labels(self) -> np.ndarray:
        return (self._store.labels_array() if self._store is not None
                else self._ds.metadata.label)

    def weights(self) -> Optional[np.ndarray]:
        return (self._store.weights_array() if self._store is not None
                else self._ds.metadata.weight)

    def query_boundaries(self):
        return (None if self._store is not None
                else self._ds.metadata.query_boundaries)

    def init_score(self):
        return (None if self._store is not None
                else self._ds.metadata.init_score)

    def light_dataset(self) -> BinnedDataset:
        """A BinnedDataset shell without rows, carrying the mappers and
        feature metadata that model IO and prediction read."""
        if self._ds is not None:
            return self._ds
        st = self._store
        ds = BinnedDataset()
        ds.config = self.config
        ds.num_total_features = st.num_total_features
        ds.feature_names = list(st.feature_names)
        ds.mappers = st.mappers
        ds.used_features = list(st.used_features)
        ds.feature_info = st.feature_info
        ds.bins = np.zeros((0, st.num_features), st.dtype)
        return ds


def _check_streamable(config: Config, objective, src: _Source) -> None:
    check_unported_options(config)
    bad = None
    if config.boosting_type != "gbdt":
        bad = f"boosting={config.boosting_type} (host score patching)"
    elif config.bagging_freq > 0 and config.bagging_fraction < 1.0:
        bad = ("bagging (the [n]-shaped device mask breaks the "
               "block-memory contract)")
    elif config.tree_learner not in ("serial", "data"):
        bad = (f"tree_learner={config.tree_learner} (a stream composes "
               "with data-parallel row shards only)")
    elif config.num_machines > 1:
        bad = (f"num_machines={config.num_machines} (a stream over several "
               "processes is train_elastic, whose ranks own whole "
               "protocol shards)")
    elif objective is None:
        bad = "objective=none / custom fobj"
    elif objective.need_renew_tree_output:
        bad = (f"objective={objective.name} (leaf renewal rewrites "
               "outputs from per-row scores)")
    elif "rank" in objective.name or src.query_boundaries() is not None:
        bad = "ranking objectives (row blocks would split queries)"
    elif src.init_score() is not None:
        bad = "init_score (streamed scores start from boost_from_average)"
    if bad:
        raise ValueError(f"streaming training does not support {bad}; "
                         "train in memory, or see README \"Out-of-core "
                         "training\" for the supported envelope")


def _num_shards(config: Config) -> int:
    """The protocol shard count of a stream given neither ``num_shards``
    nor an elastic run: ``mesh_shape[0]`` under ``tree_learner=data``,
    else 1 (a stream trains on one device; the JAX package takes its
    device count there)."""
    if config.tree_learner != "data":
        return 1
    shape = tuple(config.mesh_shape)
    return max(1, int(shape[0])) if shape else 1


class _BlockUploader:
    """Host staging and host -> device copies of row blocks: ``(bins_t
    [G, R], grad [R], hess [R])`` on the device, the bins of the
    source's type (uint8, or int32), every block padded to ``R`` rows
    (padding rows: bin 0, zero values).

    On the GPU two pinned host buffers and two device buffers alternate,
    and the copies run on their own stream; ``get(i)`` makes the current
    stream wait for block i's copy.  A buffer is refilled only after the
    caller has awaited the work that read it (the leaf-vector download
    of the previous block), which the wave loop does for every block."""

    def __init__(self, src: _Source, blocks, R: int, device,
                 pipelined: bool):
        self.src = src
        self.blocks = blocks
        self.R = R
        self.device = device
        self.cuda = device.type == "cuda"
        self.pool = (ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="stream-stage")
                     if pipelined and len(blocks) > 1 else None)
        G = src.num_features
        self.dtype = src.dtype
        if self.cuda:
            tdtype = torch.from_numpy(np.empty(0, self.dtype)).dtype

            def bufs(**kw):
                return (torch.empty((R, G), dtype=tdtype, **kw),
                        torch.empty(R, dtype=torch.float32, **kw),
                        torch.empty(R, dtype=torch.float32, **kw))
            self.host = [bufs(pin_memory=True) for _ in range(2)]
            self.dev = [bufs(device=device) for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event() for _ in range(2)]
        self.staged = {}

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True)
            self.pool = None

    def _stage(self, i: int, grad: np.ndarray, hess: np.ndarray):
        start, stop, m = self.blocks[i]
        with span("stream.prefetch", rows=m):
            bins, _, _ = self.src.read_rows(start, stop)
            if self.cuda:
                hb, hg, hh = (t.numpy() for t in self.host[i % 2])
            else:
                hb = np.empty((self.R, bins.shape[1]), self.dtype)
                hg = np.empty(self.R, np.float32)
                hh = np.empty(self.R, np.float32)
            hb[:m] = bins
            hb[m:] = 0
            for dst, arr in ((hg, grad), (hh, hess)):
                dst[:m] = arr[start:stop]
                dst[m:] = 0.0
        return hb, hg, hh

    def _upload(self, i: int, staged) -> None:
        """Issue block ``i``'s copy behind the ``stream.upload`` fault
        point and the shared retry policy: a transient fault retries
        before the copy is issued, never under a fold."""
        with span("stream.upload", rows=self.R):
            retry_call(self._put, i, staged, what="stream.upload")

    def _put(self, i: int, staged) -> None:
        fault_point("stream.upload")
        if not self.cuda:
            self.staged[i] = tuple(torch.from_numpy(a) for a in staged)
            return
        with torch.cuda.stream(self.stream):
            for d, h in zip(self.dev[i % 2], self.host[i % 2]):
                d.copy_(h, non_blocking=True)
            self.ready[i % 2].record(self.stream)
        self.staged[i] = self.dev[i % 2]

    def start(self, i: int, grad, hess):
        """Stage block ``i`` (on the staging thread when pipelined) and
        return a handle for :meth:`finish`."""
        if self.pool is not None:
            return self.pool.submit(self._stage, i, grad, hess)
        return self._stage(i, grad, hess)

    def finish(self, i: int, handle) -> None:
        """Wait for block ``i``'s staging and issue its copy."""
        staged = handle.result() if self.pool is not None else handle
        self._upload(i, staged)

    def get(self, i: int):
        """-> (bins_t [G, R], grad [R], hess [R]) of block ``i``."""
        b, g, h = self.staged.pop(i)
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.ready[i % 2])
        return b.t().contiguous(), g, h


class StreamTrainer:
    """Streamed boosting over a block source.

    Produces a regular :class:`~lightgbm_tpu_torch.boosting.gbdt.GBDT`
    (model text, ``digest()``, prediction through the mappers) whose
    train scores are the streamed host score state.  ``num_shards`` sets
    the protocol shard count; ``elastic`` (an
    :class:`~lightgbm_tpu_torch.parallel.elastic.ElasticRun`) makes this
    trainer one rank of an elastic world, folding only its own shards."""

    _wd = None                  # the stall watchdog, live inside train()

    def __init__(self, config: Config, source,
                 block_rows: Optional[int] = None, device=None,
                 pipeline: bool = True, num_shards: int = 0, elastic=None):
        from ..parallel.mesh import shard_row_ranges
        self.config = config
        self.src = _Source(source, config)
        self.objective = create_objective(config)
        _check_streamable(config, self.objective, self.src)
        self.K = self.objective.num_model_per_iteration
        n = self.src.n
        if n <= 0:
            raise ValueError("empty stream source")
        self.n = n
        self.device = torch.device(device or config.device)
        # the protocol shard count: explicit, else the elastic run's, else
        # the mesh shape's; fixed for an elastic run's lifetime, whatever
        # the world size
        self.elastic = elastic
        self.S = (int(num_shards)
                  or (int(elastic.num_shards) if elastic is not None else 0)
                  or _num_shards(config))
        self.owned = (elastic.owned_shards() if elastic is not None
                      else tuple(range(self.S)))
        self.ranges = [(lo, min(hi, n))
                       for lo, hi in shard_row_ranges(n, self.S)]
        self.per = -(-n // self.S)
        # blocks are whole root-statistic chunks (the chunk-sum contract),
        # subdivide each shard's range, and are no longer than a shard
        if not block_rows:
            block_rows = stream_rows() or DEFAULT_BLOCK_ROWS
        R = -(-max(1, int(block_rows)) // STREAM_CHUNK) * STREAM_CHUNK
        self.R = min(R, -(-self.per // STREAM_CHUNK) * STREAM_CHUNK)
        # this rank's blocks (every block when not elastic) and the shard
        # of each
        self.blocks: List[Tuple[int, int, int]] = []
        self.block_shard: List[int] = []
        for s in self.owned:
            lo, hi = self.ranges[s]
            for start in range(lo, hi, self.R):
                stop = min(start + self.R, hi)
                self.blocks.append((start, stop, stop - start))
                self.block_shard.append(s)
        self.pipeline = pipeline and stream_pipeline_env()

        light = self.src.light_dataset()
        booster = GBDT(config, None, self.device)
        booster.train_set = light
        booster.growth = growth_params_from_config(config)
        booster.feature_names = light.feature_names
        booster.max_feature_idx = light.num_total_features - 1
        booster.objective = self.objective
        booster.num_tree_per_iteration = self.K
        self.booster = booster
        self.growth = booster.growth
        self.L = self.growth.num_leaves

        # the template: feature metadata on the device and the GLOBAL row
        # count (the split scan keys on it, as in memory); rows arrive
        # per block
        meta = feature_meta_np(light)
        self.dd = dataclasses.replace(
            device_data_from_arrays(light.bins[:0], meta, self.device),
            num_data=n)
        booster.device_data = self.dd
        # the in-memory plan: the staged tail width in the kernels'
        # domain, build_tree_unfused's round8(L / 2) slots past it
        self.A = (stage_plan(self.L, self.growth.wave_size)[1]
                  if kernels_fit(self.dd.group_max_bins, self.L)
                  else wide_wave_slots(self.L))
        self.fold = make_hist_fold_fn(self.dd, self.L, self.A,
                                      hist_mode=config.hist_mode or None,
                                      num_data=n)
        if self.fold.backend == "scatter":
            self._check_fits()
        self.scores = np.zeros((n, self.K), np.float32)
        self._init_scores()
        self._up: Optional[_BlockUploader] = None
        # an open recovery episode handed over by train_elastic: train()
        # closes it (phase `retrain`) once boosting is back at the
        # iteration the failure interrupted
        self.recovery_episode = None

    @property
    def _exchange(self) -> bool:
        """Whether the shard partials travel between ranks."""
        return self.elastic is not None and self.elastic.world > 1

    def _check_fits(self) -> None:
        """Refuse, before any upload, a scatter stream whose per-leaf
        histograms, one wave's grids and carries (one a shard), two device
        blocks (each with its transposed bins) and a block's histogram
        scratch exceed the card's memory: every term follows the block
        size, the shards, the leaves and the bins, never the row count (on
        the CPU the host's allocator decides)."""
        if self.device.type != "cuda":
            return
        dd, R, L, A = self.dd, self.R, self.L, self.A
        G, Bh = dd.num_groups, bin_stride(dd.group_max_bins)
        hist = wide_hist_bytes(L, G, Bh) + self.S * A * G * Bh * 12
        blocks = 2 * R * (2 * G * self.src.dtype.itemsize + 8)
        scratch = hist_wide_scratch_bytes(R, G, A, Bh)
        have = torch.cuda.get_device_properties(self.device).total_memory
        if hist + blocks + scratch > have:
            raise NotImplementedError(
                f"a stream of {L} leaves over {G} columns at a {Bh}-bin "
                f"stride in {R}-row blocks needs {hist / 2**30:.1f} GiB of "
                f"histograms, {blocks / 2**30:.1f} GiB of blocks and "
                f"{scratch / 2**30:.1f} GiB of kernel scratch, more than "
                f"the card's {have / 2**30:.1f} GiB")

    def _init_scores(self) -> None:
        obj = self.objective
        md = Metadata()
        md.set_field("label", np.array(self.src.labels(), np.float32))
        w = self.src.weights()
        if w is not None:
            md.set_field("weight", np.array(w, np.float32))
        # host labels for the label checks and boost-from-average; each
        # block binds its own labels on the device for its gradients
        obj.init(md, self.n, "cpu")
        if not self.config.boost_from_average:
            return
        v = obj.boost_from_score()
        if v != 0.0:
            self.booster.init_score_value = v
            self.scores[:] = np.float32(v)
            log_info(f"boost from average: init score = {v:.6f}")

    # -- per-block device work --------------------------------------------
    def _pad(self, arr: Optional[np.ndarray], m: int):
        if arr is None:
            return None
        out = np.zeros((self.R,) + arr.shape[1:], np.float32)
        out[:m] = arr
        return torch.from_numpy(out).to(self.device)

    def _gradients(self):
        """-> host (grad [n, K], hess [n, K]; rows of this rank's blocks)
        and, per class and shard, the blocks' root chunk sums ``[3, m]``:
        each block's gradients on the device from its scores, labels and
        weights (the objectives are row-wise, so a block's slice equals
        the in-memory rows)."""
        obj, K = self.objective, self.K
        grad = np.empty((self.n, K), np.float32)
        hess = np.empty((self.n, K), np.float32)
        sums = [[[] for _ in range(self.S)] for _ in range(K)]
        for (start, stop, m), sh in zip(self.blocks, self.block_shard):
            _, label, weight = self.src.read_rows(start, stop)
            sc = self._pad(self.scores[start:stop], m)
            obj.label = self._pad(np.asarray(label, np.float32), m)
            obj.weight = self._pad(None if weight is None
                                   else np.asarray(weight, np.float32), m)
            try:
                g, h = obj.get_gradients_k(sc)
            finally:
                obj.label = obj.weight = None
            mask = torch.arange(self.R, device=self.device) < m
            for k in range(K):
                sums[k][sh].append(root_chunk_sums(g[:, k].contiguous(),
                                                   h[:, k].contiguous(),
                                                   mask))
            grad[start:stop] = g[:m].cpu().numpy()
            hess[start:stop] = h[:m].cpu().numpy()
        return grad, hess, sums

    def _root_sums(self, shard_cs):
        """Root ``(sum_g, sum_h, cnt)`` from each shard's block chunk sums:
        each shard reduces its ``ceil(per / STREAM_CHUNK)`` chunks (the
        rows past its end are zero chunks) by the fixed pairwise tree, and
        the shards' ``[3]`` partials add in shard order (gathered from
        their owners in an elastic world).  With one shard these are the
        in-memory root statistics."""
        m_chunks = -(-self.per // STREAM_CHUNK)
        parts = {}
        for s in self.owned:
            cs = (torch.cat(shard_cs[s], dim=1) if shard_cs[s] else
                  torch.zeros((3, 0), dtype=torch.float32,
                              device=self.device))
            if cs.shape[1] < m_chunks:
                cs = torch.nn.functional.pad(cs, (0, m_chunks - cs.shape[1]))
            parts[s] = torch.stack(reduce_chunk_sums(cs[:, :m_chunks]))
        tot = self._shard_sum(parts, "elastic.root_stats")
        return reduce_chunk_sums(tot[:, None])   # [3, 1]: the identity

    # -- training ---------------------------------------------------------
    def train(self, num_iterations: Optional[int] = None) -> GBDT:
        """Boost to ``num_iterations``.  The ops plane is mounted
        (``LGBM_TPU_OPS_PORT``), the health plane marks the run
        (``warming`` until the first iteration, then ``ready``), the stall
        watchdog (``LGBM_TPU_WATCHDOG_S``) is armed around each streamed
        tree, and every iteration boundary feeds the determinism and ulp
        contracts from the host scores (:meth:`_window_contracts`).  Every
        ``snapshot_freq`` iterations a barrier snapshot is committed
        (:meth:`_barrier_snapshot`); an elastic rank reports its iteration
        on its heartbeats and gathers every shard's scores at the end."""
        from ..obs import determinism, health, num_contract, ops_plane
        iters = num_iterations or self.config.num_iterations
        if self.booster.iter == 0:
            if determinism.enabled():
                determinism.reset()
            if num_contract.enabled():
                num_contract.reset()
        ops_plane.mount("train")
        self._wd = health.Watchdog.maybe("stream")
        if self.booster.iter < iters:
            # (a run restored at its last iteration has nothing to warm)
            health.mark_warming("stream")
        self._up = _BlockUploader(self.src, self.blocks, self.R, self.device,
                                  self.pipeline)
        try:
            with span("stream.train", rows=self.n, block=self.R,
                      shards=self.S):
                self._finish_recovery()
                for it in range(self.booster.iter, iters):
                    stop = self._train_one_iter(it)
                    health.mark_ready()
                    self._finish_recovery()
                    self._window_contracts(it + 1)
                    if stop:
                        break
                    if self.elastic is not None:
                        # progress rides the heartbeats (the chaos
                        # launcher's kill schedule reads it)
                        self.elastic.client.set_status(iteration=it + 1)
                    self._maybe_barrier(it + 1)
        finally:
            self._up.close()
            if self._wd is not None:
                self._wd.stop()
                self._wd = None
        ep = self.recovery_episode
        if ep is not None:
            # stopped early, before the interrupted iteration came back
            self.recovery_episode = None
            ep.finish(iteration=int(self.booster.iter), truncated=True)
        if self._exchange:
            self._sync_scores()
        self.booster.scores = torch.from_numpy(self.scores)
        return self.booster

    def _finish_recovery(self) -> None:
        """Close the open recovery episode once boosting is back at the
        iteration the failure interrupted: `retrain` ends at full
        recovery, not at the rendezvous."""
        ep = self.recovery_episode
        if ep is not None and self.booster.iter >= ep.target_iter:
            self.recovery_episode = None
            ep.finish(iteration=int(self.booster.iter))

    def _window_contracts(self, it: int) -> None:
        """Iteration-boundary sampling for the determinism digest ledger
        (``LGBM_TPU_DETERMINISM=1``) and the ulp ledger
        (``LGBM_TPU_NUM_CONTRACT=1``) over the host score state; nothing
        when neither is on, nor mid-run on an elastic rank of a world
        larger than one (the shards it does not own hold stale scores
        until the final gather)."""
        from ..obs import determinism, num_contract
        if not (determinism.enabled() or num_contract.enabled()):
            return
        if self._exchange:
            return
        self.booster.scores = torch.from_numpy(self.scores)
        if determinism.enabled():
            determinism.window_digest(self.booster, int(it))
        if num_contract.enabled():
            num_contract.window_check(self.scores, it=int(it))

    def _train_one_iter(self, it: int) -> bool:
        from ..obs import health
        c, K, b = self.config, self.K, self.booster
        with span("stream.gradients", it=it):
            grad, hess, cs = self._gradients()
        stumps = 0
        for k in range(K):
            fmask = None
            if c.feature_fraction < 1.0:
                F = self.dd.num_features
                fmask = feature_mask(c.feature_fraction_seed, it * K + k, F,
                                     max(1, int(c.feature_fraction * F))
                                     ).to(self.device)
            wd = self._wd
            if wd is not None:
                wd.arm("stream.tree", it=it, k=k)
                health.stall_fault(wd)
            try:
                bt = self._build_tree(np.ascontiguousarray(grad[:, k]),
                                      np.ascontiguousarray(hess[:, k]),
                                      cs[k], fmask, k)
            finally:
                if wd is not None:
                    wd.disarm()
            if int(bt.num_leaves) <= 1:
                stumps += 1
                bt.leaf_value = torch.zeros_like(bt.leaf_value)
            b._pending.append((bt, b.shrinkage_rate, b._first_tree_bias()))
        if stumps == K:
            # as in memory: the all-stump iteration is dropped
            del b._pending[-K:]
            log_warning("stopped training because there are no more leaves "
                        f"that meet the split requirements (iteration "
                        f"{it + 1})")
            return True
        b.iter += 1
        return False

    def _stream_blocks(self, grad, hess, leaf2, body, store) -> None:
        """``body(i, leaf2 of block i on the device)`` for every block in
        order, then ``store(i, its result)``, which awaits it.  Pipelined,
        block i+1 is staged while block i runs, and its copy is queued
        before block i is awaited; otherwise block i+1 is staged and
        copied after."""
        nb, up = len(self.blocks), self._up
        if not nb:
            return
        up.finish(0, up.start(0, grad, hess))
        for bi in range(nb):
            ahead = (up.start(bi + 1, grad, hess)
                     if self.pipeline and bi + 1 < nb else None)
            with span("stream.fold", block=bi):
                out = body(bi, torch.from_numpy(leaf2[bi]).to(self.device))
            if ahead is not None:
                # block i+1's staging wait and copy, after block i's
                # kernels were launched and before they are awaited
                t0 = time.perf_counter()
                up.finish(bi + 1, ahead)
                counter_add("stream.pipeline.overlap_s",
                            time.perf_counter() - t0)
            store(bi, out)
            if not self.pipeline and bi + 1 < nb:
                up.finish(bi + 1, up.start(bi + 1, grad, hess))

    def _build_tree(self, grad: np.ndarray, hess: np.ndarray,
                    shard_cs, fmask, k: int):
        L, dev, fold = self.L, self.device, self.fold
        growth = self.growth
        wave_cap = growth.wave_size if growth.wave_size > 0 else L
        sum_g, sum_h, cnt = self._root_sums(shard_cs)
        s = root_state(self.dd, torch.empty((2, 0), dtype=torch.int32,
                                            device=dev),
                       sum_g, sum_h, cnt, growth, self.A)
        # each owned shard's quantization scales, over its own rows
        scales = ({sh: torch.as_tensor(
                      _fold_scales(grad[lo:hi], hess[lo:hi]), device=dev)
                   for sh, (lo, hi) in enumerate(self.ranges)
                   if sh in self.owned} if fold.quantized else {})
        # each block's (row leaf, hist leaf) between waves; padding rows
        # are -1 in both, as in memory
        leaf2 = []
        for _, _, m in self.blocks:
            l2 = np.full((2, self.R), -1, np.int32)
            l2[:, :m] = 0
            leaf2.append(l2)
        up = self._up      # the block uploads of this train() call
        wave = 0
        while True:
            done, nl = torch.stack([s.done.long(), s.nl]).tolist()
            if done or nl >= L:
                break
            tabs = _pending_tables(self.dd, s, L)
            accs = {sh: fold.init_acc() for sh in self.owned}

            def block(bi, l2):
                sh = self.block_shard[bi]
                bins_t, g, h = up.get(bi)
                if wave:
                    l2 = route_rows(bins_t, l2, *tabs)
                fold.fold(bins_t, g, h, l2[1].contiguous(), s.act_small,
                          accs[sh], scales.get(sh))   # into the carry
                return l2

            def store(bi, l2):
                leaf2[bi] = l2.cpu().numpy()
            self._stream_blocks(grad, hess, leaf2, block, store)
            new_h = self._shard_sum(
                {sh: fold.unpack(accs[sh], scales.get(sh))
                 for sh in self.owned}, "elastic.wave_hist")
            ids, res = rescan_changed(self.dd, growth, fmask, s, new_h)
            s = _apply_wave(s, s.leaf2, ids, res, self.A, growth,
                            wave_cap)
            wave += 1
            counter_add("stream.waves")

        # the last wave's splits, each row's leaf value, the scores
        tabs = _pending_tables(self.dd, s, L)
        lv = final_leaf_values(s, L)
        lr = self.booster.shrinkage_rate

        def final(bi, l2):
            bins_t, _, _ = up.get(bi)
            _, row_value = route_rows_values(bins_t, l2, *tabs, lv)
            start, stop, m = self.blocks[bi]
            sc = self._pad(self.scores[start:stop, k], m)
            return sc.add_(row_value, alpha=lr)

        def store_scores(bi, sc):
            start, stop, m = self.blocks[bi]
            self.scores[start:stop, k] = sc[:m].cpu().numpy()
        self._stream_blocks(grad, hess, leaf2, final, store_scores)
        counter_add("stream.trees")
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return finished_tree(s, L, empty, empty.float())

    def _shard_sum(self, parts, site: str):
        """Every shard's partial (this rank's ``{shard: tensor}``; in an
        elastic world the others' gathered from their owners at ``site``)
        added in shard order: the elementwise adds whichever rank computed
        which shard."""
        if self._exchange:
            merged = self._exchange_arrays(
                {str(s): p.cpu().numpy() for s, p in parts.items()},
                site=site)
            parts = {s: torch.as_tensor(a, device=self.device)
                     for s, a in merged.items()}
        out = parts[0]
        for s in range(1, self.S):
            out = out + parts[s]
        return out

    # -- the elastic protocol ---------------------------------------------
    def _exchange_arrays(self, payload, site: str = "elastic.exchange"
                         ) -> dict:
        """Allgather ``{shard: array}`` contributions and return the full
        ``{shard: array}`` map; every protocol shard must be covered (the
        ownership rule guarantees it: a hole is a protocol desync, not a
        recoverable fault).  ``site`` names the call point on the
        collective's span, so root-statistic, wave-histogram and score
        skew attribute apart.  The ``elastic.bytes_exchanged`` counter
        adds this rank's encoded payload."""
        from ..parallel.elastic import decode_array, encode_array
        enc = {s: encode_array(a) for s, a in payload.items()}
        counter_add("elastic.bytes_exchanged",
                    sum(len(v) for v in enc.values()))
        gathered = self.elastic.allgather(enc, site=site)
        merged = {}
        for part in gathered:
            merged.update(part or {})
        out = {}
        for s in range(self.S):
            text = merged.get(str(s))
            if text is None:
                raise RuntimeError(
                    f"elastic exchange is missing shard {s} of {self.S} "
                    f"(world {self.elastic.world}): ranks disagree on "
                    "the shard protocol")
            out[s] = decode_array(text)
        return out

    def _maybe_barrier(self, iteration: int) -> None:
        freq = int(self.config.snapshot_freq or 0)
        if freq <= 0 or iteration % freq != 0:
            return
        self._barrier_snapshot(iteration)

    def _barrier_snapshot(self, iteration: int) -> None:
        """The coordinated snapshot commit: this rank's shard states
        first, then a commit gather of ``(iteration, model digest, shard
        shas)`` on which every rank must agree, then rank 0 publishes the
        model text and the manifest (the manifest last: its appearance is
        the global commit marker), then a barrier.  A SIGKILL anywhere in
        the sequence leaves a complete barrier or a torn one that
        validation skips.  Outside an elastic run the world is this one
        process."""
        from .snapshot import (_sha256_bytes, commit_barrier, config_hash,
                               write_barrier_shard)
        run = self.elastic
        prefix = self.config.output_model
        shard_shas = {}
        for s in self.owned:
            lo, hi = self.ranges[s]
            shard_shas[s] = write_barrier_shard(prefix, iteration, s,
                                                self.scores[lo:hi])
        model_text = self.booster.save_model_to_string(-1)
        ack = {"iteration": int(iteration),
               "digest": _sha256_bytes(model_text.encode()),
               "shards": {str(s): sha for s, sha in shard_shas.items()}}
        acks = ([ack] if run is None else
                run.allgather(ack, site="elastic.barrier_commit"))
        head = (acks[0]["iteration"], acks[0]["digest"])
        for a in acks[1:]:
            if (a["iteration"], a["digest"]) != head:
                event("elastic", "barrier_mismatch",
                      iteration=int(iteration))
                raise RuntimeError(
                    f"barrier commit mismatch at iteration {iteration}: "
                    f"ranks disagree on (iteration, model digest) "
                    f"{[(a['iteration'], a['digest'][:12]) for a in acks]}"
                    "; refusing to publish a snapshot that is not "
                    "globally valid")
        if run is None or run.rank == 0:
            merged = {}
            for a in acks:
                merged.update({int(s): sha
                               for s, sha in a["shards"].items()})
            meta = {
                "num_shards": int(self.S),
                "world_size": int(run.world) if run is not None else 1,
                "generation": int(run.generation) if run is not None else 0,
                "config_hash": config_hash(self.config),
                "init_score_value": float(self.booster.init_score_value),
                "num_tree_per_iteration": int(self.K),
            }
            commit_barrier(prefix, iteration, model_text, merged, meta,
                           keep=max(int(self.config.snapshot_keep), 1))
        if run is not None:
            # every rank outlives the publish: a rank that ran ahead into
            # the next window could otherwise see a half-written commit
            run.barrier(f"barrier-committed-{iteration}")
        counter_add("elastic.barriers")

    def restore_barrier(self, prefix: Optional[str] = None,
                        iteration: Optional[int] = None,
                        model_sha: Optional[str] = None) -> int:
        """Adopt the newest committed barrier under ``prefix`` (default
        ``output_model``): the trees from its model text, the scores from
        its shard files; returns the restored iteration, 0 when there is
        nothing to restore.  Independent of the rank: every rank reads the
        same manifest, and shard files are keyed by protocol shard, not
        by the rank that wrote them.

        ``iteration`` and ``model_sha`` pin the barrier the elastic world
        agreed on (the protocol gather of ``train_elastic``): a rank that
        can no longer validate that barrier fails here instead of
        resuming another iteration than its peers."""
        from .snapshot import (barrier_paths, config_hash,
                               latest_valid_barrier, validate_barrier)
        prefix = prefix or self.config.output_model
        if iteration is None:
            man = latest_valid_barrier(prefix, num_shards=self.S)
            if man is None:
                return 0
        else:
            man = validate_barrier(barrier_paths(prefix, int(iteration))[1])
            if man is None \
                    or int(man.get("num_shards", -1)) != self.S \
                    or (model_sha is not None
                        and man.get("model_sha256") != model_sha):
                raise RuntimeError(
                    f"agreed barrier snapshot (iteration {iteration}) "
                    "is no longer restorable on this rank: it validated "
                    "during the restore gather but is now missing, torn, "
                    "or another model; refusing to resume from another "
                    "iteration than the rest of the world")
        if man.get("config_hash") and \
                man["config_hash"] != config_hash(self.config):
            raise ValueError(
                "cannot resume from barrier snapshot: the training "
                "config changed (it would train a different model under "
                "the same prefix); clear the barrier files or keep the "
                "config")
        if int(man.get("num_tree_per_iteration", self.K)) != self.K:
            raise ValueError("barrier snapshot objective shape does not "
                             "match this run")
        with open(man["model_path"]) as f:
            donor = GBDT(self.config, None, self.device)
            donor.load_model_from_string(f.read())
        light = self.booster.train_set
        fmap = {f: i for i, f in enumerate(light.used_features)}
        for t in donor.models:
            t.align_with_mappers(light.mappers, fmap)
        self.booster.models = list(donor.models)
        self.booster.iter = int(man["iteration"])
        self.booster.init_score_value = float(
            man.get("init_score_value", self.booster.init_score_value))
        for s, path in man["shard_paths"].items():
            lo, hi = self.ranges[int(s)]
            arr = np.load(path)["scores"]
            if arr.shape != (hi - lo, self.K):
                raise ValueError(
                    f"barrier shard {s} carries scores of shape "
                    f"{arr.shape}, expected {(hi - lo, self.K)}: the "
                    "data or the shard protocol changed under the prefix")
            self.scores[lo:hi] = arr
        counter_add("snapshot.barrier_resumes")
        log_info(f"restored barrier snapshot: iteration "
                 f"{self.booster.iter}, {len(man['shard_paths'])} shard "
                 f"states ({prefix})")
        return self.booster.iter

    def _sync_scores(self) -> None:
        """The end of an elastic run: every rank gathers the shards it
        does not own, so the returned booster's ``digest()`` covers every
        row on every rank."""
        payload = {str(s): self.scores[lo:hi]
                   for s, (lo, hi) in enumerate(self.ranges)
                   if s in self.owned}
        merged = self._exchange_arrays(payload, site="elastic.score_sync")
        for s, (lo, hi) in enumerate(self.ranges):
            self.scores[lo:hi] = merged[s]


def _config_and_source(params, source, cache_dir):
    """The parsed, checked config (with ``telemetry_output`` enabling the
    trace) and the stream source, files ingested into ``cache_dir``."""
    from ..io.outofcore import default_cache_dir, ingest
    config = Config.from_params(canonicalize_params(dict(params)))
    config.check()
    if config.telemetry_output:
        from .. import obs
        obs.enable(trace_path=str(config.telemetry_output))
    if isinstance(source, (list, tuple)):
        cdir = cache_dir or default_cache_dir(list(source))
        source = ingest(list(source), config, cdir)
    return config, source


def train_streaming(params, source, num_boost_round: Optional[int] = None,
                    cache_dir: Optional[str] = None,
                    block_rows: Optional[int] = None, device=None,
                    pipeline: bool = True, num_shards: int = 0) -> GBDT:
    """Train out-of-core on ``device`` (default: the ``device`` parameter,
    ``cuda`` unless set).  ``source`` is a ShardStore, a list of CSV, TSV
    or libsvm files (ingested into ``cache_dir`` first, by default
    ``LGBM_TPU_STREAM_CACHE`` or a ``.lgbm_shards`` directory beside the
    first file), or a resident BinnedDataset.  ``block_rows`` defaults to
    ``LGBM_TPU_STREAM_ROWS``, else 1,048,576; ``LGBM_TPU_STREAM_PIPELINE=0``
    turns the upload pipeline off.  ``num_shards`` (default:
    ``mesh_shape[0]`` under ``tree_learner=data``, else 1) sets the
    protocol shards.  ``telemetry_output`` enables the trace for the run.
    ``snapshot_freq`` commits a barrier snapshot under ``output_model``
    every that many iterations, and ``resume_from`` (a prefix, or
    ``"auto"``/``"latest"`` for ``output_model``) continues from the
    newest committed one of the same shard count, bit for bit.  Returns a
    GBDT booster (``save_model_to_string``, ``predict``, ``digest``)."""
    config, source = _config_and_source(params, source, cache_dir)
    trainer = StreamTrainer(config, source, block_rows=block_rows,
                            device=device, pipeline=pipeline,
                            num_shards=num_shards)
    if config.resume_from:
        prefix = config.resume_from
        if prefix in ("auto", "latest"):
            prefix = config.output_model
        with span("snapshot.resume"):
            if not trainer.restore_barrier(prefix):
                log_warning(f"resume_from={config.resume_from!r}: no "
                            f"committed barrier snapshot of "
                            f"{trainer.S} shards under {prefix!r}; "
                            "training from the start")
    return trainer.train(num_boost_round)


def elastic_shards(world: int, explicit: int = 0) -> int:
    """The run-lifetime protocol shard count: the explicit argument, else
    ``LGBM_TPU_ELASTIC_SHARDS``, else the initial world size.  Fixing S
    while the world varies is what lands every membership history on the
    same bytes (the model is a function of ``(data, config, S)``)."""
    s = int(explicit) or int(os.environ.get("LGBM_TPU_ELASTIC_SHARDS",
                                            "0") or 0)
    return s if s > 0 else max(int(world), 1)


def _write_elastic_summary(run) -> None:
    """The merged telemetry summary at the end of an elastic run, over the
    elastic allgather (elastic workers form no torch.distributed world):
    rank 0 writes ``<trace>.summary.json`` beside its trace file.  The
    gather is decided on shared state only (``run.world``), so every rank
    joins it or none does; whether a rank traces is decided after it.  A
    peer lost between the end of training and here must not restart the
    recovery over a summary, so elastic interrupts are swallowed (the
    model is already trained on every rank)."""
    import re
    from ..obs import merged_summary, telemetry, write_summary
    from ..parallel.elastic import ELASTIC_INTERRUPTS
    try:
        merged = (merged_summary(
                      lambda obj: run.allgather(obj, site="elastic.summary"))
                  if run.world > 1 else None)
    except ELASTIC_INTERRUPTS:
        return
    path = telemetry.trace_path()
    if not path or (run.world > 1 and run.rank != 0):
        return
    base = re.sub(r"\.rank\d+$", "", path)
    try:
        write_summary(base + ".summary.json", merged)
    except OSError:
        log_warning("elastic: failed to write merged summary "
                    f"({base}.summary.json)")


def train_elastic(params, source, num_boost_round: Optional[int] = None,
                  coordinator: Optional[str] = None,
                  cache_dir: Optional[str] = None,
                  block_rows: Optional[int] = None, num_shards: int = 0,
                  min_world: int = 1, client=None, max_recoveries: int = 64,
                  device=None) -> GBDT:
    """Train under the elastic protocol (``parallel/elastic.py``):
    rendezvous with the coordinator, stream-train the owned shards,
    commit a cross-rank barrier snapshot every ``snapshot_freq``
    iterations, and on any elastic interrupt (a lost rank, a membership
    change, an eviction) re-rendezvous at the new world size, own the
    shards again and resume from the newest barrier every member can
    read.  The recovered model is byte-identical to the uninterrupted run
    at any world size (``tools/chaos_torch.py`` is the gate).

    ``source`` follows :func:`train_streaming` (every member must see the
    same data and params: the protocol gather checks the config hash and
    the shard count).  ``coordinator`` defaults to ``LGBM_TPU_ELASTIC``;
    ``num_shards`` to :func:`elastic_shards`; ``device`` to the ``device``
    parameter (``cuda`` unless set).

    Recovery accounting (``obs/fleet.py``): each recovery is a
    :class:`~lightgbm_tpu_torch.obs.fleet.RecoveryEpisode` whose phases
    ``detect`` (from the moment the failed collective started), ``resync``,
    ``reshard``, ``restore`` and ``retrain`` (until boosting is back at
    the interrupted iteration) sum to its ``mttr_s``; ``/healthz`` walks
    ready -> recovering -> ready.  Telemetry: the ``elastic.rendezvous``,
    ``elastic.reshard`` and ``elastic.recover`` spans, the ``elastic.*``
    counters and the ``elastic:joined``, ``elastic:rank_lost`` and
    ``elastic:recover`` events."""
    from ..obs import fleet, health
    from ..obs.telemetry import hold_trace, release_trace, set_rank
    from ..parallel.elastic import (ELASTIC_INTERRUPTS, ElasticClient,
                                    ElasticRun, EvictedError,
                                    elastic_address)
    from .snapshot import barrier_candidates, config_hash
    config, source = _config_and_source(params, source, cache_dir)
    own_client = client is None
    if client is None:
        addr = coordinator or elastic_address()
        if addr is None:
            raise ValueError(
                "elastic training needs a coordinator: pass "
                "coordinator='host:port' or set LGBM_TPU_ELASTIC")
        client = ElasticClient(addr)
    episode = None           # the open recovery episode
    trainer = None
    try:
        # records of the rendezvous must not open the trace file before
        # this process knows its elastic rank: the coordinator's rank and
        # world are the trace identity
        hold_trace()
        try:
            world, _, _ = client.join_world(min_world=min_world)
            set_rank(client.rank, client.world)
        finally:
            release_trace()
        S = elastic_shards(world, num_shards)
        chash = config_hash(config)
        recoveries = 0
        while True:
            try:
                run = ElasticRun(client, S)
                # protocol agreement before any work: every member of this
                # generation trains the same config with the same shard
                # count.  The same gather carries each rank's view of the
                # committed barriers, so the world agrees on one restore
                # point up front
                cands = barrier_candidates(config.output_model,
                                           num_shards=S)
                views = run.allgather({
                    "shards": S, "config": chash,
                    "barriers": {str(i): sha for i, sha in cands.items()}},
                    site="elastic.protocol")
                proto = [{k: v for k, v in view.items() if k != "barriers"}
                         for view in views]
                for v in proto[1:]:
                    if v != proto[0]:
                        raise RuntimeError(
                            "elastic members disagree on the protocol "
                            f"({proto}); every member must train the "
                            "same params with the same shard count")
                common = set(views[0].get("barriers", {}).items())
                for v in views[1:]:
                    common &= set(v.get("barriers", {}).items())
                agreed = (max(common, key=lambda kv: int(kv[0]))
                          if common else None)
                with span("elastic.reshard", world=run.world,
                          generation=run.generation, shards=S):
                    trainer = StreamTrainer(config, source,
                                            block_rows=block_rows,
                                            device=device, num_shards=S,
                                            elastic=run)
                    if episode is not None:
                        episode.mark("reshard")
                    it0 = (trainer.restore_barrier(
                               iteration=int(agreed[0]),
                               model_sha=agreed[1])
                           if agreed else 0)
                    if episode is not None:
                        episode.mark("restore")
                if it0:
                    log_info(f"elastic: resuming from barrier iteration "
                             f"{it0} as rank {run.rank}/{run.world} "
                             f"(generation {run.generation})")
                if episode is not None:
                    # the trainer closes it (phase `retrain`) when boosting
                    # is back at the interrupted iteration
                    trainer.recovery_episode = episode
                    episode = None
                health.mark_ready()
                booster = trainer.train(num_boost_round)
                _write_elastic_summary(run)
                return booster
            except ELASTIC_INTERRUPTS as exc:
                recoveries += 1
                if recoveries > max_recoveries:
                    raise
                counter_add("elastic.recoveries")
                # a new episode opens when the failed collective started
                # to stall (the consumed client.op_started): the deadline
                # wait is the `detect` phase.  A repeated interrupt
                # subsumes any episode still open
                stall = client.op_started
                client.op_started = None
                if episode is not None:
                    episode.abandon()
                if trainer is not None \
                        and trainer.recovery_episode is not None:
                    trainer.recovery_episode.abandon()
                    trainer.recovery_episode = None
                episode = fleet.RecoveryEpisode(
                    error=type(exc).__name__,
                    generation=int(client.generation),
                    target_iter=(trainer.booster.iter
                                 if trainer is not None else 0),
                    stall_started=stall)
                episode.mark("detect")
                health.mark_recovering(reason=type(exc).__name__)
                with span("elastic.recover", error=type(exc).__name__):
                    event("elastic", "recover", error=type(exc).__name__,
                          generation=int(client.generation))
                    if isinstance(exc, EvictedError):
                        # an evicted member comes back as a fresh member
                        client.join_world(min_world=1)
                    else:
                        try:
                            client.resync()
                        except ELASTIC_INTERRUPTS:
                            client.join_world(min_world=1)
                set_rank(client.rank, client.world)
                episode.mark("resync")
                continue
    finally:
        if own_client:
            try:
                client.leave()
            finally:
                client.close()
