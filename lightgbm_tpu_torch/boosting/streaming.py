"""Streamed out-of-core training (a port of the JAX package's
``boosting/streaming.py`` for one shard).

Rows live in the mmap-able shard store (``io/outofcore.py``), not on
the device: per tree, row blocks stream host -> device once per wave;
each block is routed through the partial tree (the route kernel K2) and
its active-leaf histograms fold into one carried accumulator (the
seeded wide kernel K5, or the seeded leaf-compacted kernel K3 on
quantized waves wider than 32 slots), unpacked once per wave.  Past the
kernels' domain (groups of more than 256 bins, trees of more than 1,024
leaves) the carry is the exact-f32 ``[A, G, B, 3]`` grid that the seeded
wide histogram adds each block into (``hist_wide_raw(..., acc=)``), and
every wave takes ``build_tree_wide``'s plan, ``round8(L / 2)`` slots;
the bins stream as the store holds them, uint8 or int32.  Device memory
follows the block size, never the row count: only the gradients,
hessians, scores and each block's two leaf vectors live on the host.

The streamed model equals the in-memory one (``lgb.train`` on the same
rows) bitwise on the quantized modes, scores included:

1. **Carried folds.**  The quantized kernels add int32 values, exact in
   any order, and every block of a tree quantizes with one scale pair,
   the host absmax over all rows (:func:`_fold_scales`), bitwise the
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

Supported: gbdt boosting with the row-wise objectives (the regression,
binary, multiclass and cross-entropy families: a block's gradients are
its rows' gradients), K trees an iteration for the multiclass ones (one
set of gradients an iteration, each class's tree streamed in turn, its
feature mask keyed on ``iter * K + k``), weights, ``feature_fraction``,
one shard.  These raise, as in the JAX package: leaf-renewal objectives
(L1, quantile, MAPE re-fit leaves from every row's score), ranking (row
blocks would split queries), bagging (its ``[n]`` device mask breaks
the memory contract), ``boosting != gbdt``, custom objectives,
EFB-bundled resident sources, and the data-parallel stream
(``tree_learner=data``, S > 1; ROADMAP A11/A12).
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
from ..obs import counter_add, span
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
    check_unported_options(config, streamed=True)
    bad = None
    if config.boosting_type != "gbdt":
        bad = f"boosting={config.boosting_type} (host score patching)"
    elif config.bagging_freq > 0 and config.bagging_fraction < 1.0:
        bad = ("bagging (the [n]-shaped device mask breaks the "
               "block-memory contract)")
    elif config.tree_learner != "serial" or config.num_machines > 1:
        bad = (f"tree_learner={config.tree_learner} (the data-parallel "
               "stream over several shards is not ported yet: ROADMAP "
               "A11/A12)")
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
    train scores are the streamed host score state."""

    _wd = None                  # the stall watchdog, live inside train()

    def __init__(self, config: Config, source,
                 block_rows: Optional[int] = None, device=None,
                 pipeline: bool = True):
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
        # blocks are whole root-statistic chunks (the chunk-sum contract)
        # and no longer than the padded stream
        if not block_rows:
            block_rows = stream_rows() or DEFAULT_BLOCK_ROWS
        R = -(-max(1, int(block_rows)) // STREAM_CHUNK) * STREAM_CHUNK
        self.R = min(R, -(-n // STREAM_CHUNK) * STREAM_CHUNK)
        self.blocks: List[Tuple[int, int, int]] = [
            (lo, min(lo + self.R, n), min(lo + self.R, n) - lo)
            for lo in range(0, n, self.R)]
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
        # domain, build_tree_wide's round8(L / 2) slots past it
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

    def _check_fits(self) -> None:
        """Refuse, before any upload, a scatter stream whose per-leaf
        histograms, one wave's grids and carry, two device blocks (each
        with its transposed bins) and a block's histogram scratch exceed
        the card's memory: every term follows the block size, the leaves
        and the bins, never the row count (on the CPU the host's
        allocator decides)."""
        if self.device.type != "cuda":
            return
        dd, R, L, A = self.dd, self.R, self.L, self.A
        G, Bh = dd.num_groups, bin_stride(dd.group_max_bins)
        hist = wide_hist_bytes(L, G, Bh) + A * G * Bh * 12
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
        """-> host (grad [n, K], hess [n, K]) and each class's root chunk
        sums ``[3, m]``: each block's gradients on the device from its
        scores, labels and weights (the objectives are row-wise, so a
        block's slice equals the in-memory rows)."""
        obj, K = self.objective, self.K
        grad = np.empty((self.n, K), np.float32)
        hess = np.empty((self.n, K), np.float32)
        sums = [[] for _ in range(K)]
        for start, stop, m in self.blocks:
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
                sums[k].append(root_chunk_sums(g[:, k].contiguous(),
                                               h[:, k].contiguous(), mask))
            grad[start:stop] = g[:m].cpu().numpy()
            hess[start:stop] = h[:m].cpu().numpy()
        m_chunks = -(-self.n // STREAM_CHUNK)
        cs = [torch.cat(sk, dim=1)[:, :m_chunks] for sk in sums]
        return grad, hess, cs

    # -- training ---------------------------------------------------------
    def train(self, num_iterations: Optional[int] = None) -> GBDT:
        """Boost to ``num_iterations``.  The ops plane is mounted
        (``LGBM_TPU_OPS_PORT``), the health plane marks the run
        (``warming`` until the first iteration, then ``ready``), the stall
        watchdog (``LGBM_TPU_WATCHDOG_S``) is armed around each streamed
        tree, and every iteration boundary feeds the determinism and ulp
        contracts from the host scores (:meth:`_window_contracts`)."""
        from ..obs import determinism, health, num_contract, ops_plane
        iters = num_iterations or self.config.num_iterations
        if self.booster.iter == 0:
            if determinism.enabled():
                determinism.reset()
            if num_contract.enabled():
                num_contract.reset()
        ops_plane.mount("train")
        self._wd = health.Watchdog.maybe("stream")
        health.mark_warming("stream")
        self._up = _BlockUploader(self.src, self.blocks, self.R, self.device,
                                  self.pipeline)
        try:
            with span("stream.train", rows=self.n, block=self.R, shards=1):
                for it in range(self.booster.iter, iters):
                    stop = self._train_one_iter(it)
                    health.mark_ready()
                    self._window_contracts(it + 1)
                    if stop:
                        break
        finally:
            self._up.close()
            if self._wd is not None:
                self._wd.stop()
                self._wd = None
        self.booster.scores = torch.from_numpy(self.scores)
        return self.booster

    def _window_contracts(self, it: int) -> None:
        """Iteration-boundary sampling for the determinism digest ledger
        (``LGBM_TPU_DETERMINISM=1``) and the ulp ledger
        (``LGBM_TPU_NUM_CONTRACT=1``) over the host score state; nothing
        when neither is on."""
        from ..obs import determinism, num_contract
        if not (determinism.enabled() or num_contract.enabled()):
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
                    cs: torch.Tensor, fmask, k: int):
        L, dev, fold = self.L, self.device, self.fold
        growth = self.growth
        wave_cap = growth.wave_size if growth.wave_size > 0 else L
        sum_g, sum_h, cnt = reduce_chunk_sums(cs)
        s = root_state(self.dd, torch.empty((2, 0), dtype=torch.int32,
                                            device=dev),
                       sum_g, sum_h, cnt, growth, self.A)
        scales = (torch.as_tensor(_fold_scales(grad, hess), device=dev)
                  if fold.quantized else None)
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
            acc = fold.init_acc()

            def block(bi, l2):
                bins_t, g, h = up.get(bi)
                if wave:
                    l2 = route_rows(bins_t, l2, *tabs)
                fold.fold(bins_t, g, h, l2[1].contiguous(), s.act_small,
                          acc, scales)                # into acc
                return l2

            def store(bi, l2):
                leaf2[bi] = l2.cpu().numpy()
            self._stream_blocks(grad, hess, leaf2, block, store)
            new_h = fold.unpack(acc, scales)
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


def train_streaming(params, source, num_boost_round: Optional[int] = None,
                    cache_dir: Optional[str] = None,
                    block_rows: Optional[int] = None, device=None,
                    pipeline: bool = True) -> GBDT:
    """Train out-of-core on ``device`` (default: the ``device`` parameter,
    ``cuda`` unless set).  ``source`` is a ShardStore, a list of CSV, TSV
    or libsvm files (ingested into ``cache_dir`` first, by default
    ``LGBM_TPU_STREAM_CACHE`` or a ``.lgbm_shards`` directory beside the
    first file), or a resident BinnedDataset.  ``block_rows`` defaults to
    ``LGBM_TPU_STREAM_ROWS``, else 1,048,576; ``LGBM_TPU_STREAM_PIPELINE=0``
    turns the upload pipeline off.  ``telemetry_output`` enables the
    trace for the run.  Returns a GBDT booster
    (``save_model_to_string``, ``predict``, ``digest``)."""
    from ..io.outofcore import default_cache_dir, ingest
    config = Config.from_params(canonicalize_params(dict(params)))
    config.check()
    if config.telemetry_output:
        from .. import obs
        obs.enable(trace_path=str(config.telemetry_output))
    if isinstance(source, (list, tuple)):
        cdir = cache_dir or default_cache_dir(list(source))
        source = ingest(list(source), config, cdir)
    trainer = StreamTrainer(config, source, block_rows=block_rows,
                            device=device, pipeline=pipeline)
    return trainer.train(num_boost_round)
