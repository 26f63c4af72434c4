"""Micro-batching serving harness over a :class:`CompiledModel`.

Port of the JAX package's ``serve/server.py``.  Many small concurrent
prediction requests share one card: requests land in a queue and a
worker thread coalesces up to ``max_batch`` rows or ``max_wait_ms``,
whichever comes first, into one scoring call, padded to the smallest
configured bucket.  Every bucket's CUDA graph is captured during warmup
(:meth:`CompiledModel.warm`), so steady traffic only replays graphs;
``stats()`` reports ``steady_captures`` (graph captures after warmup)
and ``steady_eager`` (batches scored outside a graph after warmup), the
port's counterpart of the JAX package's zero-recompile contract.  On the
card the worker scores on a stream of its own.

Delivery contract: every accepted request is resolved EXACTLY once —
with its scores, or (after the retry budget is exhausted, or on a
non-transient fault) with the scoring exception.  Scoring runs through
``utils/retry.retry_call`` under the ``serve.score`` fault point
(``utils/faults.py``), so a mid-batch transient re-scores the whole
batch (a pure function) without dropping or double-resolving any
request.  ``close()`` drains the queue: requests accepted before
shutdown are scored before the worker exits.  Per-bucket request
latency accumulates into bounded rolling quantile sketches
(``obs/ops_plane.RollingQuantiles``).

Telemetry (the JAX package's names): the ``serve.batch`` span (one per
coalesced batch, with rows/bucket/requests), the counters
``serve.requests``, ``serve.batches``, ``serve.rows_batched``,
``serve.padded_rows``, ``serve.oversize_batches`` and
``serve.dispatch_gap_s`` / ``serve.dispatch_gaps`` (host time between one
batch's return and the next batch).  The runtime contracts: with
``LGBM_TPU_OPS_PORT`` set the server mounts ``/metrics`` and
``/healthz`` (``obs/ops_plane.py``) and wires ``/drain`` to itself (stop
accepting, flush every queued request, report); ``LGBM_TPU_WATCHDOG_S``
arms the stall watchdog around each coalesced batch
(``obs/health.py``); ``LGBM_TPU_MEM_CONTRACT=1`` samples device memory
once a batch (the ``serve_mem_contract`` section);
``LGBM_TPU_TRACE_CONTRACT=1`` runs the server under a compile tracker
whose steady mark follows ``warm()`` (the ``serve_trace_contract``
section on :meth:`close`); each batch is a profiler step
(``obs/profiler.py``).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import counter_add, event, set_section, span
from ..obs import health as obs_health
from ..obs import ops_plane as obs_ops
from ..obs import profiler as obs_profiler
from ..obs.lock_contract import named_lock
from ..obs.mem_contract import maybe_watermark
from ..obs.ops_plane import RollingQuantiles
from ..obs.trace_contract import CompileTracker, contract_enabled
from ..utils.faults import fault_point
from ..utils.log import log_info, log_warning
from ..utils.retry import RetryPolicy, retry_call
from .compiler import CompiledModel, next_bucket

_SENTINEL = object()


class _Request:
    __slots__ = ("rows", "future", "t_enqueue")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


def _default_buckets(max_batch: int, min_bucket: int) -> List[int]:
    out = []
    b = min_bucket
    top = next_bucket(max_batch, min_bucket)
    while b < top:
        out.append(b)
        b *= 4
    out.append(top)
    return out


class PredictionServer:
    """Async micro-batching front end for a compiled model.

    ``submit(x)`` returns a ``concurrent.futures.Future`` resolving to
    the prediction for ``x`` (one row ``[F]`` or a block ``[k, F]``);
    ``predict(x)`` is the blocking convenience.  ``close()`` drains and
    stops the worker.
    """

    def __init__(self, model: CompiledModel, *, max_batch: int = 4096,
                 max_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 raw_score: bool = False, binned: bool = False,
                 min_bucket: int = 64, warmup: bool = True,
                 retry_policy: Optional[RetryPolicy] = None):
        self.model = model
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.raw_score = raw_score
        self.binned = binned
        self.min_bucket = int(min_bucket)
        self.buckets = sorted(set(int(b) for b in buckets)) if buckets \
            else _default_buckets(self.max_batch, self.min_bucket)
        self._retry = retry_policy
        self._q: "queue.Queue" = queue.Queue()
        self._lock = named_lock("serve")
        self._closed = False
        self._n_submitted = 0
        self._n_resolved = 0
        self._n_failed = 0
        self._n_batches = 0
        self._n_rows = 0
        self._n_padded = 0
        self._latency: Dict[int, RollingQuantiles] = {}
        self._carry: List[_Request] = []    # worker-only: batch overflow
        # worker-only: the previous batch's return, for the dispatch gap
        self._t_last_dispatch: Optional[float] = None
        # the compile tracker (track_threads=False: the worker's graph
        # captures are the contract here)
        self._tracker: Optional[CompileTracker] = None
        if contract_enabled():
            self._tracker = CompileTracker(track_threads=False).__enter__()
        # sampled once a batch on the worker; warmup 2: the first batches
        # still allocate bucket result buffers
        self._mem_wm = maybe_watermark("serve", "serve_mem_contract",
                                       warmup=2,
                                       device=model.device).__enter__()
        self._ops = obs_ops.mount("serve")
        if self._ops is not None:
            self._ops.register_drain(self._drain_report)
        self._wd = obs_health.Watchdog.maybe("serve")
        obs_health.mark_warming("serve")
        if warmup:
            self.warm()
        if self._tracker is not None:
            self._tracker.mark_steady()
        obs_health.mark_ready()
        self._captures0 = model.captures
        self._eager0 = model.eager_calls
        self._thread = threading.Thread(
            target=self._run, name="lgbm-torch-serve", daemon=True)
        self._thread.start()

    # -- lifecycle -------------------------------------------------------
    def warm(self) -> None:
        """Capture every bucket's graph (idempotent after the first)."""
        self.model.warm(self.buckets, binned=self.binned)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue and stop the worker.  Requests submitted
        before close are scored; submit afterwards raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        obs_health.mark_draining(plane="serve")
        self._q.put(_SENTINEL)
        self._thread.join(timeout)
        if self._wd is not None:
            self._wd.stop()
            self._wd = None
        if self._tracker is not None:
            self._tracker.__exit__(None, None, None)
            rep = self._tracker.report()
            set_section("serve_trace_contract", rep)
            if not rep["steady_ok"]:
                event("contract", "serve_recompile_after_warmup",
                      count=rep["compiles_steady"],
                      names=rep["steady_names"])
                log_warning(
                    f"serve trace contract violated: "
                    f"{rep['compiles_steady']} compile event(s) after "
                    f"warmup ({', '.join(rep['steady_names'][:5])})")
            self._tracker = None
        if self._mem_wm is not None:
            rep = self._mem_wm.finalize("serve_mem_contract")
            self._mem_wm = None
            if not rep["steady_ok"]:
                log_warning(
                    f"serve mem contract violated: "
                    f"{rep['violation_count']} watermark crossing(s) — "
                    f"a per-batch leak in the serving path")
        log_info(f"serve: drained ({self._n_resolved} resolved, "
                 f"{self._n_failed} failed, {self._n_batches} batches)")

    def _drain_report(self) -> Dict:
        """The ops plane's ``/drain`` hook: stop accepting, flush every
        queued request (exactly-once delivery holds through the drain)
        and report the final stats."""
        self.close()
        rep = self.stats()
        rep["drained"] = True
        return rep

    def __enter__(self) -> "PredictionServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- request API -----------------------------------------------------
    def submit(self, x: np.ndarray) -> Future:
        rows = np.asarray(x)
        if rows.ndim == 1:
            rows = rows[None, :]
        if not self.binned:
            rows = np.ascontiguousarray(rows, np.float32)
        req = _Request(rows)
        with self._lock:
            if self._closed:
                raise RuntimeError("PredictionServer is closed")
            self._n_submitted += 1
            # queue under the admission lock: close() flips _closed under
            # the same lock before posting the drain sentinel, so every
            # admitted request is queued ahead of the drain
            self._q.put(req)
        counter_add("serve.requests")
        return req.future

    def predict(self, x: np.ndarray, timeout: Optional[float] = 60.0):
        return self.submit(x).result(timeout)

    def stats(self) -> Dict:
        """Counts + per-bucket latency percentiles (ms) over the
        bounded rolling window (p50/p99/p99.9; ``count`` stays
        all-time), and the graph captures and eager batches after
        warmup."""
        with self._lock:
            lat = {b: s.stats_ms() for b, s in self._latency.items()
                   if s.count}
            out = {
                "submitted": self._n_submitted,
                "resolved": self._n_resolved,
                "failed": self._n_failed,
                "batches": self._n_batches,
                "rows": self._n_rows,
                "padded_rows": self._n_padded,
                "pending": self._n_submitted - self._n_resolved
                           - self._n_failed,
            }
        out["steady_captures"] = self.model.captures - self._captures0
        out["steady_eager"] = self.model.eager_calls - self._eager0
        out["latency_ms"] = lat
        return out

    # -- worker ----------------------------------------------------------
    def _collect(self, first: "_Request") -> List["_Request"]:
        """Coalesce queued requests behind ``first`` up to max_batch
        rows or the max-wait deadline.  A request that would overflow
        ``max_batch`` is carried into the NEXT batch instead — batches
        never outgrow the largest bucket unless a single request
        already does."""
        batch = [first]
        rows = first.rows.shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            wait = deadline - time.perf_counter()
            try:
                item = self._q.get(timeout=max(wait, 0.0)) if wait > 0 \
                    else self._q.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                # keep draining after this batch; re-post so the outer
                # loop sees the shutdown marker AFTER the queue empties
                self._q.put(_SENTINEL)
                break
            if rows + item.rows.shape[0] > self.max_batch:
                self._carry.append(item)
                break
            batch.append(item)
            rows += item.rows.shape[0]
        return batch

    def _bucket_for(self, n: int) -> int:
        """Smallest CONFIGURED bucket >= n.  Only a single request
        larger than every bucket escapes the warmed set (padded to its
        own power of two and scored eagerly)."""
        for b in self.buckets:
            if n <= b:
                return b
        counter_add("serve.oversize_batches")
        return next_bucket(n, self.min_bucket)

    def _score(self, X: np.ndarray) -> np.ndarray:
        fault_point("serve.score")
        return self.model.predict(X, raw_score=self.raw_score,
                                  binned=self.binned, pad=False)

    def _run_batch(self, batch: List["_Request"]) -> None:
        X = batch[0].rows if len(batch) == 1 else np.concatenate(
            [r.rows for r in batch])
        n = X.shape[0]
        bucket = self._bucket_for(n)
        if bucket != n:
            X = np.concatenate(
                [X, np.zeros((bucket - n,) + X.shape[1:], X.dtype)])
        t_prev = self._t_last_dispatch
        if t_prev is not None:
            counter_add("serve.dispatch_gap_s",
                        time.perf_counter() - t_prev)
            counter_add("serve.dispatch_gaps")
        if self._wd is not None:
            self._wd.arm("serve.batch", batch=self._n_batches,
                         bucket=bucket)
            obs_health.stall_fault(self._wd)
        try:
            with span("serve.batch") as s, \
                    obs_profiler.step("serve.batch", self._n_batches):
                s["rows"] = n
                s["bucket"] = bucket
                s["requests"] = len(batch)
                try:
                    out = retry_call(self._score, X, policy=self._retry,
                                     what="serve.score")
                except Exception as exc:  # noqa: BLE001 - into futures
                    log_warning(f"serve: batch of {len(batch)} "
                                f"request(s) failed after retries: {exc}")
                    with self._lock:
                        self._n_failed += len(batch)
                    for r in batch:
                        r.future.set_exception(exc)
                    return
        finally:
            if self._wd is not None:
                self._wd.disarm()
        out = np.asarray(out)[:n]
        now = time.perf_counter()
        self._t_last_dispatch = now
        with self._lock:
            self._n_batches += 1
            self._n_rows += n
            self._n_padded += bucket - n
            lat = self._latency.setdefault(bucket, RollingQuantiles())
        counter_add("serve.batches")
        counter_add("serve.rows_batched", n)
        counter_add("serve.padded_rows", bucket - n)
        if self._mem_wm is not None:
            # only the worker samples it
            self._mem_wm.sample("serve.batch", bucket=bucket)
        off = 0
        for r in batch:
            k = r.rows.shape[0]
            res = out[off:off + k]
            off += k
            with self._lock:
                self._n_resolved += 1
                lat.observe(now - r.t_enqueue)
            # exactly once: a Future can only be resolved once — a
            # retry re-scores the batch but delivery happens here, once
            r.future.set_result(res[0] if k == 1 else res)

    def _run(self) -> None:
        dev = self.model.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        draining = False
        while True:
            if self._carry:
                item = self._carry.pop(0)
            elif draining:
                # drain anything still queued (pre-close requests are
                # FIFO-ahead of the sentinel) then exit
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return
            else:
                item = self._q.get()
            if item is _SENTINEL:
                draining = True
                continue
            self._run_batch(self._collect(item))
