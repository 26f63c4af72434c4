"""Overlapped wave reduction: chunked async all-reduce with a
double-buffered sibling subtraction.

Port of the JAX package's ``ops/overlap.py``.  The data-parallel
learner's per-wave collective is one sum over the ranks of the
active-leaf histogram block ``[A, G, B, 3]`` (``parallel/learners.py``,
the ReduceScatter seam of the reference's
``data_parallel_tree_learner.cpp:147-162``).  Unoverlapped, the whole
reduction lands before the first sibling subtraction runs.  Here the
same logical reduction is issued as ``LGBM_TPU_OVERLAP_CHUNKS``
asynchronous ``all_reduce`` calls over disjoint column ranges, all in
flight at once; chunk ``c``'s sibling subtraction and state scatter run
after its own ``wait()``, while the later chunks are still on the wire.
The split scan still joins every chunk (its argmax spans all features).

Bitwise: an all-reduce sums elementwise across ranks, so reducing
disjoint column slices and concatenating is the whole block's reduction
bit for bit, and each chunk reads its parent columns before it writes
them, as the whole-block path does.

Schedule: one logical ``parallel.learners.hist_psum`` flight-recorder
record per wave with the full ``[A, G, B, 3]`` operand, the plain path's
fingerprint; the chunk bounds derive from the static column count, so
every rank issues the same physical sequence too.

Knobs: ``LGBM_TPU_OVERLAP=1`` enables it; unset or ``0``, the wave
takes one all-reduce (the JAX package defaults it on; here it is off
until a paired run on the card shows it gaining, since every run so far
measured it slower than one all-reduce, PERF.md).
``LGBM_TPU_OVERLAP_CHUNKS`` sets the chunk count (default 2, clamped to
the column count).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from ..obs.flight_recorder import record as _fr_record


def overlap_enabled() -> bool:
    """Whether the data-parallel wave reduction runs double-buffered
    (``LGBM_TPU_OVERLAP`` set and not ``0``; bitwise the plain
    schedule either way)."""
    return os.environ.get("LGBM_TPU_OVERLAP", "0") not in ("", "0")


def overlap_chunks() -> int:
    return max(1, int(os.environ.get("LGBM_TPU_OVERLAP_CHUNKS", "2") or 2))


def _chunk_bounds(G: int, chunks: int) -> List[Tuple[int, int]]:
    """Static column ranges: ``chunks`` near-equal slices of ``[0, G)``
    (at most one column per chunk)."""
    chunks = max(1, min(chunks, G))
    step = -(-G // chunks)
    return [(lo, min(lo + step, G)) for lo in range(0, G, step)]


def reduce_apply_overlapped(hist_state: torch.Tensor, new_h: torch.Tensor,
                            act_small: torch.Tensor, act_parent: torch.Tensor,
                            act_sibling: torch.Tensor, L: int, comm,
                            chunks: Optional[int] = None):
    """Double-buffered reduce + per-wave histogram bookkeeping: the
    overlapped drop-in for the all-reduce followed by
    ``learner/serial.py:apply_hist_wave``.  ``hist_state`` (``[L + 1,
    G, B, 3]``, its last slot the dump slot) is updated in place, and
    ``new_h`` is consumed (its chunks may be reduced in place); returns
    ``(ids [2A], grid [2A, G, B, 3])``, bitwise the unoverlapped path's.
    """
    if chunks is None:
        chunks = overlap_chunks()
    _fr_record("parallel.learners.hist_psum", "psum", comm.data_axis, new_h)
    parent_safe = act_parent.clamp(0, L - 1).long()
    dump = torch.full_like(act_small, L)
    small_slot = torch.where(act_small >= 0, act_small, dump).long()
    sib_slot = torch.where(act_sibling >= 0, act_sibling, dump).long()
    bounds = _chunk_bounds(new_h.shape[1], chunks)
    parts = [new_h[:, lo:hi].contiguous() for lo, hi in bounds]
    # every chunk's reduction in flight before the first is consumed
    works = [comm.all_reduce_sum(p, async_op=True) for p in parts]
    sib_parts: List[torch.Tensor] = []
    for (lo, hi), h_c, work in zip(bounds, parts, works):
        work.wait()
        cols = hist_state[:, lo:hi]
        sib_c = cols[parent_safe] - h_c
        cols.index_put_((small_slot,), h_c)
        cols.index_put_((sib_slot,), sib_c)
        sib_parts.append(sib_c)
    new_h_red = torch.cat(parts, dim=1)
    sib_h = torch.cat(sib_parts, dim=1)
    ids = torch.cat([act_small, act_sibling])
    grid = torch.cat([new_h_red, sib_h], dim=0)
    return ids, grid
