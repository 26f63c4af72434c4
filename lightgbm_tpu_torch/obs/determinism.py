"""Runtime reproducibility contract (``LGBM_TPU_DETERMINISM=1``).

A copy of the JAX package's ``obs/determinism.py``: training is a pure
function of (data, config, seeds), and three instruments show it at run
time:

* **Canonical digests** — :func:`model_digest` hashes every host tree's
  canonical fields plus the float32 score state (sha256).  Under the
  contract the training loop samples a digest at every iteration
  boundary into an ``(iteration, digest)`` ledger
  (:func:`window_digest`); two runs from the same seeds give the same
  ledger, and :func:`first_divergence` names the first window where
  two ledgers part.
* **RNG ledger** — every keyed RNG derivation site calls :func:`rng_site`
  with its ``(site, key path)``; the counts land in the ``determinism``
  summary section, so a replayed run can show that its derivation
  traffic matched too.
* **Cross-rank window check** — in a multi-process run the latest
  window digest (:func:`fingerprint`; trees only, since each rank's
  scores are its own rows) rides the eval-window metric allgather
  (``engine.py``), and :func:`window_check` names the first rank whose
  model differs from rank 0's: the model is replicated state, so any
  mismatch is a determinism bug.

The ``det.rng_drift`` fault (``utils/faults.py``) makes DART draw the
next iteration's uniforms, and the ledger names the first window that
diverged.

Digest canonicalization (the same as the JAX package's, so digests of
the two packages compare like for like): per host tree, ``num_leaves``
and ``num_cat`` (int64), ``split_feature`` (int32), ``threshold``
(float64), ``decision_type`` (int8), children (int32), ``leaf_value``
(float64), and the categorical bitsets; then, optionally, the running
float32 train scores in C order.  Gain and count diagnostics and
``threshold_bin`` are left out.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .telemetry import event as obs_event
from .telemetry import set_section

__all__ = ["enabled", "reset", "rng_site", "model_digest", "tree_digest",
           "window_digest", "fingerprint", "window_check", "section",
           "first_divergence"]


def enabled() -> bool:
    return os.environ.get("LGBM_TPU_DETERMINISM", "0") == "1"


# ledger state (process-wide, reset per run by the training loop / tests)
_SITES: Dict[str, Dict] = {}
_DIGESTS: List[Tuple[int, str]] = []


def reset() -> None:
    _SITES.clear()
    _DIGESTS.clear()


def rng_site(site: str, key_path: str, n: int = 1) -> None:
    """Record ``n`` derivations at a keyed RNG ``site`` whose key is
    derived along ``key_path`` (e.g. ``"drop_seed/iteration"``).  No-op
    unless the contract is armed."""
    if not enabled():
        return
    entry = _SITES.setdefault(site, {"key_path": key_path, "count": 0})
    entry["count"] += n


def tree_digest(h, t) -> None:
    """Feed one host tree's canonical fields into hasher ``h``."""
    n = int(t.num_leaves)
    m = max(0, n - 1)
    h.update(np.int64([n, int(t.num_cat)]).tobytes())
    h.update(np.ascontiguousarray(t.split_feature[:m], np.int32).tobytes())
    h.update(np.ascontiguousarray(t.threshold[:m], np.float64).tobytes())
    h.update(np.ascontiguousarray(t.decision_type[:m], np.int8).tobytes())
    h.update(np.ascontiguousarray(t.left_child[:m], np.int32).tobytes())
    h.update(np.ascontiguousarray(t.right_child[:m], np.int32).tobytes())
    h.update(np.ascontiguousarray(t.leaf_value[:n], np.float64).tobytes())
    if t.num_cat:
        h.update(np.asarray(t.cat_boundaries, np.int64).tobytes())
        h.update(np.asarray(t.cat_threshold, np.uint32).tobytes())


def model_digest(gbdt, include_scores: bool = True) -> str:
    """sha256 hex digest of every host tree plus, when
    ``include_scores``, the float32 train-score state."""
    h = hashlib.sha256()
    for t in gbdt.models:
        tree_digest(h, t)
    scores = getattr(gbdt, "scores", None)
    if include_scores and scores is not None:
        h.update(np.ascontiguousarray(np.asarray(
            scores.cpu() if hasattr(scores, "cpu") else scores),
            np.float32).tobytes())
    return h.hexdigest()


def window_digest(gbdt, it: int) -> str:
    """Sample the digest at an iteration boundary into the run ledger and
    refresh the ``determinism`` summary section (a multi-process booster,
    ``gbdt._pr`` set, digests its trees only)."""
    d = model_digest(gbdt, include_scores=getattr(gbdt, "_pr", None) is None)
    _DIGESTS.append((int(it), d))
    set_section("determinism", section())
    return d


def fingerprint() -> str:
    """The latest sampled digest (rides the multi-process eval-window
    allgather: no collective of its own)."""
    return _DIGESTS[-1][1] if _DIGESTS else ""


def window_check(fingerprints: List[str], it: int) -> bool:
    """Cross-rank digest comparison at a window boundary.  True when
    every rank's digest is rank 0's; on a mismatch a
    ``det:digest_mismatch`` event names the window and the first
    diverging rank."""
    if not fingerprints or all(f == fingerprints[0] for f in fingerprints):
        return True
    bad = next(i for i, f in enumerate(fingerprints)
               if f != fingerprints[0])
    obs_event("det", "digest_mismatch", window_it=int(it),
              first_diverging_rank=bad,
              digests=[f[:12] for f in fingerprints])
    from ..utils.log import log_warning
    log_warning(f"determinism contract violation at window it={it}: "
                f"rank {bad} model digest {fingerprints[bad][:12]} != "
                f"rank 0 {fingerprints[0][:12]}")
    return False


def section() -> Dict:
    """The ``determinism`` summary section: the RNG ledger's counters and
    the windowed digest ledger."""
    return {"sites": {k: dict(v) for k, v in sorted(_SITES.items())},
            "digests": [[it, d] for it, d in _DIGESTS]}


def first_divergence(a: List, b: List) -> Optional[Tuple[int, str, str]]:
    """Compare two digest ledgers ``[[it, digest], ...]``: None when
    identical, else ``(window_it, digest_a, digest_b)`` of the first
    diverging window (a missing window counts as divergence)."""
    for (ia, da), (ib, db) in zip(a, b):
        if ia != ib or da != db:
            return (int(ia), str(da), str(db))
    if len(a) != len(b):
        n = min(len(a), len(b))
        longer = a if len(a) > len(b) else b
        return (int(longer[n][0]), "<absent>" if len(a) <= n else a[n][1],
                "<absent>" if len(b) <= n else b[n][1])
    return None
