"""Model digests — the reproducibility contract's unit of comparison.

Copied from the JAX package's ``obs/determinism.py`` (``tree_digest`` /
``model_digest``) with the same field canonicalization, so digests of
the two packages compare like for like: per host tree, ``num_leaves``
and ``num_cat`` (int64), ``split_feature`` (int32), ``threshold``
(float64), ``decision_type`` (int8), children (int32), ``leaf_value``
(float64), and the categorical bitsets; then, optionally, the running
float32 train scores.
"""
from __future__ import annotations

import hashlib

import numpy as np


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
        h.update(np.ascontiguousarray(scores.cpu().numpy(),
                                      np.float32).tobytes())
    return h.hexdigest()
