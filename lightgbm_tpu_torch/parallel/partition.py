"""Partition rules: one named placement decision for every persistent
tensor of a distributed run.

The JAX package's ``parallel/partition.py`` without ``NamedSharding``.
Every persistent tensor is named in a flat ``/``-separated name tree and
placed by matching the name against an ordered table of ``(rule_name,
regex, spec)`` rules.  A spec is a tuple: ``(axis,)`` splits the leading
(row) axis over the ranks of the data axis, ``()`` replicates.

Contract (as in the JAX package): every persistent name matches exactly
one rule; :func:`match_name` raises :class:`PartitionRuleError` on a name
that matches none (never a silent default), and :func:`audit_rules`
reports names that match none or several.

Name tree:

==========================  =============================================
``data/<field>``            training ``DeviceData`` tensors (``data/bins``
                            row-split for data/voting, replicated for
                            feature-parallel; metadata replicated)
``scores``                  running train scores (replicated)
``valid/<i>/scores``        running valid scores (replicated)
``valid/<i>/data/<field>``  valid ``DeviceData`` tensors (replicated)
``grad`` / ``hess``         per-iteration gradients (row-split for
                            data/voting)
``bag_mask``                row-sampling mask (row-split)
``feature_mask``            per-tree feature mask (replicated)
``es/<key>``                early-stopping state (replicated)
``serve/pack/<field>``      compiled ``ServePack`` tensors (replicated)
==========================  =============================================

Each rank of the port is one process that already holds its part (its
own rows under a split rule, ``ProcessRows``), so nothing is laid out
from one process as the JAX package's single-process mesh does; the
rules decide what ``MeshContext.place_data`` checks on the training
path: the ``data/<field>`` names resolve, and a replicated one holds the
same bytes on every rank.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Sequence, Tuple

Spec = Tuple[str, ...]
Rule = Tuple[str, str, Spec]

# the name ``data/<field>`` of each tensor field of the port's DeviceData
# (the JAX package's field names: the port stores bins transposed)
DEVICE_DATA_NAMES = {
    "bins": "bins_t", "bin_offsets": "bin_offsets", "num_bins": "num_bins",
    "default_bins": "default_bins", "missing_types": "missing_types",
    "is_categorical": "is_categorical", "nan_bins": "nan_bins",
    "feat_group": "feat_group", "feat_offset": "feat_offset"}


class PartitionRuleError(ValueError):
    """A persistent tensor name did not match exactly one partition rule."""


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------
def train_rules(data_axis: str = "data",
                row_sharded: bool = True) -> Tuple[Rule, ...]:
    """The training-side rule table.  ``row_sharded``: data- and
    voting-parallel split the row axis, feature-parallel replicates rows
    (its learner slices feature columns instead).  The regexes are
    mutually exclusive (``data/bins`` is carved out of the metadata rule
    by a lookahead), so every name can match exactly one."""
    row: Spec = (data_axis,) if row_sharded else ()
    return (
        ("bins",         r"^data/bins$",            row),
        ("data_meta",    r"^data/(?!bins$)",        ()),
        ("scores",       r"^scores$",               ()),
        ("valid_scores", r"^valid/\d+/scores$",     ()),
        ("valid_data",   r"^valid/\d+/data/",       ()),
        ("grad_hess",    r"^(grad|hess)$",          row),
        ("bag_mask",     r"^bag_mask$",             row),
        ("feature_mask", r"^feature_mask$",         ()),
        ("es_state",     r"^es/",                   ()),
    ) + serve_rules()


def serve_rules() -> Tuple[Rule, ...]:
    """Serve-side rules: the compiled forest is replicated."""
    return (("serve_pack", r"^serve/pack/", ()),)


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------
def device_data_names(dd) -> Dict[str, Any]:
    """``{name: tensor}`` of a ``DeviceData``'s persistent tensors."""
    return {name: getattr(dd, field)
            for name, field in DEVICE_DATA_NAMES.items()}


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------
def matching_rules(rules: Sequence[Rule], name: str) -> List[str]:
    return [rn for rn, rx, _ in rules if re.search(rx, name) is not None]


def match_name(rules: Sequence[Rule], name: str) -> Spec:
    """The first matching rule's spec for ``name``; an unmatched name is
    a hard error."""
    for _, rx, spec in rules:
        if re.search(rx, name) is not None:
            return spec
    raise PartitionRuleError(
        f"no partition rule matches persistent tensor {name!r}; add a "
        f"rule to lightgbm_tpu_torch/parallel/partition.py (rules: "
        f"{[r[0] for r in rules]})")


def audit_rules(rules: Sequence[Rule], names: Iterable[str]) -> List[str]:
    """Every name must match exactly one rule: human-readable findings
    (empty when clean)."""
    findings = []
    for name in names:
        hits = matching_rules(rules, name)
        if len(hits) == 0:
            findings.append(f"{name}: matches NO partition rule")
        elif len(hits) > 1:
            findings.append(
                f"{name}: matches {len(hits)} rules {hits} (must be 1)")
    return findings
