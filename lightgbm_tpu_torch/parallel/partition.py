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
rules decide what is checked instead.  On the training path
``MeshContext.place_data`` checks that the ``data/<field>`` names
resolve and that a replicated one holds the same bytes on every rank;
on the serving path ``serve/compiler.py:build_pack`` passes every tensor
field of the ``ServePack`` it built through :func:`match_partition_rules`
(the JAX package's ``place_pack`` without a mesh), so a pack field that
no rule names fails when the pack is built.
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


def serve_pack_fields() -> List[str]:
    """The tensor fields of the port's ``ServePack`` (its dataclass
    fields but the three ints), in declaration order."""
    import dataclasses
    from ..serve.compiler import ServePack
    return [f.name for f in dataclasses.fields(ServePack)
            if f.name not in ("num_trees", "num_class", "max_depth")]


def serve_pack_names(pack) -> Dict[str, Any]:
    """``{"serve": {"pack": {field: tensor}}}`` of a ``ServePack``'s
    tensors (an optional table the pack does not hold, None, is left
    out: there is nothing to place)."""
    return {"serve": {"pack": {f: getattr(pack, f)
                               for f in serve_pack_fields()
                               if getattr(pack, f) is not None}}}


def flatten_names(tree: Any, sep: str = "/") -> List[Tuple[str, Any]]:
    """A dict name tree flattened to ``[(joined_name, leaf), ...]``."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
        else:
            out.append((prefix, node))

    walk("", tree)
    return out


def persistent_names(num_valid: int = 1) -> List[str]:
    """The persistent names the rules must cover (the JAX package's
    ``persistent_names``): the ``DeviceData`` fields, the booster's state,
    each valid set's, early stopping's, and the port's own ``ServePack``
    tensor fields."""
    names = [f"data/{n}" for n in DEVICE_DATA_NAMES]
    names += ["scores", "grad", "hess", "bag_mask", "feature_mask"]
    for i in range(num_valid):
        names += [f"valid/{i}/scores"]
        names += [f"valid/{i}/data/{n}" for n in DEVICE_DATA_NAMES]
    names += ["es/best_scores", "es/best_iter"]
    names += [f"serve/pack/{f}" for f in serve_pack_fields()]
    return names


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


def match_partition_rules(rules: Sequence[Rule], tree: Any,
                          sep: str = "/") -> Dict[str, Spec]:
    """``{flat_name: spec}`` of a dict name tree: a scalar or 0-d leaf
    replicates, every other leaf must match a rule (else
    :class:`PartitionRuleError`)."""
    specs: Dict[str, Spec] = {}
    for name, leaf in flatten_names(tree, sep):
        specs[name] = (() if getattr(leaf, "ndim", 0) == 0
                       else match_name(rules, name))
    return specs


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
