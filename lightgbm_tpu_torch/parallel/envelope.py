"""Multi-device divergence envelope: the near-tie flip budget.

A copy of the JAX package's ``parallel/envelope.py`` (numpy only) for
the port's trees and model strings.  The reference's distributed
contract is bit-identical trees on every machine
(``application.cpp:249-254``); a data-parallel histogram sum
reassociates f32 adds per shard layout, so gain ties can flip split
winners.  This module gates that: for every row whose serial and
distributed leaf differ it walks both trees down the row's bin vector
to the first node where their split content diverges, and asserts

* the row-leaf mismatch fraction is under a hard ceiling
  (``mismatch_ceiling``), and
* every divergence point's winning-vs-losing gain gap is inside the
  near-tie margin (``rel_margin`` relative to the larger gain, plus an
  absolute ``abs_margin`` floor for near-zero gains).

Two divergence kinds carry no comparable gain pair and are classified
apart: **budget flips** (one tree split a region the other left as a
leaf) and **renumberings** (identical predicates end to end, only the
leaf ids differ; the two leaf values must agree within
``value_margin``).  The margins are the JAX package's (calibrated there
on its 8-way CPU mesh at the bench's shape).

:func:`model_flip_report` / :func:`assert_model_flip_envelope` classify
two training paths' divergence at the model-text level: the structural
prefix must match exactly and the first flip must be a near tie.  On a
violation the asserts raise with the report and the collective flight
recorder's last-K schedule (``obs/flight_recorder.py``).

Scope: numerical (non-categorical), fully-observed features.  The
walker self-validates against ``row_leaf`` before trusting its own
routing, so a semantics drift fails loudly rather than passing the
gate.  Trees may hold numpy arrays or torch tensors on any device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _host(x, dtype=None) -> np.ndarray:
    """A numpy copy of an array or (any device's) tensor."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _tree_arrays(tree) -> Dict[str, np.ndarray]:
    return {
        "feature": _host(tree.feature),
        "threshold": _host(tree.threshold_bin),
        "left": _host(tree.left_child),
        "right": _host(tree.right_child),
        "gain": _host(tree.gain, np.float64),
        "num_leaves": int(tree.num_leaves),
    }


def _walk(t: Dict[str, np.ndarray], bins_row: np.ndarray):
    """Yield the (node, feature, threshold, gain) path of one row; the
    walk ends when a child is a leaf (``~leaf`` encoding)."""
    node = 0
    if t["num_leaves"] <= 1:
        return
    while True:
        f = int(t["feature"][node])
        thr = int(t["threshold"][node])
        yield node, f, thr, float(t["gain"][node])
        child = (t["left"][node] if int(bins_row[f]) <= thr
                 else t["right"][node])
        if child < 0:
            return
        node = int(child)


def _walk_leaf(t: Dict[str, np.ndarray], bins_row: np.ndarray) -> int:
    node = 0
    if t["num_leaves"] <= 1:
        return 0
    while True:
        f = int(t["feature"][node])
        child = (t["left"][node]
                 if int(bins_row[f]) <= int(t["threshold"][node])
                 else t["right"][node])
        if child < 0:
            return ~int(child)
        node = int(child)


def near_tie_report(serial, dist, bins: np.ndarray,
                    max_rows: int = 20_000) -> Dict[str, Any]:
    """Measure the divergence envelope between a serial and a
    distributed :class:`BuiltTree` over the binned matrix ``bins``.

    Returns a report dict: mismatch fraction, the measured near-tie
    gain gaps at every divergence point (max/mean, relative), budget
    flips, and the first divergence example for debugging."""
    ts, td = _tree_arrays(serial), _tree_arrays(dist)
    lv_s = _host(serial.leaf_value, np.float64)
    lv_d = _host(dist.leaf_value, np.float64)
    rl_s = _host(serial.row_leaf)
    rl_d = _host(dist.row_leaf)
    n = min(len(rl_s), len(rl_d), len(bins))
    mism = np.nonzero(rl_s[:n] != rl_d[:n])[0]
    report: Dict[str, Any] = {
        "rows": int(n),
        "mismatched_rows": int(len(mism)),
        "mismatch_fraction": float(len(mism) / max(n, 1)),
        "divergence_points": 0,
        "budget_flips": 0,
        "renumbered_rows": 0,
        "max_rel_gain_gap": 0.0,
        "mean_rel_gain_gap": 0.0,
        "max_renumbered_value_gap": 0.0,
        "walker_validated_rows": 0,
        "first_divergence": None,
        "gaps": [],
    }
    if not len(mism):
        return report
    rows = mism[:max_rows]
    # self-validate routing semantics on the rows we are about to judge
    # (plus they ARE the interesting rows): the numpy walker must agree
    # with the device row_leaf of BOTH trees, or the gate's geometry is
    # wrong and its verdict meaningless
    bad = 0
    for r in rows[:256]:
        if (_walk_leaf(ts, bins[r]) != int(rl_s[r])
                or _walk_leaf(td, bins[r]) != int(rl_d[r])):
            bad += 1
    if bad:
        raise AssertionError(
            f"envelope walker disagrees with device routing on "
            f"{bad}/256 sampled rows — missing/categorical semantics "
            f"in play; the near-tie gate only covers numerical "
            f"fully-observed features")
    report["walker_validated_rows"] = int(min(len(rows), 256))

    gaps = []
    seen_points = set()
    for r in rows:
        it_s = _walk(ts, bins[r])
        it_d = _walk(td, bins[r])
        while True:
            s = next(it_s, None)
            d = next(it_d, None)
            if s is None and d is None:
                # identical predicates end to end: the leaf ID differs
                # only because split ORDER numbered it differently —
                # the regions match, so the VALUES must too
                report["renumbered_rows"] += 1
                vgap = abs(lv_s[int(rl_s[r])] - lv_d[int(rl_d[r])])
                if vgap > report["max_renumbered_value_gap"]:
                    report["max_renumbered_value_gap"] = float(vgap)
                break
            if s is None or d is None:
                # one tree split this region further: the leaf budget
                # went elsewhere (frontier-ordering tie) — no gain pair
                report["budget_flips"] += 1
                break
            (ns, fs, th_s, g_s) = s
            (nd, fd, th_d, g_d) = d
            if fs == fd and th_s == th_d:
                continue
            key = (ns, nd)
            if key not in seen_points:
                seen_points.add(key)
                denom = max(abs(g_s), abs(g_d), 1e-12)
                gap = abs(g_s - g_d)
                gaps.append([gap / denom, gap, g_s, g_d, int(ns),
                             int(nd)])
                if report["first_divergence"] is None:
                    report["first_divergence"] = {
                        "row": int(r), "serial_node": int(ns),
                        "dist_node": int(nd),
                        "serial_split": (int(fs), int(th_s)),
                        "dist_split": (int(fd), int(th_d)),
                        "serial_gain": g_s, "dist_gain": g_d,
                    }
            break
    report["divergence_points"] = len(gaps)
    report["gaps"] = gaps
    if gaps:
        rels = [g[0] for g in gaps]
        report["max_rel_gain_gap"] = float(max(rels))
        report["mean_rel_gain_gap"] = float(np.mean(rels))
    return report


def assert_envelope(serial, dist, bins: np.ndarray,
                    mismatch_ceiling: float = 0.03,
                    rel_margin: float = 0.05,
                    abs_margin: float = 0.5,
                    value_margin: float = 0.05,
                    label: str = "data-parallel",
                    report: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Gate the divergence envelope; raises AssertionError (with the
    report and the flight recorder's last-K collective schedule) on a
    ceiling or near-tie violation.  Returns the report when clean."""
    rep = report if report is not None else near_tie_report(
        serial, dist, bins)
    problems = []
    if rep["mismatch_fraction"] > mismatch_ceiling:
        problems.append(
            f"row-leaf mismatch {rep['mismatch_fraction']:.4f} exceeds "
            f"the hard ceiling {mismatch_ceiling}")
    # a gain gap is a violation only if it clears BOTH margins:
    # relative for real gains, absolute for the ~zero-gain noise floor
    bad_gaps = [g for g in rep["gaps"]
                if g[0] > rel_margin and g[1] > abs_margin]
    if bad_gaps:
        worst = max(bad_gaps)
        problems.append(
            f"{len(bad_gaps)} divergence point(s) outside the "
            f"near-tie margin (rel {rel_margin}, abs {abs_margin}); "
            f"worst: rel_gap={worst[0]:.3e} abs_gap={worst[1]:.3e} "
            f"gains=({worst[2]:.6f}, {worst[3]:.6f}) at serial node "
            f"{worst[4]} / dist node {worst[5]} — this is NOT f32 "
            f"reassociation noise; suspect a histogram-merge or "
            f"collective-layout bug")
    if rep["max_renumbered_value_gap"] > value_margin:
        problems.append(
            f"a 'renumbered' leaf pair (identical split path) has "
            f"leaf-value gap {rep['max_renumbered_value_gap']:.3e} > "
            f"{value_margin}: same region, different value — the "
            f"histogram sums themselves diverged")
    if problems:
        from ..obs.flight_recorder import dump_to_summary, snapshot
        dump_to_summary(f"envelope.{label}")
        sched = snapshot()["last"][-12:]
        lines = [f"  {e['seq']}: {e['site']} {e['op']} axis={e['axis']} "
                 f"shape={e['shape']}" for e in sched]
        brief = {k: v for k, v in rep.items() if k != "gaps"}
        raise AssertionError(
            f"multi-chip divergence envelope violated ({label}):\n- "
            + "\n- ".join(problems)
            + f"\nreport: {brief}"
            + "\nlast recorded collective schedule (flight recorder):\n"
            + ("\n".join(lines) if lines else "  <empty>"))
    return rep


# ----------------------------------------------------------------------
# Model-level flip envelope: two training paths of one configuration.
#
# Two paths that run the same math in another order (another summation
# order, another device, another reduction) drift in the last ulp of
# the histogram sums, and therefore of the recorded gains and leaf
# values, from the first tree.  Most of the time the drift is
# invisible; occasionally it flips a near-tie split winner or a
# missing-direction choice, after which the two models fit different
# residuals and every later tree legitimately diverges.  The tree-level
# near_tie_report above can't gate this axis (it needs row_leaf vectors
# of a single tree pair); this section classifies the divergence at the
# MODEL-TEXT level instead: the structural prefix must match exactly,
# the first flip must be a genuine near-tie, and nothing past the flip
# is compared (incomparable by construction).

def _parse_model_trees(model_str: str):
    """Parse the reference text format into per-tree numpy arrays."""
    trees, cur = [], None
    for line in model_str.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif line.startswith("end of trees"):
            cur = None
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            cur[k] = v
    out = []
    for t in trees:
        d: Dict[str, Any] = {"num_leaves": int(t.get("num_leaves", "1"))}
        for k, dt in (("split_feature", np.int64),
                      ("decision_type", np.int64),
                      ("left_child", np.int64), ("right_child", np.int64),
                      ("split_gain", np.float64), ("threshold", np.float64),
                      ("leaf_value", np.float64)):
            v = t.get(k, "").split()
            d[k] = (np.asarray(v, dtype=dt) if v
                    else np.zeros(0, dtype=dt))
        out.append(d)
    return out


def model_flip_report(model_a: str, model_b: str,
                      rel_margin: float = 0.05,
                      abs_margin: float = 0.5) -> Dict[str, Any]:
    """Compare two trained models (text format) tree by tree in boosting
    order and classify the FIRST structural divergence.

    Node numbering follows split order, so two trees that made the same
    choices have identical (feature, threshold, decision_type, children)
    arrays; thresholds come from the shared f64 bin uppers and compare
    exactly.  The first differing node is the flip point — its two
    recorded gains are the winning gains of two candidates over (modulo
    f32 reassociation) the same histogram, so a legitimate flip requires
    them to be nearly equal, exactly the near-tie argument
    :func:`near_tie_report` makes per row.  Kinds:

    * ``near_tie_flip`` — different split content at the flip node;
      near-tie iff the gain gap is inside ``rel_margin`` OR
      ``abs_margin`` (violating BOTH = corruption, same calibration as
      :func:`assert_envelope`);
    * ``missing_direction`` — same feature+threshold, only the
      default-direction bit differs (the missing-side allocation was the
      tie); gains are the same split's and must agree within margins;
    * ``budget_flip`` — equal common prefix but one tree recorded more
      splits (min_data/min_gain boundary); near-tie iff the extra gain
      is small vs the tree's max gain or under ``abs_margin``.

    Identical-prefix trees also contribute ``max_leaf_value_gap`` (the
    f32 value envelope; the tree-level gate measured 0.0104 serial-side).
    """
    ta, tb = _parse_model_trees(model_a), _parse_model_trees(model_b)
    report: Dict[str, Any] = {
        "trees": int(min(len(ta), len(tb))),
        "prefix_trees": 0, "flip_tree": None, "flip_node": None,
        "flip_kind": None, "gain_a": None, "gain_b": None,
        "rel_gain_gap": None, "abs_gain_gap": None, "near_tie": True,
        "max_leaf_value_gap": 0.0,
    }

    def _near(ga: float, gb: float) -> bool:
        gap = abs(ga - gb)
        return (gap / max(abs(ga), abs(gb), 1e-12) <= rel_margin
                or gap <= abs_margin)

    for i, (x, y) in enumerate(zip(ta, tb)):
        m = min(len(x["split_feature"]), len(y["split_feature"]))
        neq = np.zeros(m, dtype=bool)
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            neq |= x[k][:m] != y[k][:m]
        diff = np.nonzero(neq)[0]
        if not len(diff) and (len(x["split_feature"])
                              == len(y["split_feature"])):
            if len(x["leaf_value"]) == len(y["leaf_value"]) and m >= 0:
                gap = (float(np.max(np.abs(x["leaf_value"]
                                           - y["leaf_value"])))
                       if len(x["leaf_value"]) else 0.0)
                report["max_leaf_value_gap"] = max(
                    report["max_leaf_value_gap"], gap)
            report["prefix_trees"] = i + 1
            continue
        report["flip_tree"] = i
        if len(diff):
            j = int(diff[0])
            ga = float(x["split_gain"][j])
            gb = float(y["split_gain"][j])
            same_split = (x["split_feature"][j] == y["split_feature"][j]
                          and x["threshold"][j] == y["threshold"][j])
            report["flip_kind"] = ("missing_direction" if same_split
                                   else "near_tie_flip")
        else:
            # equal prefix, one tree kept splitting: judge the first
            # extra split's gain against the tree's own scale
            j = m
            longer = x if len(x["split_feature"]) > m else y
            ga = float(longer["split_gain"][m])
            gb = 0.0
            scale = float(np.max(longer["split_gain"])) if m else ga
            report["flip_kind"] = "budget_flip"
            report.update(flip_node=j, gain_a=ga, gain_b=gb,
                          abs_gain_gap=ga,
                          rel_gain_gap=ga / max(scale, 1e-12),
                          near_tie=(ga <= abs_margin
                                    or ga / max(scale, 1e-12)
                                    <= rel_margin))
            break
        gap = abs(ga - gb)
        report.update(flip_node=j, gain_a=ga, gain_b=gb,
                      abs_gain_gap=gap,
                      rel_gain_gap=gap / max(abs(ga), abs(gb), 1e-12),
                      near_tie=_near(ga, gb))
        break
    return report


def assert_model_flip_envelope(model_a: str, model_b: str,
                               rel_margin: float = 0.05,
                               abs_margin: float = 0.5,
                               value_margin: float = 0.05,
                               label: str = "block-vs-eager"
                               ) -> Dict[str, Any]:
    """Gate the model-level flip envelope; raises on a non-near-tie flip
    or a prefix leaf-value gap outside the f32 envelope.  Returns the
    report (``flip_tree`` None when the models match structurally)."""
    rep = model_flip_report(model_a, model_b,
                            rel_margin=rel_margin, abs_margin=abs_margin)
    problems = []
    if rep["flip_tree"] is not None and not rep["near_tie"]:
        problems.append(
            f"first structural divergence (tree {rep['flip_tree']}, node "
            f"{rep['flip_node']}, kind {rep['flip_kind']}) is NOT a "
            f"near-tie: gains=({rep['gain_a']:.6f}, {rep['gain_b']:.6f}) "
            f"rel_gap={rep['rel_gain_gap']:.3e} "
            f"abs_gap={rep['abs_gain_gap']:.3e} — this is not f32 "
            f"reassociation noise; suspect a mask or histogram bug")
    if rep["max_leaf_value_gap"] > value_margin:
        problems.append(
            f"identical-structure trees have leaf-value gap "
            f"{rep['max_leaf_value_gap']:.3e} > {value_margin}: same "
            f"regions, different values — the histogram sums diverged")
    if problems:
        raise AssertionError(
            f"model flip envelope violated ({label}):\n- "
            + "\n- ".join(problems) + f"\nreport: {rep}")
    return rep
