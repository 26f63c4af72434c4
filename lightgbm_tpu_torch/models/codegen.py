"""Model -> if-else code generation.

Counterpart of the reference ``ModelToIfElse``
(``src/boosting/gbdt_model_text.cpp:51-233``) and of the JAX package's
``models/codegen.py``: emits a standalone C++ translation unit with one
``PredictTreeN`` function per tree plus an aggregate ``Predict``.  The
reference CI compiles it and holds its predictions to the model's within
1e-5 (``.travis/test.sh:60-64``); ``tests/test_torch_codegen.py`` does
the same.  It reads the host trees of ``models/tree.py``: ``threshold``,
``decision_type``, the children, ``leaf_value`` and, for a categorical
node, ``threshold_bin`` (its bitset index) into ``cat_boundaries`` /
``cat_threshold``, which trained and loaded trees fill alike.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _node_code(t, node: int, indent: str) -> str:
    if node < 0:
        leaf = ~node
        return f"{indent}return {float(t.leaf_value[leaf])!r};\n"
    is_cat = bool(t.decision_type[node] & 1)
    default_left = bool(t.decision_type[node] & 2)
    missing = (int(t.decision_type[node]) >> 2) & 3
    f = int(t.split_feature[node])
    out = ""
    if is_cat:
        ci = int(t.threshold_bin[node])
        words = t.cat_threshold[t.cat_boundaries[ci]:t.cat_boundaries[ci + 1]]
        vals = [v for v in range(len(words) * 32)
                if words[v // 32] & (1 << (v % 32))]
        cond = " || ".join(f"ivalue == {v}" for v in vals) or "false"
        out += f"{indent}{{ const int ivalue = static_cast<int>(arr[{f}]);\n"
        out += f"{indent}if (!std::isnan(arr[{f}]) && ({cond})) {{\n"
        out += _node_code(t, int(t.left_child[node]), indent + "  ")
        out += f"{indent}}} else {{\n"
        out += _node_code(t, int(t.right_child[node]), indent + "  ")
        out += f"{indent}}} }}\n"
        return out
    thr = float(t.threshold[node])
    fval = f"arr[{f}]"
    miss_cond = ""
    if missing == 2:       # NaN
        miss_cond = f"std::isnan({fval})"
    elif missing == 1:     # Zero
        miss_cond = f"(std::fabs({fval}) <= 1e-35 || std::isnan({fval}))"
    cond = f"{fval} <= {thr!r}"
    if miss_cond:
        if default_left:
            cond = f"({miss_cond}) || (!( {miss_cond} ) && ({cond}))"
        else:
            cond = f"!({miss_cond}) && ({cond})"
    elif missing == 0:
        # NaN converted to 0.0 when feature has no NaN bin (tree.h:215-222)
        cond = f"(std::isnan({fval}) ? 0.0 <= {thr!r} : {fval} <= {thr!r})"
    out += f"{indent}if ({cond}) {{\n"
    out += _node_code(t, int(t.left_child[node]), indent + "  ")
    out += f"{indent}}} else {{\n"
    out += _node_code(t, int(t.right_child[node]), indent + "  ")
    out += f"{indent}}}\n"
    return out


def model_to_ifelse(gbdt) -> str:
    """Emit C++ with PredictTreeN per tree + Predict sum."""
    # the first line is the JAX package's emitter's, so that both emit
    # the same text for one model
    lines: List[str] = [
        "// generated by lightgbm_tpu model_to_ifelse",
        "#include <cmath>",
        "#include <cstdlib>",
        "",
    ]
    T = len(gbdt.models)
    for i, t in enumerate(gbdt.models):
        lines.append(f"static double PredictTree{i}(const double* arr) {{")
        if t.num_leaves == 1:
            lines.append(f"  return {float(t.leaf_value[0])!r};")
        else:
            lines.append(_node_code(t, 0, "  ").rstrip("\n"))
        lines.append("}")
        lines.append("")
    K = max(1, gbdt.num_tree_per_iteration)
    lines.append("extern \"C\" void Predict(const double* arr, "
                 "double* out) {")
    for k in range(K):
        terms = " + ".join(f"PredictTree{i}(arr)"
                           for i in range(k, T, K)) or "0.0"
        lines.append(f"  out[{k}] = {terms};")
    lines.append("}")
    lines.append("")
    return "\n".join(lines)
