"""The port's plotting helpers (``lightgbm_tpu_torch/plotting.py``) held
against the JAX package's on the same model, at toy size on the CPU:
the graphviz source of a tree and, on matplotlib's Agg backend, the bars
of ``plot_importance`` and the lines of ``plot_metric``.  One model text
is loaded into both packages, so every drawn number has one source.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.plotting import create_tree_digraph as j_digraph

import lightgbm_tpu_torch as tlgb

torch.set_num_threads(1)   # tiny tensors: more threads only spin


@pytest.fixture(scope="module")
def models():
    """``(JAX Booster, port Booster)`` holding the same model text, and the
    port's own fitted regressor with its evaluation record."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(800, 5)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] + 0.3 * rng.normal(size=800)).astype(
        np.float32)
    reg = tlgb.LGBMRegressor(n_estimators=4, num_leaves=7, verbose=-1,
                             device="cpu").fit(X, y, eval_set=[(X, y)])
    text = reg.booster_.model_to_string()
    return (jlgb.Booster(model_str=text),
            tlgb.Booster(model_str=text, device="cpu"), reg)


@pytest.mark.parametrize("show_info", [None, ["split_gain",
                                              "internal_value",
                                              "leaf_count"]])
def test_create_tree_digraph_matches_reference(models, show_info):
    pytest.importorskip("graphviz")
    jb, tb, reg = models
    for tree in (0, 3):
        got = tlgb.create_tree_digraph(tb, tree_index=tree,
                                       show_info=show_info, precision=4)
        want = j_digraph(jb, tree_index=tree, show_info=show_info,
                         precision=4)
        assert got.source == want.source
    assert tlgb.create_tree_digraph(reg).source == \
        tlgb.create_tree_digraph(tb).source
    with pytest.raises(IndexError):
        tlgb.create_tree_digraph(tb, tree_index=4)


def _bars(ax):
    return [(p.get_width(), p.get_y()) for p in ax.patches], \
        [t.get_text() for t in ax.get_yticklabels()]


def test_plot_importance_matches_reference(models):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    jb, tb, reg = models
    for kw in ({}, {"importance_type": "gain", "max_num_features": 2}):
        got = tlgb.plot_importance(tb, **kw)
        want = jlgb.plot_importance(jb, **kw)
        assert _bars(got) == _bars(want)
        assert got.get_title() == want.get_title()
        plt.close("all")
    assert _bars(tlgb.plot_importance(reg)) == _bars(tlgb.plot_importance(tb))
    plt.close("all")
    with pytest.raises(TypeError):
        tlgb.plot_importance("not a booster")


def test_plot_metric_matches_reference(models):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    _, _, reg = models
    record = reg.evals_result_
    got = tlgb.plot_metric(reg)
    want = jlgb.plot_metric(dict(record))
    lines = [(list(ln.get_xdata()), list(ln.get_ydata()))
             for ln in got.get_lines()]
    assert lines == [(list(ln.get_xdata()), list(ln.get_ydata()))
                     for ln in want.get_lines()]
    assert lines[0][1] == record["valid_0"]["l2"]
    assert got.get_ylabel() == want.get_ylabel() == "l2"
    plt.close("all")
    with pytest.raises(ValueError):
        tlgb.plot_metric({})


def test_plot_tree_needs_graphviz_binary(models):
    mpl = pytest.importorskip("matplotlib")
    pytest.importorskip("graphviz")
    import shutil
    if shutil.which("dot") is None:
        pytest.skip("graphviz's dot binary is not installed")
    mpl.use("Agg")
    _, tb, _ = models
    ax = tlgb.plot_tree(tb, tree_index=1)
    assert ax.images
