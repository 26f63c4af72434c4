"""Plotting utilities (reference python-package/lightgbm/plotting.py; a
copy of the JAX package's ``plotting.py``): plot_importance,
plot_metric, plot_tree / create_tree_digraph.  matplotlib and graphviz
are imported when a function is called, and a missing one raises
ImportError with the reference's message."""
from __future__ import annotations

import numpy as np


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, **kwargs):
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot importance.")
    from .basic import Booster
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be Booster or LGBMModel.")
    importance = booster.feature_importance(importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples) if tuples else ((), ())
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None, xlim=None,
                ylim=None, title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, grid=True):
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot metric.")
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        eval_results = dict(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = dict(booster)
    else:
        raise TypeError("booster must be dict (evals_result) or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")
    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    first = eval_results[dataset_names[0]]
    if metric is None:
        metric = list(first.keys())[0]
    for name in dataset_names:
        results = eval_results[name][metric]
        ax.plot(range(1, len(results) + 1), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        name=None, comment=None, **kwargs):
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree.")
    from .basic import Booster
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        booster = booster.booster_
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range.")
    tree = model["tree_info"][tree_index]
    show_info = show_info or []
    graph = Digraph(name=name, comment=comment, **kwargs)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            nid = f"split{node['split_index']}"
            label = (f"{model['feature_names'][node['split_feature']]} "
                     f"{node['decision_type']} "
                     f"{round(node['threshold'], precision)}")
            for info in show_info:
                if info in node:
                    label += f"\n{info}: {round(node[info], precision)}"
            graph.node(nid, label=label)
            add(node["left_child"], nid, "yes")
            add(node["right_child"], nid, "no")
        else:
            nid = f"leaf{node.get('leaf_index', 0)}"
            label = f"leaf {node.get('leaf_index', 0)}: " \
                    f"{round(node['leaf_value'], precision)}"
            if "leaf_count" in node and "leaf_count" in show_info:
                label += f"\ncount: {node['leaf_count']}"
            graph.node(nid, label=label)
        if parent is not None:
            graph.edge(parent, nid, decision)

    add(tree["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None, show_info=None,
              precision=3, **kwargs):
    try:
        import matplotlib.pyplot as plt
        import matplotlib.image as mpimg
    except ImportError:
        raise ImportError("You must install matplotlib to plot tree.")
    import io
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.imshow(img)
    ax.axis("off")
    return ax
