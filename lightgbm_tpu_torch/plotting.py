"""Plotting utilities.

Counterpart of lightgbm_tpu/plotting.py, which mirrors
python-package/lightgbm/plotting.py: plot_importance:38, plot_metric:231,
plot_tree / create_tree_digraph:780. matplotlib and graphviz are optional
and imported inside the functions, with clear errors, like the
reference's compat layer: importing this module needs neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .basic import Booster


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "You must install matplotlib to use plotting functions") from e


def _to_booster(obj) -> Booster:
    if isinstance(obj, Booster):
        return obj
    if hasattr(obj, "booster_"):
        return obj.booster_
    raise TypeError("booster must be a Booster or fitted LGBMModel")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type="split", max_num_features=None,
                    ignore_zero=True, figsize=None, dpi=None, grid=True,
                    precision=3, **kwargs):
    """reference: plotting.py plot_importance:38."""
    plt = _check_matplotlib()
    booster = _to_booster(booster)
    importance = booster.feature_importance(importance_type=importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("There are no importances to plot")
    labels, values = zip(*tuples)

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain" else str(x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    else:
        ax.set_ylim(-1, len(values))
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster_or_record, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title="Metric during training", xlabel="Iterations",
                ylabel="@metric@", figsize=None, dpi=None, grid=True):
    """reference: plotting.py plot_metric:231. Accepts the dict produced by
    `record_evaluation` or a fitted sklearn estimator."""
    plt = _check_matplotlib()
    if isinstance(booster_or_record, dict):
        eval_results = booster_or_record
    elif hasattr(booster_or_record, "evals_result_"):
        eval_results = booster_or_record.evals_result_
    else:
        raise TypeError("plot_metric needs a record_evaluation dict or a "
                        "fitted LGBMModel")
    if not eval_results:
        raise ValueError("eval results are empty")

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    names = dataset_names or list(eval_results.keys())
    for name in names:
        metrics = eval_results[name]
        m = metric or next(iter(metrics))
        ax.plot(metrics[m], label=name)
        ylabel_final = ylabel.replace("@metric@", m)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel_final)
    ax.grid(grid)
    return ax


def _tree_to_graphviz(tree_info: Dict[str, Any], feature_names,
                      precision: int = 3, orientation: str = "horizontal"):
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "You must install graphviz to plot tree") from e
    graph = Digraph()
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr(rankdir=rankdir)

    def add(node, parent=None, decision=None):
        if "split_index" in node:
            name = f"split{node['split_index']}"
            fi = node["split_feature"]
            fname = feature_names[fi] if feature_names else f"f{fi}"
            if node["decision_type"] == "==":
                label = f"{fname} in {{{node['threshold']}}}"
            else:
                label = (f"{fname} <= "
                         f"{round(node['threshold'], precision)}")
            label += f"\\ngain: {round(node['split_gain'], precision)}"
            graph.node(name, label=label)
            add(node["left_child"], name, "yes")
            add(node["right_child"], name, "no")
        else:
            name = f"leaf{node['leaf_index']}"
            graph.node(
                name,
                label=f"leaf {node['leaf_index']}: "
                      f"{round(node['leaf_value'], precision)}")
        if parent is not None:
            graph.edge(parent, name, decision)

    add(tree_info["tree_structure"])
    return graph


def create_tree_digraph(booster, tree_index: int = 0, precision: int = 3,
                        orientation: str = "horizontal", **kwargs):
    """reference: plotting.py create_tree_digraph:601."""
    booster = _to_booster(booster)
    model = booster.dump_model()
    if tree_index >= len(model["tree_info"]):
        raise IndexError("tree_index is out of range")
    return _tree_to_graphviz(model["tree_info"][tree_index],
                             model.get("feature_names"), precision,
                             orientation)


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              precision: int = 3, orientation: str = "horizontal", **kwargs):
    """reference: plotting.py plot_tree:780 (renders the digraph into a
    matplotlib axes)."""
    plt = _check_matplotlib()
    graph = create_tree_digraph(booster, tree_index, precision, orientation)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    import io
    try:
        s = graph.pipe(format="png")
        import matplotlib.image as mpimg
        img = mpimg.imread(io.BytesIO(s))
        ax.imshow(img)
    except Exception as e:
        raise RuntimeError(f"graphviz rendering failed: {e}") from e
    ax.axis("off")
    return ax
