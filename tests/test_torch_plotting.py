"""The port's plotting functions against the JAX package's on the CPU
(matplotlib's Agg backend): `create_tree_digraph`'s Graphviz source on the
same model text, `plot_importance`'s bars and labels and `plot_metric`'s
lines equal; `plot_tree` renders through the `dot` binary, and where none
is installed both packages raise the same error. (Importing the port's
plotting module loads neither matplotlib nor graphviz:
tests/test_torch_isolation.py.)"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

# xdist runs several test processes side by side: one intra-op thread each,
# not a pool of one a core in every process
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    """One port model (regression, 5 features, 10 rounds, its l2 record)
    and the same model text loaded by each package."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(400, 5))
    y = X[:, 0] * 2 + X[:, 1] - 0.5 * X[:, 2] + 0.25 * X[:, 3]
    record = {}
    ds = lt.Dataset(X, y)
    bst = lt.train({"objective": "regression", "verbose": -1,
                    "num_leaves": 7, "metric": "l2", "device_type": "cpu"},
                   ds, num_boost_round=10, valid_sets=[ds],
                   valid_names=["train"],
                   callbacks=[lt.record_evaluation(record)])
    text = bst.model_to_string()
    return (lt.Booster(params={"device_type": "cpu"}, model_str=text),
            lj.Booster(model_str=text), record)


@pytest.mark.parametrize("tree_index", [0, 9])
def test_create_tree_digraph_source_equals_jax(models, tree_index):
    bt, bj, _ = models
    gt = lt.create_tree_digraph(bt, tree_index=tree_index, precision=4)
    gj = lj.create_tree_digraph(bj, tree_index=tree_index, precision=4)
    assert gt.source == gj.source and "leaf" in gt.source
    with pytest.raises(IndexError):
        lt.create_tree_digraph(bt, tree_index=10)


@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_plot_importance_equals_jax(models, importance_type):
    bt, bj, _ = models
    out = []
    for mod, b in ((lt, bt), (lj, bj)):
        ax = mod.plot_importance(b, importance_type=importance_type,
                                 max_num_features=4)
        out.append(([(p.get_width(), p.get_y()) for p in ax.patches],
                    [t.get_text() for t in ax.get_yticklabels()],
                    [t.get_text() for t in ax.texts], ax.get_title()))
        plt.close(ax.figure)
    assert out[0] == out[1] and len(out[0][0]) >= 3


def test_plot_metric_equals_jax(models):
    _, _, record = models
    out = []
    for mod in (lt, lj):
        ax = mod.plot_metric(record, metric="l2")
        out.append(([ln.get_ydata().tolist() for ln in ax.lines],
                    ax.get_ylabel(), ax.get_xlabel()))
        plt.close(ax.figure)
    assert out[0] == out[1] and len(out[0][0][0]) == 10
    assert out[0][1] == "l2"


def test_plot_tree_equals_jax(models):
    bt, bj, _ = models
    errors = []
    for mod, b in ((lt, bt), (lj, bj)):
        try:
            ax = mod.plot_tree(b, tree_index=1)
            errors.append(None)
            assert ax.images
            plt.close(ax.figure)
        except RuntimeError as e:
            errors.append(type(e).__name__)
            plt.close("all")
    assert errors[0] == errors[1]
