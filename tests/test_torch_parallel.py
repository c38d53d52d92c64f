"""Multi-device training of the port over torch.distributed process groups
on the CPU (gloo), against the JAX package's 8-device mesh and within the
port (tests/test_parallel.py, test_comm_modes.py and
test_distributed_multiprocess.py ported).

Each group is one `launch_local` (or `python -m lightgbm_tpu_torch.launch`)
of the worker below, which trains every configuration of its group in turn
and writes each rank's results; the JAX package runs once a configuration
in this process, on the conftest's 8-device CPU mesh.

Across different rank counts the float histograms are summed in another
order, so a W-rank model is held to the JAX mesh and to one process by
tree structure on data whose best gains are well separated (ROADMAP C note
9); within one group every rank's model, and the two histogram exchanges'
models, are held md5-equal.
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.launch import launch_local

# xdist runs several test processes side by side: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent('''
    import hashlib, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.utils.log import FatalError

    group, out, extra = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    W = int(os.environ["LIGHTGBM_TPU_NPROC"])

    def binary(n, f, seed):
        rng = np.random.RandomState(seed)
        X = rng.normal(size=(n, f))
        w = rng.normal(size=f)
        y = (X @ w + 0.1 * rng.normal(size=n) > 0).astype(np.float32)
        return X, y

    def separated(n=2000, f=12, seed=5):
        rng = np.random.RandomState(seed)
        X = rng.normal(size=(n, f))
        y = X @ (8.0 * 0.5 ** np.arange(f))
        return X, y

    def padding_case():
        rng = np.random.RandomState(7)
        X = rng.normal(size=(600, 3)).astype(np.float32)
        y = (X @ rng.normal(size=3) + rng.normal(scale=0.5, size=600)
             > 0).astype(np.float32)
        return X, y

    def trees_only(text):
        return "\\n".join(l for l in text.splitlines()
                         if not l.startswith("["))

    def summary(bst):
        return [{"num_leaves": int(t.num_leaves),
                 "split_feature": [int(v) for v in
                                   t.split_feature[:t.num_leaves - 1]],
                 "threshold_in_bin": [int(v) for v in
                                      t.threshold_in_bin[:t.num_leaves - 1]]}
                for t in bst._gbdt.models]

    BASE = dict(verbose=-1, device_type="cpu", num_machines=W)
    res = {}

    def run(name, params, X, y, rounds, predict=None):
        bst = lt.train({**BASE, **params}, lt.Dataset(X, label=y), rounds)
        txt = trees_only(bst.model_to_string())
        r = {"md5": hashlib.md5(txt.encode()).hexdigest(),
             "trees": summary(bst), "comm": bst._gbdt._comm_profile,
             "mode": bst._gbdt.grow_cfg.parallel_hist_mode,
             "route": bst._gbdt.grow_route, "use_dist": bst._gbdt.use_dist}
        if predict is not None:
            r["pred"] = bst.predict(predict).tolist()
        res[name] = r
        return bst

    def refused(name, fn):
        try:
            fn()
            res[name] = "trained"
        except (FatalError, NotImplementedError) as e:
            res[name] = str(e)

    if group == "mesh8":
        X, y = binary(1000, 10, 3)
        run("data_reg", dict(objective="regression", num_leaves=8,
                             min_data_in_leaf=20, tree_learner="data"),
            X, y, 3)
        X, y = binary(2000, 20, 7)
        run("data_bin", dict(objective="binary", num_leaves=15,
                             learning_rate=0.1, min_data_in_leaf=5,
                             tree_learner="data"), X, y, 10, predict=X)
        X, y = binary(1500, 16, 11)
        run("feature", dict(objective="binary", num_leaves=15,
                            learning_rate=0.1, min_data_in_leaf=5,
                            tree_learner="feature"), X, y, 5, predict=X)
        X, y = separated()
        run("vote_sep", dict(objective="regression", num_leaves=8,
                             min_data_in_leaf=20, tree_learner="voting",
                             top_k=3), X, y, 3)
        X, y = binary(3000, 20, 11)
        q = dict(objective="binary", num_leaves=15, learning_rate=0.1,
                 min_data_in_leaf=5)
        run("q_data", dict(q, tree_learner="data"), X, y, 10, predict=X)
        run("q_vote", dict(q, tree_learner="voting", top_k=8), X, y, 10,
            predict=X)
        X, y = binary(2000, 30, 13)
        run("q_narrow", dict(objective="binary", num_leaves=15,
                             min_data_in_leaf=5, tree_learner="voting",
                             top_k=3), X, y, 10, predict=X)
    elif group == "pad4":
        X, y = padding_case()
        p = dict(objective="binary", num_leaves=8, learning_rate=0.2,
                 min_data_in_leaf=5, tree_learner="data")
        for tag, over in (("wave", {}),
                          ("quant", dict(use_quantized_grad=True)),
                          ("masked", dict(tpu_grower="masked"))):
            for mode in ("allreduce", "reduce_scatter"):
                run(f"{tag}_{mode}", dict(p, parallel_hist_mode=mode,
                                          **over), X, y, 3)
        run("auto", p, X, y, 1)
        # build_data_parallel_train_fn's step on the rank's block against
        # the booster's first round from the same gradients
        from lightgbm_tpu_torch.parallel import (
            build_data_parallel_train_fn, make_data_mesh, replicated,
            shard_rows)
        sp = dict(BASE, objective="regression", num_leaves=8,
                  learning_rate=0.2, min_data_in_leaf=5,
                  tree_learner="data", boost_from_average=False)
        bst = lt.Booster(sp, lt.Dataset(X, label=y))
        gb = bst._gbdt
        g, h = gb.boost()
        blk = [shard_rows(t, -1) for t in (g[0], h[0],
                                           torch.ones_like(g[0]),
                                           gb.scores[0])]
        step = build_data_parallel_train_fn(gb.meta, gb.grow_cfg)
        tree, lor, new = step(gb.X_t, *blk, gb.shrinkage_rate,
                              gb._feature_mask_for_iter(),
                              gb.tree_seed(0, 0))
        bst.update()
        per = blk[0].shape[0]
        n_mine = min(per, len(y) - rank * per)
        res["step"] = {
            "block": per, "num_leaves": int(tree.num_leaves),
            "booster_leaves": int(gb.models[0].num_leaves),
            "scores_equal": bool(torch.equal(
                new[:n_mine], shard_rows(gb.scores[0], -1)[:n_mine])),
            "mesh": [list(make_data_mesh(W, device_type="cpu")[:2]),
                     str(make_data_mesh(W, device_type="cpu").device),
                     str(make_data_mesh(devices=["cpu"] * W).device)],
            "replicated_is_input": replicated(g) is g}
    elif group == "pair":
        # pre_partition: rank r loads only its rows (700 and 500), labels
        # on a 1/64 grid, no boost from the average
        rng = np.random.RandomState(17)
        Xa = rng.normal(size=(1200, 6))
        ya = np.round(64 * (Xa @ (4.0 * 0.5 ** np.arange(6)))) / 64
        lo, hi = (0, 700) if rank == 0 else (700, 1200)
        pp = dict(objective="regression", num_leaves=8,
                  min_data_in_leaf=20, boost_from_average=False,
                  tree_learner="data", pre_partition=True)
        ds = lt.Dataset(Xa[lo:hi], label=ya[lo:hi],
                        params={**BASE, **pp})
        bst = lt.train({**BASE, **pp}, ds, 2)
        res["pre_partition"] = {
            "md5": hashlib.md5(trees_only(
                bst.model_to_string()).encode()).hexdigest(),
            "trees": summary(bst),
            "global_rows": bst._gbdt.global_num_data,
            "mappers": [m.to_dict() for m in ds._handle.mappers]}
        if rank == 0:
            # one process on the concatenation under the merged mappers
            ref = lt.train({**pp, "verbose": -1, "device_type": "cpu",
                            "tree_learner": "serial",
                            "pre_partition": False},
                           lt.Dataset(Xa, label=ya, reference=ds), 2)
            res["pre_partition_serial"] = summary(ref)
        X, y = padding_case()
        cache = extra["cache"]
        base = dict(objective="binary", num_leaves=8, learning_rate=0.2,
                    min_data_in_leaf=5, tree_learner="data",
                    autotune_cache=cache)
        bst = run("probe", dict(base, autotune=True), X, y, 1)
        res["probe_decision"] = bst._gbdt.autotune_decision
        run("rs", dict(base, parallel_hist_mode="reduce_scatter"), X, y, 4)
        bst = run("degrade", dict(
            base, parallel_hist_mode="reduce_scatter",
            fault_plan="fail_collective@iter=1:times=2"), X, y, 4)
        res["degrade_failures"] = bst._gbdt._collective_failures
        # the fault planted in rank 1's plan only: both ranks learn of it,
        # count it and degrade together
        bst = run("degrade_one", dict(
            base, parallel_hist_mode="reduce_scatter",
            fault_plan="fail_collective@iter=1:times=2" if rank == 1
            else ""), X, y, 4)
        res["degrade_one_failures"] = bst._gbdt._collective_failures
        # the masked record sum: each slot's winner on one rank, a -0.0
        # among them (a leaf output of a zero gradient sum)
        from lightgbm_tpu_torch.parallel import DistContext
        from lightgbm_tpu_torch.parallel.packed import masked_psum_record
        v = torch.tensor([-0.0, 1.5, -0.0, 0.0]) if rank == 0 \
            else torch.tensor([7.0, -2.5, -0.0, -0.0])
        win = torch.tensor([True, False, rank == 1, True]) if rank == 0 \
            else torch.tensor([False, True, True, False])
        got = masked_psum_record(DistContext(), win, (v, v > 0))
        res["masked_record"] = [got[0].view(torch.int32).tolist(),
                                got[1].tolist()]
        res["degrade_decision"] = bst._gbdt.autotune_decision
        d = dict(objective="binary", num_leaves=8, min_data_in_leaf=5)
        refused("linear", lambda: run("x", dict(d, tree_learner="data",
                                                linear_tree=True), X, y, 1))
        refused("cegb", lambda: run("x", dict(d, tree_learner="data",
                                              cegb_penalty_split=0.1),
                                    X, y, 1))
        Xc = X.copy()
        Xc[:, 0] = np.floor(np.abs(Xc[:, 0]) * 3)
        refused("voting_cat", lambda: lt.train(
            {**BASE, **d, "tree_learner": "voting"},
            lt.Dataset(Xc, label=y, categorical_feature=[0]), 1))
        refused("voting_forced", lambda: run("x", dict(
            d, tree_learner="voting",
            forcedsplits_filename=extra["forced"]), X, y, 1))
        rs = np.random.RandomState(0)
        Xs = np.zeros((2000, 20), np.float32)
        hot = rs.randint(0, 20, size=2000)
        Xs[np.arange(2000), hot] = rs.uniform(1, 3, size=2000)
        ys = (hot % 3 == 0).astype(np.float32)
        refused("feature_efb", lambda: run("x", dict(
            d, tree_learner="feature"), Xs, ys, 1))
        for boosting in ("dart", "rf"):
            refused(f"pre_partition_{boosting}", lambda: run("x", dict(
                d, tree_learner="data", pre_partition=True,
                boosting=boosting, bagging_fraction=0.5, bagging_freq=1),
                X, y, 1))
    elif group == "kill":
        X, y = padding_case()
        plan = "kill@iter=1" if rank == 1 else ""
        run("kill", dict(objective="binary", num_leaves=8,
                         tree_learner="data", fault_plan=plan), X, y, 3)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
''')


def _group(tmp, name, W, extra=None, cli=False, timeout=300):
    """Run one group of W ranks; returns every rank's results."""
    d = tmp / name
    d.mkdir()
    script = d / "worker.py"
    script.write_text(WORKER)
    argv = [sys.executable, str(script), name, str(d),
            json.dumps(extra or {})]
    # a degrade pins its choice in the autotune cache: keep it in the run's
    # directory
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               LIGHTGBM_TPU_AUTOTUNE_CACHE=str(d / "autotune.json"))
    if cli:
        # the launcher's command line
        subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.launch",
                        "-n", str(W), "--"] + argv, env=env, check=True,
                       timeout=timeout, cwd=str(d))
    else:
        launch_local(W, argv, env_extra={
            k: env[k] for k in ("PYTHONPATH", "LIGHTGBM_TPU_AUTOTUNE_CACHE")},
            timeout=timeout)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(W)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    forced = tmp / "forced.json"
    forced.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    return {"mesh8": _group(tmp, "mesh8", 8),
            "pad4": _group(tmp, "pad4", 4),
            "pair": _group(tmp, "pair", 2, cli=True, extra={
                "cache": str(tmp / "autotune.json"),
                "forced": str(forced)}),
            "cache": tmp / "autotune.json"}


def _binary(n, f, seed):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    w = rng.normal(size=f)
    y = (X @ w + 0.1 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _jax_summary(bst):
    return [{"num_leaves": int(t.num_leaves),
             "split_feature": [int(v) for v in
                               t.split_feature[:t.num_leaves - 1]],
             "threshold_in_bin": [int(v) for v in
                                  np.asarray(t.threshold_in_bin)[
                                      :t.num_leaves - 1]]}
            for t in bst._gbdt.models]


def _one(res, name):
    """A configuration's result, after checking every rank's model is
    md5-equal."""
    md5s = {r[name]["md5"] for r in res}
    assert len(md5s) == 1, f"{name}: ranks grew different models"
    return res[0][name]


@pytest.mark.parametrize("name", ["data_reg", "data_bin", "feature",
                                  "vote_sep", "q_data", "q_vote",
                                  "q_narrow"])
def test_every_rank_same_model_mesh8(groups, name):
    r = _one(groups["mesh8"], name)
    assert r["use_dist"] is True
    if name == "feature":
        assert r["route"] == "apply" and r["comm"] is None
    else:
        assert r["route"] == "mega"


def test_data_parallel_same_structure_as_jax_mesh(groups):
    """tests/test_parallel.py::test_data_parallel_same_tree_structure's
    fixture: the port's 8 ranks grow the JAX mesh's trees."""
    X, y = _binary(1000, 10, 3)
    jb = lj.train(dict(objective="regression", num_leaves=8,
                       min_data_in_leaf=20, verbosity=-1,
                       tree_learner="data"), lj.Dataset(X, y),
                  num_boost_round=3)
    assert _one(groups["mesh8"], "data_reg")["trees"] == _jax_summary(jb)


def test_data_parallel_predictions_near_serial(groups):
    """test_data_parallel_matches_serial's bound: the 8-rank model's
    predictions within 2e-3 of one process's, the JAX package's serial
    model's and the port's."""
    X, y = _binary(2000, 20, 7)
    params = dict(objective="binary", num_leaves=15, learning_rate=0.1,
                  min_data_in_leaf=5, verbosity=-1)
    p_dist = np.asarray(_one(groups["mesh8"], "data_bin")["pred"])
    p_jax = lj.train(params, lj.Dataset(X, y), 10).predict(X)
    p_port = lt.train({**params, "device_type": "cpu"},
                      lt.Dataset(X, label=y), 10).predict(X)
    assert np.mean((p_dist > 0.5) == (y > 0.5)) > 0.85
    np.testing.assert_allclose(p_dist, p_jax, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(p_dist, p_port, rtol=2e-3, atol=2e-3)


def test_feature_parallel_same_structure_as_serial(groups):
    """test_feature_parallel_matches_serial: full-row histograms, so the
    trees are the serial ones."""
    X, y = _binary(1500, 16, 11)
    params = dict(objective="binary", num_leaves=15, learning_rate=0.1,
                  min_data_in_leaf=5, verbose=-1, device_type="cpu")
    serial = lt.train(params, lt.Dataset(X, label=y), 5)
    r = _one(groups["mesh8"], "feature")
    assert r["trees"] == [
        {"num_leaves": t.num_leaves,
         "split_feature": list(map(int, t.split_feature[:t.num_leaves - 1])),
         "threshold_in_bin": list(map(int, t.threshold_in_bin[
             :t.num_leaves - 1]))} for t in serial._gbdt.models]
    np.testing.assert_allclose(r["pred"], serial.predict(X), rtol=2e-4,
                               atol=2e-5)


def test_voting_same_structure_as_jax_mesh_and_quality(groups):
    """Voting at W = 8 ranks holding the JAX mesh's row blocks: the JAX
    voting trees on well-separated gains; then JAX's two quality bounds."""
    rng = np.random.RandomState(5)
    X = rng.normal(size=(2000, 12))
    y = X @ (8.0 * 0.5 ** np.arange(12))
    jb = lj.train(dict(objective="regression", num_leaves=8,
                       min_data_in_leaf=20, verbosity=-1,
                       tree_learner="voting", top_k=3),
                  lj.Dataset(X, y), num_boost_round=3)
    assert _one(groups["mesh8"], "vote_sep")["trees"] == _jax_summary(jb)
    X, y = _binary(3000, 20, 11)
    acc = {n: np.mean((np.asarray(_one(groups["mesh8"], n)["pred"]) > 0.5)
                      == (y > 0.5)) for n in ("q_data", "q_vote")}
    assert acc["q_vote"] > acc["q_data"] - 0.02
    X, y = _binary(2000, 30, 13)
    p = np.asarray(_one(groups["mesh8"], "q_narrow")["pred"])
    assert np.mean((p > 0.5) == (y > 0.5)) > 0.8


@pytest.mark.parametrize("tag", ["wave", "quant", "masked"])
def test_modes_bit_identical_padding_case(groups, tag):
    """test_modes_bit_identical_on_mesh's bar on its harshest padding
    shape at W = 4: F = 3 features pad to 4, rank 3 owns only a padded
    slot. allreduce and reduce_scatter grow md5-equal trees, every rank
    the same; quantized gradients cross as packed lanes."""
    res = groups["pad4"]
    ar = _one(res, f"{tag}_allreduce")
    rs = _one(res, f"{tag}_reduce_scatter")
    assert ar["md5"] == rs["md5"]
    assert ar["mode"] == "allreduce" and rs["mode"] == "reduce_scatter"
    if tag == "quant":
        assert ar["comm"]["comm_packed"] is True
    if tag == "masked":
        assert ar["route"] == rs["route"] == "masked"


def test_auto_reaches_grow_cfg_verbatim(groups):
    r = _one(groups["pad4"], "auto")
    assert r["mode"] == "auto" and r["comm"]["comm_mode"] == \
        "reduce_scatter"


def test_pre_partition_matches_one_process(groups):
    """pre_partition at W = 2 with 700 and 500 rows: every rank holds the
    merged mappers, and the trees are one process's on the concatenation
    under them (1/64-grid labels: the first tree's f32 sums are exact)."""
    res = groups["pair"]
    r = _one(res, "pre_partition")
    assert r["global_rows"] == 1200
    assert res[0]["pre_partition"]["mappers"] == \
        res[1]["pre_partition"]["mappers"]
    assert r["trees"] == res[0]["pre_partition_serial"]


def test_masked_record_keeps_negative_zero(groups):
    """The winner's record comes back bit for bit on every rank, a -0.0
    included (a 0.0 filler would turn it into +0.0, and reduce_scatter's
    model text would part from allreduce's at a leaf of -0.0)."""
    want = np.array([-0.0, -2.5, -0.0, 0.0], np.float32).view(np.int32)
    for r in groups["pair"]:
        bits, flags = r["masked_record"]
        assert bits == want.tolist()
        assert flags == [False, False, False, False]


def test_comm_probe_and_cache(groups):
    d = groups["pair"][0]["probe_decision"]
    assert d == groups["pair"][1]["probe_decision"]
    assert set(d["comm_timings"]) == {"allreduce", "reduce_scatter"}
    assert d["parallel_hist_mode"] in ("allreduce", "reduce_scatter")
    assert d["key"].endswith("_mesh2")
    disk = json.loads(groups["cache"].read_text())
    assert any(k.endswith("_mesh2") for k in disk)


def test_collective_failures_degrade_and_pin(groups):
    res = groups["pair"]
    deg, rs = _one(res, "degrade"), _one(res, "rs")
    assert deg["md5"] == rs["md5"]
    assert deg["mode"] == "allreduce"
    assert res[0]["degrade_failures"] == 2
    assert res[0]["degrade_decision"]["pinned"] is True
    disk = json.loads(groups["cache"].read_text())
    assert any(v.get("pinned") and v.get("parallel_hist_mode")
               == "allreduce" for v in disk.values())


def test_collective_fault_on_one_rank_degrades_every_rank(groups):
    """fail_collective in rank 1's plan only: every rank counts both
    failures and degrades, and the model is the undisturbed reduce_scatter
    run's."""
    res = groups["pair"]
    one, rs = _one(res, "degrade_one"), _one(res, "rs")
    assert one["md5"] == rs["md5"]
    assert one["mode"] == "allreduce"
    assert [r["degrade_one_failures"] for r in res] == [2, 2]


def test_data_parallel_train_fn_matches_booster(groups):
    """build_data_parallel_train_fn on each rank's block (W = 4, rank 3's
    block half padding) grows the booster's first tree and updates the
    block's scores bitwise as the booster does; make_data_mesh gives the
    group's layout, replicated hands the array back."""
    for rank, r in enumerate(groups["pad4"]):
        st = r["step"]
        assert st["block"] == 152
        assert st["num_leaves"] == st["booster_leaves"] > 1
        assert st["scores_equal"] is True
        assert st["mesh"] == [[4, rank], "cpu", "cpu"]
        assert st["replicated_is_input"] is True


def test_dist_grow_error_is_not_retried():
    """Under distribution an error inside a grow step is fatal at once,
    never retried or counted toward a degrade on one rank alone (its peers
    are inside other collectives); one process retries it as before."""
    from types import SimpleNamespace
    from lightgbm_tpu_torch.models.gbdt import GBDT
    calls = []

    def grow_one(*a, **k):
        calls.append(1)
        raise RuntimeError("[gloo] Connection closed by peer")
    stub = SimpleNamespace(
        config=SimpleNamespace(step_max_retries=3, step_retry_backoff_s=0.0),
        _fault_plan=None, _dist_faults=False, use_dist=True, rank=1,
        n_shards=2, iter=3, _cegb_used=None, grow_one=grow_one,
        _collective_failures=0, _planted_collective_fault=lambda: None,
        _degrade_comm_mode=lambda reason="": False)
    with pytest.raises(RuntimeError, match="closed by peer"):
        GBDT._grow_step(stub, None, None, None, None, 0)
    assert len(calls) == 1 and stub._collective_failures == 0
    stub.use_dist = False
    calls.clear()
    with pytest.raises(RuntimeError, match="closed by peer"):
        GBDT._grow_step(stub, None, None, None, None, 0)
    assert len(calls) == 4 and stub._collective_failures == 4


def test_collectives_keep_buffers_on_the_input_device(monkeypatch):
    """With no host staging (a group with NCCL in it) every buffer a
    collective allocates lies on its input's device: run on the `meta`
    device with the transport replaced by a recorder."""
    import torch.distributed as tdist
    from lightgbm_tpu_torch.parallel.context import DistContext
    seen = []

    def a2a(out, inp):
        seen.extend([out.device, inp.device])
        out.copy_(inp)

    def gather(out, inp):
        seen.extend([out.device, inp.device])
        out.copy_(inp.repeat(out.numel() // inp.numel()))

    def reduce(t, op=None):
        seen.append(t.device)
    monkeypatch.setattr(tdist, "all_to_all_single", a2a)
    monkeypatch.setattr(tdist, "all_gather_into_tensor", gather)
    monkeypatch.setattr(tdist, "all_gather_single", None, raising=False)
    monkeypatch.setattr(tdist, "all_reduce", reduce)
    ctx = object.__new__(DistContext)
    ctx.__dict__.update(axis_name="data", size=2, rank=0,
                        backend="cpu:gloo,cuda:nccl", staged=False,
                        device=torch.device("meta"), comm_seconds=0.0,
                        comm_bytes=0, comm_calls=0)
    x = torch.ones((3, 4, 5), device="meta")
    outs = [ctx.psum(x), ctx.psum_scatter(x, axis=1), ctx.pmax(x),
            ctx.all_gather(x, axis=0), ctx.all_gather(x, tiled=False)]
    assert [tuple(o.shape) for o in outs] == [
        (3, 4, 5), (3, 2, 5), (3, 4, 5), (6, 4, 5), (2, 3, 4, 5)]
    assert all(o.device.type == "meta" for o in outs)
    assert len(seen) == 11 and all(d.type == "meta" for d in seen)


@pytest.mark.parametrize("name,msg", [
    ("linear", "linear_tree is not supported with distributed tree "
               "learners"),
    ("cegb", "cegb_* is not supported with distributed tree learners yet"),
    ("voting_cat", "tree_learner=voting does not support forced splits "
                   "or categorical features yet"),
    ("voting_forced", "tree_learner=voting does not support forced splits "
                      "or categorical features yet"),
    ("feature_efb", "tree_learner=feature does not support EFB bundling "
                    "yet"),
    ("pre_partition_dart", "pre_partition does not support boosting=dart"),
    ("pre_partition_rf", "pre_partition does not support boosting=rf"),
])
def test_refusals_keep_jax_messages(groups, name, msg):
    for r in groups["pair"]:
        assert msg in r[name], r[name]


def test_killed_rank_fails_the_group(tmp_path):
    """A rank that dies (kill@iter=1 on rank 1) brings the launch down:
    launch_local raises naming the exit codes, no worker left behind."""
    with pytest.raises(RuntimeError, match="worker exit codes"):
        _group(tmp_path, "kill", 2, timeout=120)


def test_sharded_score_fn_bitwise():
    """build_sharded_score_fn over four CPU "devices": four row blocks,
    scored one by one, concatenated: bitwise the unsharded scorer."""
    from lightgbm_tpu_torch.parallel import build_sharded_score_fn
    X, y = _binary(500, 6, 2)
    bst = lt.train(dict(objective="binary", num_leaves=7, verbose=-1,
                        device_type="cpu"), lt.Dataset(X, label=y), 4)
    s = bst.serve(engine="device")
    from lightgbm_tpu_torch.ops.predict import predict_margin_packed
    pa = s._pa

    def score(Xb, tid):
        return predict_margin_packed(pa, Xb, 1) + 0 * tid[None, :]
    fn = build_sharded_score_fn(["cpu"] * 4, score, extra_row_args=1)
    Xq = torch.from_numpy(X[:64].astype(np.float32))
    tid = torch.zeros(64, dtype=torch.int32)
    assert torch.equal(fn(Xq, tid), score(Xq, tid))
    with pytest.raises(ValueError, match="do not split"):
        fn(Xq[:63], tid[:63])


def test_session_shards_over_devices(monkeypatch):
    """num_shards=2 where two devices are listed: the session scores each
    bucket over both, bitwise its unsharded twin; min_bucket follows."""
    from lightgbm_tpu_torch.serving import session as ss
    X, y = _binary(400, 5, 4)
    bst = lt.train(dict(objective="binary", num_leaves=7, verbose=-1,
                        device_type="cpu"), lt.Dataset(X, label=y), 3)
    monkeypatch.setattr(ss, "shard_devices",
                        lambda dev: [torch.device("cpu")] * 2)
    sh = bst.serve(engine="device", num_shards=2, min_bucket=1)
    assert sh.num_shards == 2 and sh.min_bucket == 2
    monkeypatch.setattr(ss, "shard_devices", lambda dev: [dev])
    one = bst.serve(engine="device")
    Xq = X[:37]
    assert hashlib.md5(sh.predict(Xq).tobytes()).hexdigest() == \
        hashlib.md5(one.predict(Xq).tobytes()).hexdigest()
