"""The port's runtime profiler (lightgbm_tpu_torch/runtime/profiler.py) held
to the JAX package's: the same StageProfiler calls give equal dicts under
one synthetic clock, and device_profile=true training records the same
iterations, stages and extras, minus the differences the port's
docstrings state (models/gbdt.py:_profile_hist_tiers: no `hist_tiers`
and no `hist_class_b{w}` spans, one `hist_slots` span instead; the
`dispatches` counter only where the port counts dispatches, batched
chunks). Profiling changes no model, per iteration and batched. The
serving profiler counts the binned engine's binning stage and changes no
margin."""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.runtime import autotune as jat
from lightgbm_tpu.runtime import profiler as jprof
from lightgbm_tpu_torch.runtime import autotune as tat
from lightgbm_tpu_torch.runtime import profiler as tprof

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "seed": 7}
CPU = {"device_type": "cpu"}
# the stages of one per-iteration round, in both packages
ITER_STAGES = ("boost", "grow", "score-update")


@pytest.fixture(autouse=True)
def _isolate_autotune_cache(tmp_path, monkeypatch):
    """Every test's decisions stay out of the user-level disk cache and
    out of other tests' in-process caches, in both packages."""
    monkeypatch.setenv("LIGHTGBM_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    saved = [(c, dict(c)) for c in (jat._MEM_CACHE, tat._MEM_CACHE)]
    for c, _ in saved:
        c.clear()
    yield
    for c, old in saved:
        c.clear()
        c.update(old)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(42)
    X = rng.normal(size=(1200, 6))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    return X, y


def _clock():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]
    return clock


def _drive(mod):
    """The same calls on a StageProfiler of `mod`, one synthetic clock."""
    prof = mod.StageProfiler(clock=_clock(), barrier=lambda: None)
    with prof.span("bin"):
        pass
    for it in range(3):
        prof.iter_start()
        prof.iter_meta(comm_mode="allreduce", comm_bytes=64 * it)
        with prof.span("boost"):
            pass
        with prof.span("grow", tenant="a" if it % 2 else "b"):
            pass
        prof.add_counter("dispatches", 2)
        prof.iter_end(n_rows=100)
    prof.iter_meta(lost=True)                 # outside an iteration
    prof.record_batched_chunk(4, 2.0, n_rows=400, chunk=0)
    prof.record_batched_chunk(0, 1.0)         # no iterations: nothing
    for r in ([1.0, 1.1, 3.0], [1.0, 0.9, 3.2]):
        prof.record_rank_spans("grow", r, threshold=1.4)
    prof.sample_hbm("serve_score")
    prof.extras["note"] = {"k": 1}
    lat = mod.LatencyStats(maxlen=4)
    for s in (0.003, 0.001, 0.002, 0.010, 0.004):
        lat.record(s)
    return prof, lat


def test_stage_profiler_equals_jax():
    tp, tl = _drive(tprof)
    jp, jl = _drive(jprof)
    d = tp.to_dict()
    assert d == jp.to_dict()
    assert json.loads(tp.export_json()) == json.loads(jp.export_json())
    assert d["stragglers"]["grow"]["straggler_ranks"] == [2]
    assert d["stages_by_tenant"]["a"]["grow"] == pytest.approx(0.25)
    assert tl.to_dict() == jl.to_dict()
    assert tl.percentile(50.0) == jl.percentile(50.0)
    # no allocator statistics on the CPU: the samples are kept, unvalued
    assert d["hbm_watermark"] == [{"seq": 0, "tag": "serve_score",
                                   "peak_bytes": None}]
    assert "hbm_peak_bytes" not in d


def test_timer_sections():
    timer = tprof.Timer()
    for _ in range(3):
        with timer.section("a", block=True):
            pass
    with timer.section("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert all(v >= 0.0 for v in timer.acc.values())
    assert timer.summary().splitlines()[0] == \
        jprof.Timer().summary().splitlines()[0]
    timer.reset()
    assert timer.acc == {} and timer.counts == {}


def test_timetag_sections_match_jax(data, monkeypatch):
    """LIGHTGBM_TPU_TIMETAG's summary reads the sections models/gbdt.py
    opens: per iteration a grow section a tree and the materialization of
    the pending trees, as in the JAX package; batched one scan section a
    chunk."""
    import lightgbm_tpu.models.gbdt as jgbdt
    import lightgbm_tpu_torch.models.gbdt as tgbdt
    X, y = data
    counts = {}
    for name, mod, prof, train in (("jax", jgbdt, jprof, _train_jax),
                                   ("port", tgbdt, tprof, _train_port)):
        timer = prof.Timer()
        monkeypatch.setattr(mod, "global_timer", timer)
        train(X, y, {}, 3).model_to_string()
        counts[name] = dict(timer.counts)
    assert counts["port"] == counts["jax"]
    assert counts["port"]["GBDT::TrainOneIter/grow"] == 3
    assert counts["port"]["GBDT::MaterializeModels"] >= 1
    monkeypatch.delenv("LIGHTGBM_TPU_DISABLE_BATCHED", raising=False)
    timer = tprof.Timer()
    monkeypatch.setattr(tgbdt, "global_timer", timer)
    _train_port(X, y, {"batched_chunk_size": 2}, 5)
    assert timer.counts["GBDT::TrainItersBatched/scan"] == 3
    assert "GBDT::TrainOneIter/grow" not in timer.counts


def test_trace_and_launch_counts_on_cpu(tmp_path):
    """trace() writes a Chrome trace; count_kernel_launches counts none on
    the CPU, where the wrappers run their plain versions."""
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    X = torch.randint(0, 8, (3, 64), dtype=torch.uint8)
    vals = torch.ones((2, 64))
    with tprof.trace(str(tmp_path / "tr")):
        h = build_histogram(X, vals, 8)
    assert float(h[1].sum()) == 3 * 64
    assert json.load(open(tmp_path / "tr" / "trace.json"))
    assert tprof.count_kernel_launches(build_histogram, X, vals, 8) == {}


def _train_jax(X, y, params, rounds, **kw):
    return lj.train(dict(PARAMS, **params), lj.Dataset(X, label=y),
                    num_boost_round=rounds, **kw)


def _train_port(X, y, params, rounds, **kw):
    return lt.train(dict(PARAMS, **CPU, **params), lt.Dataset(X, label=y),
                    num_boost_round=rounds, **kw)


def _flagless(text):
    return text.replace("[device_profile: 1]", "[device_profile: 0]")


PORT_ONLY = {"hist_slots"}
JAX_ONLY_EXTRAS = {"hist_tiers"}


def test_profile_matches_jax_per_iteration(data):
    X, y = data
    jbst = _train_jax(X, y, {"device_profile": True}, 5)
    jp = jbst.get_profile()
    bst = _train_port(X, y, {"device_profile": True}, 5)
    tp = bst.get_profile()
    assert tp["n_iters"] == jp["n_iters"] == 5
    assert len(tp["ring"]) == len(jp["ring"]) == 5
    for a, b in zip(tp["ring"], jp["ring"]):
        assert set(a) == set(b)
        assert set(a["stages_s"]) == set(b["stages_s"])
        assert sum(a["stages_s"].values()) == pytest.approx(a["wall_s"],
                                                            rel=0.2)
    jstages = {s for s in jp["stages_s"] if not s.startswith("hist_class_b")}
    assert set(tp["stages_s"]) - PORT_ONLY == jstages
    for s in ITER_STAGES:
        assert tp["stage_counts"][s] == jp["stage_counts"][s] == 5
    assert set(tp["stage_probe"]) == set(jp["stage_probe"]) == {
        "probe_rows", "histogram_s", "split_search_s", "partition_s"}
    g = bst._gbdt
    assert set(g.profiler.extras) == \
        set(jbst._gbdt.profiler.extras) - JAX_ONLY_EXTRAS
    for key in ("hist_impl", "hist_rowwise", "hist_pack4"):
        assert tp[key] == jp[key]
    assert tp["fused_veto_reasons"] == [
        r for r in jp["fused_veto_reasons"] if r != "no_tpu_pallas"]
    # profiling changes no model
    assert _flagless(bst.model_to_string()) == \
        _train_port(X, y, {}, 5).model_to_string()


def test_profile_batched_records_chunks(data, monkeypatch):
    """Batched training (lt.train's default outside the suite): one
    record a round, stage "scan", `batched: True`, the chunk's dispatches
    counted; the same model as without the profiler."""
    monkeypatch.delenv("LIGHTGBM_TPU_DISABLE_BATCHED", raising=False)
    X, y = data
    params = {"device_profile": True, "batched_chunk_size": 2}
    bst = _train_port(X, y, params, 5)
    g = bst._gbdt
    assert g.batched_veto == ""
    p = bst.get_profile()
    assert p["n_iters"] == 5 and len(p["ring"]) == 5
    assert all(r["batched"] and set(r["stages_s"]) == {"scan"}
               for r in p["ring"])
    assert p["stage_counts"]["scan"] == 5
    assert p["counters"]["dispatches"] == g.dispatch_count == 3
    assert p["total_wall_s"] == pytest.approx(
        sum(r["wall_s"] for r in p["ring"]), rel=1e-5)
    plain = _train_port(X, y, {"batched_chunk_size": 2}, 5)
    assert _flagless(bst.model_to_string()) == plain.model_to_string()


def test_profile_fused_extras_match_jax(data):
    """Under histogram_impl=fused the veto lists agree but for the JAX
    package's `no_tpu_pallas` (its Pallas kernels do not run on the CPU);
    the port's fused route records its geometry and one probe."""
    X, y = data
    params = {"device_profile": True, "histogram_impl": "fused"}
    jg = _train_jax(X, y, params, 1)._gbdt
    bst = _train_port(X, y, params, 2)
    g = bst._gbdt
    assert jg.profiler.extras["fused_veto_reasons"] == ["no_tpu_pallas"]
    assert g.profiler.extras["fused_veto_reasons"] == []
    fused = g.profiler.extras["fused"]
    assert fused["path"] == g.grow_route == "fused"
    assert set(fused["probe_s"]) == {"two_pass", "fused"}
    assert "fused_wave_probe" in g.profiler.totals
    assert _flagless(bst.model_to_string()) == _train_port(
        X, y, {"histogram_impl": "fused"}, 2).model_to_string()


def test_record_profile_and_no_flag(data):
    X, y = data
    result = {}
    _train_port(X, y, {"device_profile": True}, 4,
                callbacks=[lt.record_profile(result)])
    assert len(result["wall_s"]) == 4
    assert len(result["stages_s"]["grow"]) == 4
    assert result["profile"]["n_iters"] == 4
    assert _train_port(X, y, {}, 2).get_profile() is None
    with pytest.raises(TypeError):
        lt.record_profile([])


class TestServingProfiler:
    """A profiler on the binned engine (CPU: the bucketize kernel's plain
    version) counts every row served through `bin_rows`, on the raw-f32
    route and the host route, and changes no margin."""

    @pytest.fixture(scope="class")
    def booster(self):
        rng = np.random.RandomState(3)
        X = rng.normal(size=(2000, 5)).astype(np.float32)
        y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
        return lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), 4)

    def test_counters_and_margins(self, booster):
        q = np.random.RandomState(5).normal(size=(300, 5)).astype(
            np.float32)
        kw = dict(engine="binned", binning_impl="device", max_batch=128)
        ref = booster.serve(**kw)
        prof = tprof.StageProfiler()
        sess = booster.serve(profiler=prof, **kw)
        np.testing.assert_array_equal(sess.score_margin(q),
                                      ref.score_margin(q))
        d = prof.to_dict()
        assert d["counters"]["bin_rows_rows"] == 300
        assert d["counters"]["bin_rows_bytes_in"] == q.nbytes
        assert d["stage_counts"]["bin_rows"] == 3        # 128 + 128 + 44
        assert [s["tag"] for s in d["hbm_watermark"]] == ["serve_score"] * 3
        q64 = q.astype(np.float64)
        np.testing.assert_array_equal(sess.score_margin(q64),
                                      ref.score_margin(q64))
        assert prof.counters["bin_rows_rows"] == 600
        assert prof.counters["bin_rows_bytes_in"] == q.nbytes + q64.nbytes
