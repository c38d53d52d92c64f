"""The port's packed collective payloads, order-encoded split keys and
distributed binning against the JAX package's (parallel/packed.py,
data/dist_binning.py), bitwise, on seeded numpy inputs.

The JAX keys are uint32 lanes; the port carries the same uint32 values in
int64 tensors, so the integers are compared. Distributed binning runs on
two gloo ranks (one launch for the module); the JAX package's own
multi-process path cannot run here (ROADMAP C note 4), so each rank's
merged mappers are held to JAX's BinMapper.find_bin of that rank's sample
over its feature slice, through the JAX wire rows.
"""

import json
import os
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.data import dist_binning as jdb
from lightgbm_tpu.data.binning import BinMapper as JBinMapper
from lightgbm_tpu.parallel import packed as jp
from lightgbm_tpu_torch.data import dist_binning as tdb
from lightgbm_tpu_torch.data.binning import BinMapper as TBinMapper
from lightgbm_tpu_torch.launch import launch_local
from lightgbm_tpu_torch.parallel import packed as tp

# xdist runs several test processes side by side: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gains(rng, n=4096):
    """f32 gains with the cases a sign slip would break: ties, -0.0, +0.0,
    -inf, +inf, tiny and huge magnitudes of both signs."""
    g = (rng.normal(size=n) * 10 ** rng.uniform(-30, 30, size=n)) \
        .astype(np.float32)
    special = np.array([0.0, -0.0, -np.inf, np.inf, 1e-45, -1e-45, 2e18,
                        -2e18, 3.4e38, -3.4e38, 1.0, 1.0, -1.0, -1.0],
                       np.float32)
    g[:special.size] = special
    g[special.size:special.size + 64] = g[special.size]     # a tie run
    return g


def test_encode_gain_key_bitwise():
    g = _gains(np.random.RandomState(0))
    want = np.asarray(jp.encode_gain_key(jnp.asarray(g))).astype(np.int64)
    got = tp.encode_gain_key(torch.from_numpy(g)).numpy()
    assert np.array_equal(got, want)
    # the order is the float order (NaN-free; -0.0 below +0.0)
    order = np.lexsort((got, g))
    assert np.all(np.diff(got[order]) >= 0)
    assert got[1] < got[0]                          # -0.0 below +0.0


@pytest.mark.parametrize("scan_order", [False, True])
def test_encode_split_key_and_decode_bitwise(scan_order):
    rng = np.random.RandomState(1 + scan_order)
    n = 4096
    f = rng.randint(0, 3000, size=n).astype(np.int32)
    f[:8] = [0, 0, 1, 1, (1 << 20) - 1, 5, 5, 5]            # ties, the max
    b = rng.randint(0, 1024, size=n).astype(np.int32)
    dl = rng.rand(n) < 0.5
    ic = rng.rand(n) < 0.3
    want = np.asarray(jp.encode_split_key(
        jnp.asarray(f), jnp.asarray(b), jnp.asarray(dl), jnp.asarray(ic),
        scan_order=scan_order)).astype(np.int64)
    got = tp.encode_split_key(
        torch.from_numpy(f), torch.from_numpy(b), torch.from_numpy(dl),
        torch.from_numpy(ic), scan_order=scan_order).numpy()
    assert np.array_equal(got, want)
    dec_j = np.asarray(jp.decode_key_feature(jnp.asarray(
        want.astype(np.uint32)), scan_order=scan_order))
    dec_t = tp.decode_key_feature(torch.from_numpy(got),
                                  scan_order=scan_order).numpy()
    assert np.array_equal(dec_t, dec_j) and np.array_equal(dec_t, f)
    # without is_cat the flag field is zero in both
    want0 = np.asarray(jp.encode_split_key(
        jnp.asarray(f), jnp.asarray(b), jnp.asarray(dl),
        scan_order=scan_order)).astype(np.int64)
    got0 = tp.encode_split_key(torch.from_numpy(f), torch.from_numpy(b),
                               torch.from_numpy(dl),
                               scan_order=scan_order).numpy()
    assert np.array_equal(got0, want0)


def test_pack_gh_roundtrip_and_pack_safe_bitwise():
    rng = np.random.RandomState(3)
    g = rng.randint(-(1 << 15), 1 << 15, size=(4, 1, 7, 16))
    h = rng.randint(0, 1 << 16, size=(4, 1, 7, 16))
    hist = np.concatenate([g, h], axis=1).astype(np.int32)  # [K, 2, F, B]
    want = np.asarray(jp.pack_gh(jnp.asarray(hist), 1))
    got = tp.pack_gh(torch.from_numpy(hist), 1)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tp.unpack_gh(got, 1).numpy(), hist)
    assert np.array_equal(
        tp.unpack_gh(got, 1).numpy(),
        np.asarray(jp.unpack_gh(jnp.asarray(want), 1)))
    # sums commute with the packing while pack_safe holds
    parts = rng.randint(0, 3, size=(5, 2, 8)).astype(np.int32)
    parts[:, 0] -= 1
    psum = tp.pack_gh(torch.from_numpy(parts), 1).sum(dim=0, keepdim=True)
    assert np.array_equal(tp.unpack_gh(psum, 1).numpy()[0],
                          parts.sum(axis=0))
    for n in (0, 1, 100, 6553, 6554, 32767, 1 << 20):
        for qb in (2, 4, 16, 126, 127, 200):
            assert tp.pack_safe(n, qb) == jp.pack_safe(n, qb)


def _mappers(seed, n=700, F=5):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, F))
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.4, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 4] = 1.0                                            # trivial
    return X


def _js(d) -> str:
    """A mapper dict as canonical JSON (NaN bounds compare equal)."""
    return json.dumps(d, sort_keys=True)


def test_wire_rows_bitwise():
    X = _mappers(4)
    for j in range(X.shape[1]):
        jm = JBinMapper.find_bin(X[:, j], len(X), 63, 3, 20)
        tm = TBinMapper.find_bin(X[:, j], len(X), 63, 3, 20)
        rj, rt = jdb._serialize(jm, 63), tdb._serialize(tm, 63)
        assert np.array_equal(rj, rt, equal_nan=True)
        assert _js(tdb._deserialize(rt).to_dict()) == \
            _js(jdb._deserialize(rj).to_dict())


WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import resolve_params
    from lightgbm_tpu_torch.data.dist_binning import distributed_find_mappers
    from lightgbm_tpu_torch.parallel import init_distributed
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    init_distributed(num_machines=2, device_type="cpu")
    rng = np.random.RandomState(4 + rank)
    X = rng.normal(size=(700, 5))
    X[rng.rand(700) < 0.1, 1] = np.nan
    X[rng.rand(700) < 0.4, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 2)
    X[:, 4] = 1.0
    cfg = resolve_params({"max_bin": 63, "min_data_in_bin": 3,
                          "min_data_in_leaf": 20})
    ms = distributed_find_mappers(X, len(X), cfg, [])
    with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
        json.dump([m.to_dict() for m in ms], f)
''')


def test_distributed_find_mappers_two_ranks(tmp_path):
    """Rank r bins features [r F / 2, (r + 1) F / 2) from its own 700-row
    sample; both ranks end with the same list, each slice equal to JAX's
    find_bin of its owner's sample after the wire round trip."""
    script = tmp_path / "w.py"
    script.write_text(WORKER)
    launch_local(2, [sys.executable, str(script), str(tmp_path)],
                 env_extra={"PYTHONPATH": REPO}, timeout=120)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert got[0] == got[1]
    F = 5
    for r in range(2):
        rng = np.random.RandomState(4 + r)
        X = rng.normal(size=(700, 5))
        X[rng.rand(700) < 0.1, 1] = np.nan
        X[rng.rand(700) < 0.4, 2] = 0.0
        X[:, 3] = np.round(X[:, 3] * 2)
        X[:, 4] = 1.0
        for j in range(r * F // 2, (r + 1) * F // 2):
            jm = JBinMapper.find_bin(X[:, j], 700, 63, 3, 20,
                                     pre_filter=True, use_missing=True,
                                     zero_as_missing=False)
            want = jdb._deserialize(jdb._serialize(jm, 63)).to_dict()
            assert _js(want) == _js(got[0][j]), j
