"""``vq_tpu_torch.tune`` against ``vq_tpu.tune`` (JAX on the CPU),
mirroring ``tests/test_tune.py``.

Parity tiers: ``recall_at``, ``pareto`` and ``OperatingPoint.dominates``
equal on the same inputs; ``exact_neighbors`` by ``assert_probe_parity``
(values within rtol 1e-5 / atol 1e-4, ids equal at separated ranks);
``default_grid`` the same grid for every index type, the port's index
loaded from the JAX package's checkpoint; ``sweep`` over such a carried
index the same parameters and recalls in the same order, and ``tune``
the same choice, with each package's timer replaced by the same cost of
the parameters (the times themselves are left out of the comparison).
"""

import importlib

import numpy as np
import pytest

import vq_tpu
import vq_tpu_torch
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

# The modules (each package's ``tune`` attribute is the function).
JT = importlib.import_module("vq_tpu.tune")
TT = importlib.import_module("vq_tpu_torch.tune")


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _corpus(n=800, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, d)).astype(np.float32)).astype(
        np.float32)


@pytest.fixture(scope="module")
def x():
    return _corpus()


@pytest.fixture(scope="module")
def q():
    return _corpus(n=32, seed=9)


def test_exported():
    names = {"tune", "sweep", "pareto", "OperatingPoint", "exact_neighbors", "recall_at"}
    assert names <= set(vq_tpu_torch.__all__)


class TestPrimitives:
    def test_exact_neighbors_match_jax(self, x, q):
        ti, tv = TT.exact_neighbors(x, q, k=5)
        ji, jv = JT.exact_neighbors(x, q, k=5)
        assert isinstance(ti, np.ndarray) and isinstance(tv, np.ndarray)
        assert_probe_parity((ti, tv), (ji, jv), rtol=1e-5, atol=1e-4)

    def test_exact_neighbors_self(self, x):
        ids, vals = TT.exact_neighbors(x, x[:10], k=1)
        np.testing.assert_array_equal(ids[:, 0], np.arange(10))
        np.testing.assert_allclose(vals[:, 0], 0.0, atol=1e-3)

    def test_recall_matches_jax(self):
        r = np.random.default_rng(3)
        for _ in range(5):
            gt = r.integers(-1, 20, (6, 4))
            ids = r.integers(-1, 20, (6, 4))
            assert TT.recall_at(ids, gt) == JT.recall_at(ids, gt)
        assert TT.recall_at(np.array([[0, -1, -1]]), np.array([[0, -1, -1]])) == 1.0

    def test_recall_takes_tensors(self):
        import torch

        gt = np.array([[0, 1, 2], [3, 4, 5]])
        assert TT.recall_at(torch.from_numpy(gt), gt) == 1.0

    def test_recall_shape_mismatch(self):
        with pytest.raises(vq_tpu.errors.InvalidParameter) as je:
            JT.recall_at(np.zeros((2, 3)), np.zeros((3, 3)))
        with pytest.raises(InvalidParameter) as te:
            TT.recall_at(np.zeros((2, 3)), np.zeros((3, 3)))
        assert te.value.parameter == je.value.parameter

    def test_dominates_and_pareto_match_jax(self):
        r = np.random.default_rng(4)
        vals = [(float(a), float(b)) for a, b in zip(r.integers(0, 5, 12) / 4,
                                                     r.integers(1, 6, 12))]
        tp = [TT.OperatingPoint(params={"i": i}, recall=a, time_ms=b, qps=1 / b)
              for i, (a, b) in enumerate(vals)]
        jp = [JT.OperatingPoint(params={"i": i}, recall=a, time_ms=b, qps=1 / b)
              for i, (a, b) in enumerate(vals)]
        for i in range(12):
            for j in range(12):
                assert tp[i].dominates(tp[j]) == jp[i].dominates(jp[j])
        assert [p.params for p in TT.pareto(tp)] == [p.params for p in JT.pareto(jp)]


def _carry(jidx, tmp_path, name):
    return vq_tpu_torch.load_index(jidx.save(str(tmp_path / name)))


@pytest.fixture(scope="module")
def pairs(x, tmp_path_factory):
    """``{name: (JAX index, the port's loaded from its checkpoint)}``."""
    v = vq_tpu
    d = tmp_path_factory.mktemp("tune")
    pq = v.ProductQuantizer(x, 4, 16, max_iters=3, seed=1)
    ivf = v.IVFFlatIndex.train(x, 6, max_iters=3, seed=1)
    out = {
        "flat": v.FlatIndex.from_data(x),
        "pq_bare": v.PQIndex(pq),
        "pq_kept": v.PQIndex(pq, keep_corpus=True),
        "sq_kept": v.SQIndex(v.PerDimScalarQuantizer.from_data(x), keep_corpus=True),
        "rq": v.RQIndex(v.ResidualQuantizer(x, 2, 16, max_iters=2, seed=1)),
        "ivfflat": ivf,
        "ivfpq_kept": v.IVFPQIndex.train(x, 4, 4, 16, max_iters=3, seed=1, keep_corpus=True),
        "refine": v.RefineIndex(v.PQIndex(pq), "sq8"),
        "transformed": v.TransformedIndex([v.CenteringTransform(16).fit(x)],
                                          v.IVFFlatIndex(np.asarray(ivf.coarse))),
        "idmap": v.IdMapIndex(v.IVFFlatIndex(np.asarray(ivf.coarse))),
    }
    res = {}
    for name, j in out.items():
        if name == "idmap":
            j.add_with_ids(x, np.arange(x.shape[0], dtype=np.int64) + 5)
        elif name != "flat":
            j.add(x)
        res[name] = (j, _carry(j, d, name))
    g = v.GraphIndex(x, np.full((x.shape[0], 4), -1, np.int32), np.zeros(1, np.int32))
    res["graph"] = (g, from_state("graph_index", {"store_dtype": "float32", "alpha": 1.2},
                                  {"rows": x, "graph": np.asarray(g.graph),
                                   "entry": np.asarray(g.entry), "sample": np.asarray(g.sample)}))
    return res


_NAMES = ["flat", "pq_bare", "pq_kept", "sq_kept", "rq", "ivfflat", "ivfpq_kept", "refine",
          "transformed", "idmap", "graph"]


@pytest.mark.parametrize("name", _NAMES)
def test_default_grid_matches_jax(pairs, name):
    j, t = pairs[name]
    assert type(t).__name__ == type(j).__name__
    for k in (5, 10):
        assert TT.default_grid(t, k) == JT.default_grid(j, k)


def test_default_grid_of_factory_indexes(x):
    jf = vq_tpu.index_factory(16, "IVF4,Flat").train(x, max_iters=2)
    tf = vq_tpu_torch.index_factory(16, "IVF4,Flat").train(x, max_iters=2)
    assert TT.default_grid(tf) == JT.default_grid(jf) == {"nprobe": [1, 2, 4]}


def _fixed_cost(module, monkeypatch):
    """Replace ``module._timed_search``'s time by a cost of the params
    (the product of their values), its ids untouched."""
    real = module._timed_search

    def timed(index, queries, k, params, reps):
        ids, _ = real(index, queries, k, params, 1)
        return ids, float(np.prod([v + 1 for v in params.values()] or [1])) * 1e-3

    monkeypatch.setattr(module, "_timed_search", timed)


@pytest.mark.parametrize("name", ["ivfflat", "pq_kept", "ivfpq_kept", "refine"])
def test_sweep_and_tune_match_jax(pairs, q, x, name, monkeypatch):
    j, t = pairs[name]
    gt, _ = JT.exact_neighbors(x, q, k=5)
    tpts = TT.sweep(t, q, gt, reps=1)
    jpts = JT.sweep(j, q, gt, reps=1)
    assert [p.params for p in tpts] == [p.params for p in jpts]
    assert [p.recall for p in tpts] == [p.recall for p in jpts]
    _fixed_cost(TT, monkeypatch)
    _fixed_cost(JT, monkeypatch)
    for target in (0.5, 0.9, 1.0, 2.0):
        tb = TT.tune(t, q, gt, target_recall=target, reps=1)
        jb = JT.tune(j, q, gt, target_recall=target, reps=1)
        assert tb.params == jb.params and tb.time_ms == jb.time_ms


class TestSweepAndTune:
    def test_full_probe_reaches_exact(self, pairs, x, q):
        gt, _ = TT.exact_neighbors(x, q, k=5)
        by_probe = {p.params["nprobe"]: p for p in TT.sweep(pairs["ivfflat"][1], q, gt, reps=1)}
        assert by_probe[6].recall == 1.0
        recalls = [by_probe[p].recall for p in sorted(by_probe)]
        assert recalls == sorted(recalls)
        assert all(p.time_ms > 0 and p.qps > 0 for p in by_probe.values())

    def test_tune_unreachable_returns_best(self, pairs, x, q):
        gt, _ = TT.exact_neighbors(x, q, k=5)
        best = TT.tune(pairs["ivfflat"][1], q, gt, target_recall=2.0, reps=1)
        assert best.recall <= 1.0 and "nprobe" in best.params

    def test_graph_sweep(self, q):
        xs = _corpus(n=500)
        gt, _ = TT.exact_neighbors(xs, q[:16], k=5)
        g = vq_tpu_torch.GraphIndex.build(xs, degree=8, seed=0)
        pts = TT.sweep(g, q[:16], gt, grid={"beam": [4, 16]}, reps=1)
        assert len(pts) == 2 and pts[1].recall >= pts[0].recall - 0.05

    def test_explicit_grid_product(self, pairs, x, q):
        gt, _ = TT.exact_neighbors(x, q[:8], k=3)
        pts = TT.sweep(pairs["pq_kept"][1], q[:8], gt, grid={"rerank": [0, 12, 48]}, reps=1)
        assert [p.params for p in pts] == [{"rerank": r} for r in (0, 12, 48)]
        assert pts[-1].recall >= pts[0].recall
