"""``vq_tpu_torch.GraphIndex`` against ``vq_tpu.GraphIndex`` (JAX on the
CPU), mirroring the cases of ``tests/test_graph.py`` that need no
``parallel/``.

Parity tiers:

* The build's pieces (``_augment_candidates_chunk``,
  ``_robust_prune_chunk``, ``_prune_all`` and ``_reverse_edges``) are bit
  for bit on the same inputs. Their inputs hold small integers, so every
  product and sum is exact in fp32 whatever the order, and any
  difference is logic, not rounding.
* A graph the JAX package built over such a corpus, carried across by
  ``convert.from_state``, searches to the same ids and distances bit for
  bit (ties included: both break them by position), and after the same
  ``add`` and ``remove_ids`` holds the same adjacency, rows and entry
  points. The routing sample that ``add`` folds new ids into is drawn
  from JAX keys on one side and a ``torch.Generator`` on the other, so
  it is compared on its size and range only.
* Seeded builds, whose random long-range candidates, entries and sample
  come from different streams, are compared on recall@10 against the
  exact neighbours, through the exact candidates and (with a small
  ``exact_threshold``) through the IVF-assisted ones.
* The concentration statistic: within rtol 1e-4 of the JAX package's on
  the same rows.
* ``graph_index`` checkpoints load in either package.

A JAX-package build compiles for a minute's fraction, so one module-scoped
JAX build (2,000 x 16, degree 8) serves every cross-package case; the
mirrored cases run on the port alone (n <= 3,000, d <= 32, degree <= 16).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import vq_tpu
import vq_tpu_torch
from vq_tpu import graph as JG
from vq_tpu_torch import GraphIndex, load_index
from vq_tpu_torch import graph as TG
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def recall(ids, gt):
    ids = ids.numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    return np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / gt.shape[1]
                    for i in range(gt.shape[0])])


def _gt(corpus, queries, k=10):
    d = np.sum((corpus[None] - np.asarray(queries)[:, None]) ** 2, axis=-1)
    return np.argsort(d, kind="stable", axis=1)[:, :k]


# ---------------------------------------------------------------------------
# Cross-package parity on integer data.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def icorpus():
    """Small-integer rows in 12 clusters (exact fp32 arithmetic)."""
    r = np.random.default_rng(5)
    centres = r.integers(-12, 13, (12, 16))
    x = centres[r.integers(0, 12, 2200)] + r.integers(-3, 4, (2200, 16))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def jgraph(icorpus):
    return JG.GraphIndex.build(icorpus[:2000], degree=8, seed=3)


def _carried(jg):
    config = {"store_dtype": jg.store_dtype, "alpha": jg.alpha,
              "regime_warning": jg.regime_warning or ""}
    arrays = {"rows": np.asarray(jg._rows), "graph": np.asarray(jg.graph),
              "entry": np.asarray(jg.entry), "sample": np.asarray(jg.sample)}
    return from_state("graph_index", config, arrays)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_and_prune_bit_exact(seed):
    r = np.random.default_rng(seed)
    n, c, r0, rr, d = 300, 64, 12, 4, 8
    x = r.integers(-3, 4, (n, d)).astype(np.float32)
    nodes, nid = x[:c], np.arange(c, dtype=np.int32)
    kid = r.integers(-1, n, (c, r0)).astype(np.int32)
    kd = np.where(kid >= 0, ((x[np.maximum(kid, 0)] - nodes[:, None]) ** 2).sum(-1),
                  np.inf).astype(np.float32)
    rid = r.integers(-1, n, (c, rr)).astype(np.int32)
    rid[:3, 0] = nid[:3]  # the node itself among its random candidates
    ja = JG._augment_candidates_chunk(nodes, nid, kid, kd, rid, x[np.maximum(rid, 0)])
    ta = TG._augment_candidates_chunk(_t(nodes), _t(nid).long(), _t(kid), _t(kd), _t(rid),
                                      _t(x[np.maximum(rid, 0)]))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    np.testing.assert_array_equal(ta[1].numpy(), np.asarray(ja[1]))
    si, sd = np.asarray(ja[0]), np.asarray(ja[1])
    for alpha in (1.0, 1.2):
        jp = JG._robust_prune_chunk(nodes, si, sd, x[np.maximum(si, 0)], jnp.float32(alpha ** 2), 6)
        tp = TG._robust_prune_chunk(_t(nodes), _t(si).long(), _t(sd), _t(x[np.maximum(si, 0)]),
                                    torch.tensor(alpha ** 2, dtype=torch.float32), 6)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_prune_all_bit_exact():
    r = np.random.default_rng(9)
    n, r0, rr, d = 257, 10, 4, 8
    x = r.integers(-4, 5, (n, d)).astype(np.float32)
    kid = r.integers(-1, n, (n, r0)).astype(np.int32)
    kd = np.where(kid >= 0, ((x[np.maximum(kid, 0)] - x[:, None]) ** 2).sum(-1),
                  np.inf).astype(np.float32)
    rand = r.integers(0, n, (n, rr)).astype(np.int32)
    a2 = np.float32(1.2 ** 2)
    j = JG._prune_all_jit(jnp.asarray(x), jnp.asarray(kid), jnp.asarray(kd), jnp.asarray(rand),
                          jnp.float32(a2), 5, 2, 64)
    for chunk in (None, 100):  # a node's edges do not depend on its chunk
        t = TG._prune_all(_t(x), _t(kid).long(), _t(kd), _t(rand).long(),
                          torch.tensor(a2), 5, 2, chunk)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("cap", [2, 4, 9])
def test_reverse_edges_bit_exact(cap):
    fwd = np.random.default_rng(cap).integers(-1, 150, (150, 6)).astype(np.int32)
    j = JG._reverse_edges(jnp.asarray(fwd), 150, cap)
    np.testing.assert_array_equal(TG._reverse_edges(_t(fwd), 150, cap).numpy(), np.asarray(j))


@pytest.mark.parametrize("beam", [16, 32, 64])
def test_carried_graph_searches_like_jax(icorpus, jgraph, beam):
    q = icorpus[2000:2040]
    tg = _carried(jgraph)
    ji, jd = jgraph.search(q, 10, beam=beam)
    ti, td = tg.search(q, 10, beam=beam)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_search_core_equals_search(icorpus, jgraph):
    tg = _carried(jgraph)
    fn, arrays = tg._search_core(5, beam=24)
    q = _t(icorpus[2000:2010])
    for a, b in zip(fn(q, *arrays), tg.search(q, 5, beam=24)):
        assert torch.equal(a, b)


def test_add_matches_jax(icorpus, jgraph):
    import copy

    jg = copy.copy(jgraph)
    tg = _carried(jgraph)
    new = icorpus[2000:2150]
    jg.add(new)
    tg.add(new)
    np.testing.assert_array_equal(tg.graph.numpy(), np.asarray(jg.graph))
    np.testing.assert_array_equal(tg._rows.numpy(), np.asarray(jg._rows))
    np.testing.assert_array_equal(tg._sqn.numpy(), np.asarray(jg._sqn))
    np.testing.assert_array_equal(tg.entry.numpy(), np.asarray(jg.entry))
    # The routing sample: JAX keys against a torch.Generator.
    assert tg.sample.shape == jg.sample.shape
    assert int(tg.sample.max()) < 2150 and int((tg.sample >= 2000).sum()) > 0


def test_remove_ids_matches_jax(icorpus, jgraph):
    import copy

    jg = copy.copy(jgraph)
    tg = _carried(jgraph)
    drop = np.sort(np.random.default_rng(2).choice(2000, 150, replace=False))
    drop = np.union1d(drop, np.asarray(jg.entry)[:3])
    assert tg.remove_ids(drop) == jg.remove_ids(drop) == drop.size
    np.testing.assert_array_equal(tg.graph.numpy(), np.asarray(jg.graph))
    np.testing.assert_array_equal(tg._rows.numpy(), np.asarray(jg._rows))
    np.testing.assert_array_equal(tg.entry.numpy(), np.asarray(jg.entry))
    np.testing.assert_array_equal(tg.sample.numpy(), np.asarray(jg.sample))
    q = icorpus[2000:2020]
    np.testing.assert_array_equal(tg.search(q, 5)[0].numpy(), np.asarray(jg.search(q, 5)[0]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_index_checkpoints_either_way(icorpus, jgraph, tmp_path, writer):
    q = icorpus[2000:2016]
    tg = _carried(jgraph)
    if writer == "jax":
        got = load_index(jgraph.save(str(tmp_path / "jg")))
        assert isinstance(got, GraphIndex)
        want = jgraph.search(q, 5)
    else:
        got = tg
        back = vq_tpu.load_index(tg.save(str(tmp_path / "tg")))
        assert isinstance(back, vq_tpu.GraphIndex) and back.alpha == tg.alpha
        want = back.search(q, 5)
    gi, gd = got.search(q, 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(want[1]))


def test_bf16_checkpoint_either_way(icorpus, tmp_path):
    tg = GraphIndex.build(icorpus[:600] / 7.0, degree=4, store_dtype="bfloat16", seed=1)
    j = vq_tpu.load_index(tg.save(str(tmp_path / "b16")))
    np.testing.assert_array_equal(np.asarray(j._rows).astype(np.float32),
                                  tg._rows.float().numpy())
    back = GraphIndex.load(j.save(str(tmp_path / "b16j")))
    assert back.store_dtype == "bfloat16" and torch.equal(back._rows, tg._rows)


@pytest.mark.parametrize("exact_threshold", [200_000, 500])
def test_seeded_build_recall_like_jax(icorpus, jgraph, exact_threshold):
    """The exact candidates, and with a small ``exact_threshold`` the
    IVF-assisted ones; recall@10 within 0.05 of the JAX build's."""
    corpus, q = icorpus[:2000], icorpus[2000:2060]
    gt = _gt(corpus, q)
    tg = GraphIndex.build(corpus, degree=8, seed=3, exact_threshold=exact_threshold)
    r_j = recall(jgraph.search(q, 10, beam=32)[0], gt)
    r_t = recall(tg.search(q, 10, beam=32)[0], gt)
    assert r_t >= r_j - 0.05 and r_t >= 0.8


def test_concentration_statistic_matches_jax():
    r = np.random.default_rng(66)
    centres = r.normal(size=(50, 16)).astype(np.float32) * 2.0
    for noise in (0.15, 1.0):
        rows = (centres[r.integers(0, 50, 1024)] + noise * r.normal(size=(1024, 16))).astype(
            np.float32)
        j = float(JG._concentration_stat_jit(jnp.asarray(rows)))
        t = float(TG._concentration_stat(_t(rows)))
        assert abs(t - j) <= 1e-4 * abs(j)


# ---------------------------------------------------------------------------
# The cases of tests/test_graph.py, on the port.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(77)
    centers = r.normal(0, 3.0, (20, 32)).astype(np.float32)
    return (centers[r.integers(0, 20, 3000)] + r.normal(0, 0.5, (3000, 32))).astype(np.float32)


@pytest.fixture(scope="module")
def queries(corpus):
    return corpus[:48] + np.random.default_rng(78).normal(0, 0.01, (48, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def gt(corpus, queries):
    return _gt(corpus, queries)


@pytest.fixture(scope="module")
def idx(corpus):
    return GraphIndex.build(corpus, degree=16, alpha=1.2, seed=1)


class TestSearch:
    def test_high_recall_at_default_beam(self, idx, queries, gt):
        ids, d = idx.search(queries, k=10, beam=64)
        assert recall(ids, gt) >= 0.95
        ids_np, d_np = ids.numpy(), d.numpy()
        rec = idx.reconstruct(np.maximum(ids_np, 0)).numpy()
        want = np.sum((rec - queries[:, None]) ** 2, axis=-1)
        ok = ids_np >= 0
        np.testing.assert_allclose(d_np[ok], want[ok], rtol=1e-4, atol=1e-3)
        assert np.isinf(d_np[~ok]).all()

    def test_beam_monotone(self, idx, queries, gt):
        r_small = recall(idx.search(queries, k=10, beam=16)[0], gt)
        r_big = recall(idx.search(queries, k=10, beam=96)[0], gt)
        assert r_big >= r_small - 0.02 and r_big >= 0.95

    def test_single_query_vector(self, idx, corpus):
        ids, d = idx.search(corpus[7], k=3)
        assert tuple(ids.shape) == (1, 3) and int(ids[0, 0]) == 7
        assert float(d[0, 0]) < 1e-3

    def test_k_larger_than_ntotal_pads(self, corpus):
        gi = GraphIndex.build(corpus[:30], degree=8)
        ids, d = gi.search(corpus[:2], k=50, beam=64)
        assert tuple(ids.shape) == (2, 50)
        assert (ids[:, 30:] == -1).all() and torch.isinf(d[:, 30:]).all()

    def test_dim_mismatch(self, idx):
        with pytest.raises(DimensionMismatch):
            idx.search(np.zeros((2, 5), np.float32), k=3)

    def test_search_and_reconstruct(self, idx, corpus):
        ids, vals, rec = idx.search_and_reconstruct(corpus[:4], k=3)
        assert tuple(rec.shape) == (4, 3, 32)
        torch.testing.assert_close(rec[:, 0], idx.reconstruct(ids[:, 0]))


class TestBuild:
    def test_adjacency_shape_and_validity(self, idx, corpus):
        g = idx.graph.numpy()
        assert g.shape == (corpus.shape[0], 32) and g.dtype == np.int32
        assert g.max() < corpus.shape[0] and (g >= -1).all()
        assert not (g[:, :16] == np.arange(corpus.shape[0])[:, None]).any()

    def test_ivf_assisted_candidates(self, corpus, queries, gt):
        gi = GraphIndex.build(corpus, degree=16, alpha=1.2, exact_threshold=1000, seed=2)
        assert recall(gi.search(queries, k=10, beam=64)[0], gt) >= 0.9

    def test_bf16_storage(self, corpus, queries, gt):
        gi = GraphIndex.build(corpus, degree=16, store_dtype="bfloat16")
        assert gi._rows.dtype == torch.bfloat16
        assert recall(gi.search(queries, k=10, beam=64)[0], gt) >= 0.9

    @pytest.mark.parametrize("kw", [dict(n=0), dict(degree=0), dict(alpha=0.5),
                                    dict(store_dtype="f16")])
    def test_bad_args_match_jax(self, corpus, kw):
        n = kw.pop("n", 50)
        x = corpus[:n] if n else np.zeros((0, 4), np.float32)
        with pytest.raises(vq_tpu.errors.InvalidParameter) as je:
            vq_tpu.GraphIndex.build(x, **kw)
        with pytest.raises(InvalidParameter) as te:
            GraphIndex.build(x, **kw)
        assert te.value.parameter == je.value.parameter

    def test_alpha_one_is_plain_prune(self, corpus, queries, gt):
        gi = GraphIndex.build(corpus, degree=16, alpha=1.0, seed=3)
        assert recall(gi.search(queries, k=10, beam=64)[0], gt) >= 0.85

    def test_degree_one_and_two_keep_contract(self, corpus):
        for deg in (1, 2):
            gi = GraphIndex.build(corpus[:300], degree=deg, seed=1)
            assert tuple(gi.graph.shape) == (300, 2 * deg)
            assert (gi.search(corpus[:3], k=2, beam=16)[0][:, 0] >= 0).all()

    def test_picks_wider_than_beam_clamped(self, idx, corpus):
        assert tuple(idx.search(corpus[:3], k=4, beam=8, picks_per_iter=32)[0].shape) == (3, 4)


class TestLifecycle:
    def test_save_load_roundtrip(self, idx, queries, tmp_path):
        back = GraphIndex.load(idx.save(str(tmp_path / "g.npz")))
        for a, b in zip(idx.search(queries, k=5), back.search(queries, k=5)):
            assert torch.equal(a, b)

    def test_generic_load_index(self, idx, tmp_path):
        back = load_index(idx.save(str(tmp_path / "g2.npz")))
        assert isinstance(back, GraphIndex) and back.ntotal == idx.ntotal

    def test_wrong_kind_rejected(self, corpus, tmp_path):
        p = vq_tpu_torch.FlatIndex.from_data(corpus[:50]).save(str(tmp_path / "flat.npz"))
        with pytest.raises(InvalidData):
            GraphIndex.load(p)

    def test_empty_search_raises(self):
        gi = GraphIndex(np.zeros((0, 4), np.float32), np.zeros((0, 2), np.int32),
                        np.zeros((0,), np.int32))
        with pytest.raises(EmptyInput):
            gi.search(np.zeros((1, 4), np.float32))

    def test_merge_from_refused(self, idx):
        with pytest.raises(InvalidData, match="rebuild"):
            idx.merge_from(idx)


class TestIncrementalAdd:
    def test_matches_full_build_quality(self, corpus):
        full = GraphIndex.build(corpus, degree=16, seed=3)
        inc = GraphIndex.build(corpus[:2000], degree=16, seed=3)
        inc.add(corpus[2000:2500])
        inc.add(corpus[2500:])
        assert inc.ntotal == corpus.shape[0]
        q = corpus[:32] + np.random.default_rng(79).normal(0, 0.01, (32, 32)).astype(np.float32)
        g = _gt(corpus, q)
        assert recall(inc.search(q, 10, beam=48)[0], g) >= recall(
            full.search(q, 10, beam=48)[0], g) - 0.05

    def test_new_points_findable(self, corpus):
        gi = GraphIndex.build(corpus[:2000], degree=16, seed=4)
        new = corpus[2000:2400]
        gi.add(new)
        assert np.mean(gi.search(new[:32] + 0.001, 1, beam=48)[0][:, 0].numpy() >= 2000) > 0.9

    def test_disjoint_cluster_reachable(self, corpus):
        gi = GraphIndex.build(corpus[:2000], degree=16, seed=5)
        far = (corpus[:300] * 0.05 + 40.0).astype(np.float32)
        gi.add(far)
        assert np.mean(gi.search(far[:16] + 0.001, 1, beam=48)[0][:, 0].numpy() >= 2000) > 0.9

    def test_single_vector_and_1d(self, corpus):
        gi = GraphIndex.build(corpus[:500], degree=8, seed=6)
        gi.add(corpus[500])
        assert gi.ntotal == 501 and int(gi.search(corpus[500], 1, beam=32)[0][0, 0]) == 500

    def test_dim_mismatch(self, corpus):
        gi = GraphIndex.build(corpus[:500], degree=8, seed=7)
        with pytest.raises(DimensionMismatch):
            gi.add(corpus[:5, :-1])

    def test_save_load_roundtrips_alpha_and_adds(self, corpus, tmp_path):
        gi = GraphIndex.build(corpus[:800], degree=8, alpha=1.4, seed=8)
        gi.add(corpus[800:900])
        ld = GraphIndex.load(gi.save(str(tmp_path / "g")))
        assert ld.alpha == 1.4 and ld.ntotal == 900
        ld.add(corpus[900:950])
        assert ld.ntotal == 950

    def test_factory_hnsw_spec(self, corpus):
        f = vq_tpu_torch.index_factory(32, "HNSW16")
        f.train(corpus[:2000])
        assert f.ntotal == 2000
        f.add(corpus[2000:2200])
        assert f.ntotal == 2200 and tuple(f.search(corpus[:8], 5, beam=32)[0].shape) == (8, 5)
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.index_factory(32, "HNSW16,RSQ8")

    def test_bf16_sqn_consistent_across_save_load(self, corpus, tmp_path):
        gi = GraphIndex.build(corpus[:800], degree=8, seed=12, store_dtype="bfloat16")
        gi.add(corpus[800:1000])
        q = corpus[:24] + 0.001
        i1, d1 = gi.search(q, 5, beam=32)
        i2, d2 = GraphIndex.load(gi.save(str(tmp_path / "g16"))).search(q, 5, beam=32)
        assert torch.equal(i1, i2) and torch.equal(d1, d2)

    def test_backlink_cap_keeps_nearest(self):
        r = np.random.default_rng(13)
        old = np.concatenate([np.zeros((1, 8), np.float32),
                              (r.normal(0, 0.05, (15, 8)) + 20.0).astype(np.float32)])
        gi = GraphIndex.build(old, degree=2, seed=14)  # W = 4
        dirs = r.normal(size=(12, 8)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        gi.add(dirs * np.linspace(2.0, 0.1, 12, dtype=np.float32)[:, None])
        assert (16 + 11) in set(gi.graph[0].tolist())  # the closest new point won a slot


class TestRemoveIds:
    def test_renumbers_and_repairs(self, corpus, queries):
        gi = GraphIndex.build(corpus, degree=16, seed=21)
        drop = np.sort(np.random.default_rng(21).choice(corpus.shape[0], 300, replace=False))
        assert gi.remove_ids(drop) == 300
        keep = np.setdiff1d(np.arange(corpus.shape[0]), drop)
        assert gi.ntotal == keep.size
        np.testing.assert_array_equal(gi.reconstruct(np.arange(5)).numpy(), corpus[keep[:5]])
        ids, _ = gi.search(queries, k=10, beam=64)
        assert int(ids.max()) < keep.size
        assert recall(ids, _gt(corpus[keep], queries)) >= 0.9

    def test_removed_top1_yields_runner_up(self, corpus):
        gi = GraphIndex.build(corpus[:1000], degree=16, seed=22)
        d = np.sum((corpus[:1000] - corpus[7]) ** 2, axis=-1)
        d[7] = np.inf
        runner = int(np.argmin(d))
        gi.remove_ids([7])
        got = int(gi.search(corpus[7], k=1, beam=48)[0][0, 0])
        assert got == (runner - 1 if runner > 7 else runner)

    def test_noop_and_validation(self, corpus):
        gi = GraphIndex.build(corpus[:200], degree=8, seed=23)
        assert gi.remove_ids(np.zeros((0,), np.int32)) == 0
        assert gi.remove_ids([5, 5, 5]) == 1
        for bad in ([500], [-1]):
            with pytest.raises(InvalidParameter):
                gi.remove_ids(bad)

    def test_remove_all_then_empty(self, corpus):
        gi = GraphIndex.build(corpus[:100], degree=8, seed=24)
        assert gi.remove_ids(np.arange(100)) == 100 and gi.ntotal == 0
        with pytest.raises(EmptyInput):
            gi.search(corpus[:1], k=1)
        with pytest.raises(EmptyInput):
            gi.remove_ids([0])

    def test_entry_points_removed_falls_back(self, corpus):
        gi = GraphIndex.build(corpus[:800], degree=8, seed=25)
        gi.remove_ids(np.unique(gi.entry.numpy()))
        assert gi.entry.shape[0] >= 1
        assert (gi.search(corpus[:4], k=3, beam=32)[0][:, 0] >= 0).all()

    def test_save_load_after_removal(self, corpus, tmp_path):
        gi = GraphIndex.build(corpus[:600], degree=8, seed=26)
        gi.remove_ids(np.arange(0, 600, 7))
        q = corpus[1:9]
        i1, _ = gi.search(q, 5, beam=32)
        i2, _ = GraphIndex.load(gi.save(str(tmp_path / "gr"))).search(q, 5, beam=32)
        assert torch.equal(i1, i2)

    def test_add_after_remove(self, corpus):
        gi = GraphIndex.build(corpus[:500], degree=8, seed=27)
        gi.remove_ids(np.arange(100))
        gi.add(corpus[500:550])
        assert gi.ntotal == 450 and int(gi.search(corpus[510], k=1, beam=32)[0][0, 0]) == 410

    def test_bridge_pads_cannot_wipe_adjacency(self):
        si, sd = TG._augment_candidates_chunk(
            torch.zeros((1, 4)), torch.tensor([5]), torch.tensor([[7, -1]]),
            torch.tensor([[9.0, np.inf]]), torch.tensor([[-1, -1, 3]]), torch.zeros((1, 3, 4)))
        si, sd = si[0].numpy(), sd[0].numpy()
        assert (si[np.isfinite(sd)] >= 0).all() and si[0] == 3 and si[1] == 7
        r = np.random.default_rng(31)
        x = np.concatenate([
            np.zeros((1, 8), np.float32), r.normal(0, 0.02, (1, 8)).astype(np.float32),
            (r.normal(0, 0.02, (4, 8)) + 0.3).astype(np.float32),
            (r.normal(0, 0.05, (7, 8)) + 50.0).astype(np.float32)])
        gi = GraphIndex.build(x, degree=2, seed=32)
        gi.remove_ids([2, 3, 4, 5])
        assert (gi.graph >= 0).any(1).all()


class TestRegimeGuardrail:
    """The build-time cluster-concentration warning. Its statistic needs
    ``_CONCENTRATION_MIN_ROWS`` (10,000) rows; the builds here lower that
    floor to keep the port's tests small, and the statistic itself is
    held to the JAX package's above."""

    @staticmethod
    def _clustered(noise, n=3000, d=16, nlist=100, seed=66):
        r = np.random.default_rng(seed)
        centers = r.normal(size=(nlist, d)).astype(np.float32) * 2.0
        return (centers[r.integers(0, nlist, n)] + noise * r.normal(size=(n, d))).astype(
            np.float32)

    def test_warns_on_tight_clusters_and_persists(self, tmp_path, monkeypatch):
        monkeypatch.setattr(TG, "_CONCENTRATION_MIN_ROWS", 2000)
        with pytest.warns(RuntimeWarning, match="cluster concentration"):
            gi = GraphIndex.build(self._clustered(noise=0.15), degree=8, seed=1)
        assert gi.regime_warning is not None and "IVF" in gi.regime_warning
        assert GraphIndex.load(gi.save(str(tmp_path / "t"))).regime_warning == gi.regime_warning

    def test_silent_on_smooth_density(self, tmp_path, monkeypatch):
        monkeypatch.setattr(TG, "_CONCENTRATION_MIN_ROWS", 2000)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            gi = GraphIndex.build(self._clustered(noise=1.0), degree=8, seed=1)
        assert gi.regime_warning is None
        assert GraphIndex.load(gi.save(str(tmp_path / "s"))).regime_warning is None

    def test_small_corpora_skip_the_statistic(self):
        data = self._clustered(noise=0.05, n=512, nlist=8)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            assert GraphIndex.build(data, degree=8, seed=1).regime_warning is None

    def test_statistic_separates_regimes(self):
        tight = TG._concentration_stat(_t(self._clustered(noise=0.15)[:2048]))
        smooth = TG._concentration_stat(_t(self._clustered(noise=1.0)[:2048]))
        assert float(tight) < TG._CONCENTRATION_WARN < float(smooth)
