"""``vq_tpu_torch.load_index`` and ``IdMapIndex`` against
``vq_tpu.factory`` (JAX on the CPU), mirroring the ``IdMapIndex`` and
loader tests of ``tests/test_transforms.py``.

Every index kind the port has is written by the JAX package and read by
``vq_tpu_torch.load_index`` (and the other way round): the loaded index
has the same type name, ``ntotal`` and search — values within rtol 1e-5
/ atol 1e-4, ids equal at every rank whose value is apart from its row's
others by more than that (``assert_probe_parity``); Hamming counts and
the ``IdMapIndex`` user ids exactly; ``graph_index`` too, since
``GraphIndex`` is ported.

``index_factory`` (the second half): every spec of the grammar builds
the same pipeline (index, transform and refiner types, nested the same
way) in both packages, or raises the same error class for the same
parameter. Then each built pipeline is filled and searched by its
family's tier: a pipeline with nothing to fit (``Flat``, ``SQfp16`` /
``SQbf16``, ``BFlat``, ``IDMap,Flat``, ``L2norm,Flat``) by
``assert_probe_parity`` (its search equals the JAX package's); one that
trains from a seed (every other), whose streams differ by design
(``torch.Generator`` against threefry), by recall@5 against the exact
neighbours, within 0.15 of the JAX pipeline's.
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch import FlatIndex, IdMapIndex, load_index
from vq_tpu_torch.errors import EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.utils.serialize import _to_npz
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

D = 8


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    centres = rng.normal(0, 3, (6, D)).astype(np.float32)
    x = (centres[rng.integers(0, 6, 400)] + rng.normal(0, 0.5, (400, D))).astype(np.float32)
    q = (centres[rng.integers(0, 6, 6)] + rng.normal(0, 0.5, (6, D))).astype(np.float32)
    return x, q


def _jax_indexes(x):
    """One small JAX index of every kind the port loads, filled with ``x``."""
    v = vq_tpu
    out = {
        "flat_index": v.FlatIndex.from_data(x),
        "pq_index": v.PQIndex(v.ProductQuantizer(x, 2, 16, max_iters=3, seed=1)),
        "binary_index": v.BinaryIndex(D),
        "sq_index": v.SQIndex.from_data(x),
        "rq_index": v.RQIndex(v.ResidualQuantizer(x, 2, 16, max_iters=3, seed=1)),
        "ivfpq_index": v.IVFPQIndex.train(x, 4, 2, 16, max_iters=3, seed=1),
        "ivfflat_index": v.IVFFlatIndex.train(x, 4, max_iters=3, seed=1),
        "ivfsq_index": v.IVFSQIndex.train(x, 4, max_iters=3, seed=1),
        "ivfrq_index": v.IVFRQIndex.train(x, 4, num_stages=2, num_centroids=16, max_iters=3,
                                          seed=1),
        "ivfbinary_index": v.IVFBinaryIndex.train(x, 4, max_iters=3, seed=1),
        "transformed_index": v.TransformedIndex([v.CenteringTransform(D).fit(x)],
                                                v.FlatIndex(D)),
        "refine_index": v.RefineIndex(v.FlatIndex(D), "sq8"),
        "idmap_index": v.IdMapIndex(v.FlatIndex(D)),
    }
    for kind, idx in out.items():
        if kind == "flat_index":
            continue
        if kind == "idmap_index":
            idx.add_with_ids(x, np.arange(x.shape[0], dtype=np.int64) * 3 + 2**33)
        else:
            idx.add(x)
    return out


@pytest.fixture(scope="module")
def jax_indexes(data, tmp_path_factory):
    """``{kind: (JAX index, its checkpoint path)}``."""
    d = tmp_path_factory.mktemp("factory")
    return {kind: (idx, idx.save(str(d / kind))) for kind, idx in _jax_indexes(data[0]).items()}


def _search(idx, q, kind):
    kw = {"nprobe": 2} if kind.startswith("ivf") else {}
    ids, vals = idx.search(q, 5, **kw)
    return np.asarray(ids), np.asarray(vals)


def _same_search(got, want, kind):
    gi, gv = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in got)
    wi, wv = want
    if kind in ("binary_index", "ivfbinary_index"):  # integer Hamming counts
        np.testing.assert_array_equal(gv, wv)
    if kind == "idmap_index":
        assert gi.dtype == np.int64
        np.testing.assert_array_equal(gi, wi)
        return
    assert_probe_parity((gi.astype(np.int32), gv), (wi, wv), rtol=1e-5, atol=1e-4)


_KINDS = ["flat_index", "pq_index", "binary_index", "sq_index", "rq_index", "ivfpq_index",
          "ivfflat_index", "ivfsq_index", "ivfrq_index", "ivfbinary_index", "transformed_index",
          "refine_index", "idmap_index"]


@pytest.mark.parametrize("kind", _KINDS)
def test_load_index_reads_every_jax_kind(data, jax_indexes, kind):
    _, q = data
    jidx, path = jax_indexes[kind]
    tidx = load_index(path)
    assert type(tidx).__name__ == type(jidx).__name__ and tidx.ntotal == jidx.ntotal
    _same_search(_search(tidx, q, kind), _search(jidx, q, kind), kind)


@pytest.mark.parametrize("kind", _KINDS)
def test_port_checkpoints_load_in_jax(data, jax_indexes, tmp_path, kind):
    _, q = data
    tidx = load_index(jax_indexes[kind][1])
    path = tidx.save(str(tmp_path / "t"))
    back = vq_tpu.load_index(path)
    assert type(back).__name__ == type(tidx).__name__ and back.ntotal == tidx.ntotal
    _same_search(_search(tidx, q, kind), _search(back, q, kind), kind)


def test_load_index_device_and_wrappers(jax_indexes):
    idx = load_index(jax_indexes["refine_index"][1], device="cpu")
    assert idx.device == torch.device("cpu") and idx._codes.device == torch.device("cpu")
    assert isinstance(idx.base, FlatIndex)


def test_graph_index_not_yet_ported(data, tmp_path):
    """Earlier slices refused ``graph_index`` checkpoints; since
    ``GraphIndex`` is ported, one the JAX package wrote loads as one."""
    x, q = data
    j = vq_tpu.GraphIndex.build(x, degree=4, seed=1)
    got = load_index(j.save(str(tmp_path / "g")))
    assert type(got).__name__ == "GraphIndex" and got.ntotal == j.ntotal
    _same_search(_search(got, q, "graph_index"), _search(j, q, "graph_index"), "graph_index")
    with pytest.raises(KeyError):  # a graph_index checkpoint with no arrays
        load_index(_to_npz(str(tmp_path / "empty"), "graph_index", {}, {}))


def test_not_an_index(tmp_path, data):
    pq = vq_tpu_torch.ProductQuantizer(data[0], 2, 16, max_iters=2)
    with pytest.raises(InvalidData, match="not an index checkpoint"):
        load_index(vq_tpu_torch.save(str(tmp_path / "pq"), pq))
    np.savez(str(tmp_path / "raw.npz"), a=np.zeros(3))
    with pytest.raises(InvalidData):
        load_index(str(tmp_path / "raw.npz"))


def test_wrapper_without_base_rejected():
    from vq_tpu_torch.convert import from_state

    with pytest.raises(InvalidData):
        from_state("idmap_index", {}, {"ids": np.zeros(0, np.int64)})


# ---------------------------------------------------------------------------
# IdMapIndex.
# ---------------------------------------------------------------------------


class TestIdMapIndex:
    def test_matches_jax(self, data):
        x, q = data
        ids = np.random.default_rng(3).permutation(10_000)[:400].astype(np.int64) * 7
        j, t = vq_tpu.IdMapIndex(vq_tpu.FlatIndex(D)), IdMapIndex(FlatIndex(D))
        j.add_with_ids(x, ids)
        t.add_with_ids(x, ids)
        (ti, tv), (ji, jv) = t.search(q, 4), j.search(q, 4)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
        gone = ids[::3][:50].tolist() + [123456789]
        assert t.remove_ids(gone) == j.remove_ids(gone) == 50
        np.testing.assert_array_equal(t._ids, j._ids)
        np.testing.assert_array_equal(t.search(q, 4)[0].numpy(), j.search(q, 4)[0])
        kept = ids[[1, 2, 4]]  # ids[::3] went
        np.testing.assert_array_equal(t.reconstruct(kept).numpy(), np.asarray(j.reconstruct(kept)))

    def test_add_with_ids_and_search(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        ids = np.arange(1000, 1200, dtype=np.int64) * 7
        idx.add_with_ids(x[:200], ids)
        assert idx.ntotal == 200 and idx.dim == D
        got, _ = idx.search(x[10:12], k=1)
        np.testing.assert_array_equal(got[:, 0].numpy(), ids[[10, 11]])

    def test_auto_ids_continue_from_the_maximum(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:3], [5, 9, 2])
        idx.add(x[3:5])
        np.testing.assert_array_equal(idx._ids, [5, 9, 2, 10, 11])
        idx.add(x[5])
        assert idx._ids[-1] == 12

    def test_duplicate_ids_rejected(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:5], np.arange(5))
        with pytest.raises(InvalidParameter):
            idx.add_with_ids(x[5:10], np.arange(4, 9))
        with pytest.raises(InvalidParameter):
            idx.add_with_ids(x[5:7], np.array([99, 99]))
        with pytest.raises(InvalidParameter):
            idx.add_with_ids(x[5:7], np.array([99]))

    def test_remove_by_user_id(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:10], np.arange(10) * 100)
        assert idx.remove_ids(torch.tensor([300, 500, 99999])) == 2 and idx.ntotal == 8
        assert idx.remove_ids([12345]) == 0
        got, _ = idx.search(x[4:5], k=1)
        assert int(got[0, 0]) == 400

    def test_reconstruct_by_user_id(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:10], np.arange(10)[::-1] + 50)  # 59..50
        np.testing.assert_array_equal(idx.reconstruct([59, 50]).numpy(), x[[0, 9]])
        with pytest.raises(InvalidParameter):
            idx.reconstruct([1234])

    def test_range_search_translates(self, data):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:100], np.arange(100, dtype=np.int64) + 777)
        ids_r, _, counts = idx.range_search(x[:2], 1e9, max_results=100)
        assert (ids_r.numpy() >= 777).all()
        np.testing.assert_array_equal(counts.numpy(), [100, 100])
        small = idx.range_search(x[:1], 1e-6, max_results=5)[0].numpy()
        assert small[0, 0] == 777 and (small[0, 1:] == -1).all()  # -1 pads kept

    def test_search_and_reconstruct_and_merge(self, data):
        x, _ = data
        a, b = IdMapIndex(FlatIndex(D)), IdMapIndex(FlatIndex(D))
        a.add_with_ids(x[:20], np.arange(20))
        b.add_with_ids(x[20:30], np.arange(100, 110))
        assert a.merge_from(b) == 10 and a.ntotal == 30 and b.ntotal == 0
        ids, _, rec = a.search_and_reconstruct(x[25:26], k=1)
        assert int(ids[0, 0]) == 105
        np.testing.assert_array_equal(rec[0, 0].numpy(), x[25])
        c = IdMapIndex(FlatIndex(D))
        c.add_with_ids(x[:1], [0])
        with pytest.raises(InvalidData):
            a.merge_from(c)
        with pytest.raises(InvalidParameter):
            a.merge_from(FlatIndex(D))

    def test_int64_ids_survive_translate(self):
        x = np.random.default_rng(7).normal(0, 1, (16, D)).astype(np.float32)
        idx = IdMapIndex(FlatIndex(D))
        big = np.arange(16, dtype=np.int64) + 2**40
        idx.add_with_ids(x, big)
        ids, _ = idx.search(x[:3], k=1)
        assert ids.dtype == torch.int64
        np.testing.assert_array_equal(ids[:, 0].numpy(), big[:3])
        np.testing.assert_allclose(idx.reconstruct(big[:2]).numpy(), x[:2], rtol=1e-6)

    def test_save_load(self, data, tmp_path):
        x, _ = data
        idx = IdMapIndex(FlatIndex(D))
        idx.add_with_ids(x[:30], np.arange(30, dtype=np.int64) * 3)
        back = load_index(idx.save(str(tmp_path / "idmap.npz")))
        assert isinstance(back, IdMapIndex) and repr(back).startswith("IdMapIndex(ntotal=30")
        assert torch.equal(back.search(x[:2], k=2)[0], idx.search(x[:2], k=2)[0])
        assert isinstance(IdMapIndex.load(str(tmp_path / "idmap")), IdMapIndex)

    def test_empty_raises(self):
        idx = IdMapIndex(FlatIndex(D))
        with pytest.raises(EmptyInput):
            idx.remove_ids([1])
        with pytest.raises(EmptyInput):
            idx.reconstruct([0])

    def test_no_pipeline(self, data):
        idx = IdMapIndex(FlatIndex(D))
        idx.add(data[0][:10])
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.BatchPipeline(idx, k=2)


# ---------------------------------------------------------------------------
# index_factory.
# ---------------------------------------------------------------------------

_SPECS = ["Flat", "SQfp16", "SQbf16", "SQ8", "SQ4", "PQ4", "PQ8x4", "RQ2x4", "BFlat", "LSH8",
          "BIVF8", "HNSW8", "IVF8,Flat", "IVF8,SQ8", "IVF8,PQ4", "IVF8,PQ4+4", "IVF8,RQ2x4",
          "PCA4,SQ8", "PCAW4,Flat", "L2norm,Flat", "RR,Flat", "OPQ4,PQ4", "ITQ4,BFlat",
          "ITQ,BFlat", "IDMap,Flat", "IDMap,PCA4,IVF8,PQ4", "IVF8,PQ4,RFlat",
          "IVF8,Flat,RFlat16", "IVF8,PQ4,RSQ8", "PQ4,RFlat", "BFlat,RFlat"]
# Specs with nothing to fit: the two packages hold the same rows and search alike.
_EXACT = ("Flat", "SQfp16", "SQbf16", "BFlat", "IDMap,Flat", "L2norm,Flat")
_SEARCH_KW = {"IVF": {"nprobe": 4}, "HNSW": {"beam": 32}}


def _shape(idx):
    """The pipeline's nested type names (and a refine index's kind)."""
    name = type(idx).__name__
    if name == "IdMapIndex":
        return (name, _shape(idx.base))
    if name == "RefineIndex":
        return (name, idx.kind, _shape(idx.base))
    if name == "TransformedIndex":
        return (name, tuple(type(t).__name__ for t in idx.transforms), _shape(idx.base))
    return name


def _kw(spec):
    head = spec.split(",")[-1] if spec.startswith("IDMap") else spec
    for key, kw in _SEARCH_KW.items():
        if key in spec and (key != "IVF" or not head.startswith("BIVF")):
            return dict(kw)
    return {"nprobe": 4} if "BIVF" in spec else {}


@pytest.fixture(scope="module")
def built(data):
    """``{spec: (JAX FactoryIndex, the port's)}``, trained and filled."""
    x, _ = data
    out = {}
    for spec in _SPECS:
        pair = (vq_tpu.index_factory(D, spec), vq_tpu_torch.index_factory(D, spec))
        for f in pair:
            if not f.is_trained:
                f.train(x, max_iters=3)
            if spec.startswith("IDMap"):
                f.add_with_ids(x, np.arange(x.shape[0], dtype=np.int64) + 10**10)
            elif not spec.startswith("HNSW"):  # the graph is built filled
                f.add(x)
        out[spec] = pair
    return out


@pytest.mark.parametrize("spec", _SPECS)
def test_factory_builds_the_same_pipeline(built, spec):
    j, t = built[spec]
    assert _shape(t.index) == _shape(j.index)
    assert t.ntotal == j.ntotal and t.is_trained and t.metric == j.metric
    assert repr(t) == repr(j)


@pytest.mark.parametrize("spec", _SPECS)
def test_factory_search_by_family_tier(data, built, spec):
    x, _ = data
    q = x[::6][:64] + np.random.default_rng(4).normal(0, 0.05, (64, D)).astype(np.float32)
    j, t = built[spec]
    kw = _kw(spec)
    ti, tv = t.search(q, 5, **kw)
    ji, jv = j.search(q, 5, **kw)
    assert tuple(ti.shape) == np.asarray(ji).shape == (q.shape[0], 5)
    if spec in _EXACT:
        kind = "binary_index" if "BFlat" in spec else ("idmap_index" if "IDMap" in spec else "")
        _same_search((ti, tv), (np.asarray(ji), np.asarray(jv)), kind)
        return
    ids = ti.numpy() - (10**10 if spec.startswith("IDMap") else 0)
    jids = np.asarray(ji) - (10**10 if spec.startswith("IDMap") else 0)
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1, kind="stable")[:, :5]

    def rec(i):
        return np.mean([len(set(a) & set(b)) / 5 for a, b in zip(i.tolist(), gt.tolist())])

    assert rec(ids) >= rec(jids) - 0.15


_BAD_SPECS = ["", "PQ8,Flat", "IVF16", "IVF16,BFlat", "Nope", "PQ8x9", "IVF2x,Flat",
              "IVF16,PQ4+x", "HNSW8,RSQ8", "RQ2x9", "LSH16", "IVF8,Flat,Flat", "PQ4,RFlat,RFlat"]


@pytest.mark.parametrize("spec", _BAD_SPECS)
def test_bad_specs_raise_alike(spec):
    with pytest.raises(vq_tpu.errors.InvalidParameter) as je:
        vq_tpu.index_factory(D, spec)
    with pytest.raises(InvalidParameter) as te:
        vq_tpu_torch.index_factory(D, spec)
    assert te.value.parameter == je.value.parameter


@pytest.mark.parametrize("spec,metric", [("IVF8,Flat", "cosine"), ("PQ4", "dot"),
                                         ("HNSW8", "dot"), ("BIVF8", "dot"),
                                         ("IVF8,SQ8", "manhattan")])
def test_metric_rejections_alike(data, spec, metric):
    x, _ = data
    with pytest.raises(vq_tpu.errors.InvalidParameter) as je:
        vq_tpu.index_factory(D, spec, metric=metric).train(x)
    with pytest.raises(InvalidParameter) as te:
        vq_tpu_torch.index_factory(D, spec, metric=metric).train(x)
    assert te.value.parameter == je.value.parameter == "metric"


class TestIndexFactory:
    def test_flat_needs_no_training(self, data):
        x, _ = data
        idx = vq_tpu_torch.index_factory(D, "Flat")
        assert idx.is_trained
        idx.add(x)
        assert int(idx.search(x[3:4], k=1)[0][0, 0]) == 3

    def test_untrained_raises(self, data):
        idx = vq_tpu_torch.index_factory(D, "PQ4")
        assert not idx.is_trained and idx.ntotal == 0
        with pytest.raises(InvalidData, match="untrained"):
            idx.add(data[0])

    def test_train_checks_shape(self, data):
        from vq_tpu_torch.errors import DimensionMismatch

        f = vq_tpu_torch.index_factory(D, "PQ4")
        with pytest.raises(DimensionMismatch):
            f.train(data[0][:, :4])
        with pytest.raises(InvalidParameter):
            f.train(np.zeros((0, D), np.float32))

    def test_metric_aliases(self, data):
        x, _ = data
        for alias, name in (("l2", "squared_euclidean"), ("ip", "dot"),
                            ("inner_product", "dot"), ("IP", "dot")):
            assert vq_tpu_torch.index_factory(D, "Flat", metric=alias).metric == name
        f = vq_tpu_torch.index_factory(D, "Flat", metric="ip")
        f.add(x)
        assert (torch.diff(f.search(x[:2], k=3)[1], dim=1) <= 1e-5).all()

    def test_opq_reuses_codebooks(self, data):
        x, _ = data
        f = vq_tpu_torch.index_factory(D, "OPQ4,PQ4").train(x, max_iters=3)
        rot = f.index.transforms[0]
        from vq_tpu_torch.models.opq import opq_train

        _, cbs = opq_train(x, 4, 256, seed=42)
        assert torch.equal(f.index.base.pq.codebooks, cbs)
        assert rot.d_out == D

    def test_save_via_factory_then_generic_load(self, data, tmp_path):
        x, q = data
        f = vq_tpu_torch.index_factory(D, "PCA4,PQ2x4").train(x, max_iters=3)
        f.add(x[:200])
        back = load_index(f.save(str(tmp_path / "fact.npz")))
        assert torch.equal(f.search(q, k=2)[0], back.search(q, k=2)[0])
        assert type(vq_tpu.load_index(str(tmp_path / "fact.npz"))).__name__ == "TransformedIndex"

    def test_delegation(self, data):
        x, q = data
        f = vq_tpu_torch.index_factory(D, "IVF8,Flat").train(x, max_iters=3)
        f.add(x)
        ids, vals, rec = f.search_and_reconstruct(q, 3, nprobe=8)
        assert tuple(rec.shape) == (q.shape[0], 3, D)
        _, _, counts = f.range_search(q, 1e9, nprobe=8, max_results=500)
        assert (counts == x.shape[0]).all()
        assert f.remove_ids([0, 1]) == 2 and f.ntotal == x.shape[0] - 2
        other = vq_tpu_torch.index_factory(D, "IVF8,Flat")
        other._built = type(f.index)(f.index.coarse)
        other.add(x[:10])
        assert f.merge_from(other) == 10
        fn, arrays = f._search_core(3, nprobe=8)
        assert torch.equal(fn(torch.from_numpy(q), *arrays)[0], f.search(q, 3, nprobe=8)[0])
        with pytest.raises(InvalidData, match="IDMap"):
            f.add_with_ids(x[:2], [1, 2])

    def test_factory_idmap_spec(self, data):
        x, _ = data
        f = vq_tpu_torch.index_factory(D, "IDMap,Flat")
        f.add_with_ids(x[:50], np.arange(50, dtype=np.int64) + 10_000)
        assert int(f.search(x[7:8], k=1)[0][0, 0]) == 10_007


class TestLSH:
    def test_factory_lsh_builds_and_searches(self):
        r = np.random.default_rng(91)
        centers = r.normal(0, 3.0, (8, 48)).astype(np.float32)
        corpus = (centers[r.integers(0, 8, 2000)] + r.normal(0, 0.4, (2000, 48))).astype(np.float32)
        f = vq_tpu_torch.index_factory(48, "LSH48")
        assert f.is_trained
        f.add(corpus)
        ids = f.search(corpus[:16], k=10)[0].numpy()
        assert (ids[:, 0] == np.arange(16)).mean() >= 0.9
        d = np.sum((corpus[None] - corpus[:16, None]) ** 2, -1)
        assert np.mean([(d[i, ids[i]] < 2.0 * np.median(d[i])).mean() for i in range(16)]) > 0.95

    def test_lsh_save_load(self, data, tmp_path):
        x, _ = data
        f = vq_tpu_torch.index_factory(D, "LSH8")
        f.add(x[:200])
        back = load_index(f.index.save(str(tmp_path / "lsh.npz")))
        assert torch.equal(f.search(x[:4], k=3)[0], back.search(x[:4], k=3)[0])


class TestRefineFactory:
    @pytest.mark.parametrize("spec,kw", [("IVF8,PQ4+4", {"nprobe": 8}),
                                         ("IVF8,PQ4,RSQ8", {"nprobe": 8}),
                                         ("IVF8,Flat,RFlat16", {"nprobe": 8}),
                                         ("PQ4,RFlat", {}), ("BFlat,RFlat", {})])
    def test_specs_build_and_beat_chance(self, data, built, spec, kw):
        x, q = data
        f = built[spec][1]
        ids = f.search(q, 5, k_factor=8, **kw)[0].numpy()
        d = ((q[:, None] - x[None]) ** 2).sum(-1)
        gt = np.argsort(d, 1, kind="stable")[:, :5]
        assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids.tolist(), gt.tolist())]) > 0.3

    def test_ivfpqr_dot(self, data):
        x, q = data
        f = vq_tpu_torch.index_factory(D, "IVF8,PQ4+4", metric="dot").train(x, max_iters=3)
        f.add(x)
        d = f.search(q, 5, k_factor=8, nprobe=8)[1]
        assert (torch.diff(d, dim=1) <= 1e-5).all()


class TestBinaryIVFFactory:
    def test_factory_spec_and_generic_load(self, data, built, tmp_path):
        x, q = data
        f = built["BIVF8"][1]
        assert tuple(f.search(x[:3], k=4, nprobe=6)[0].shape) == (3, 4)
        back = load_index(f.save(str(tmp_path / "bivf")))
        assert type(back).__name__ == "IVFBinaryIndex" and back.ntotal == f.ntotal
