"""``vq_tpu_torch.transforms`` (PCA, rotations, ITQ, normalization,
centering and ``TransformedIndex``) against ``vq_tpu.transforms`` on the
same seeded numpy inputs (JAX on the CPU), mirroring
``tests/test_transforms.py`` without its factory and LSH classes, which
need ``index_factory``.

Tolerances:

* PCA fitted by each package on data with a well-gapped spectrum
  (component variances 16, 12, 9, ... over a 1e-4 noise floor): mean
  within 1e-5, eigenvalues rtol 1e-4 of the largest, components column
  by column within 1e-4 up to sign (``eigh`` fixes no sign, and LAPACK
  and XLA choose differently; neither package adds a convention);
* ``apply`` / ``reverse`` from the JAX package's fitted state carried
  across (``from_state``): within 1e-5 absolute plus 1e-5 relative (two
  fp32 products in their own summation orders);
* seeded rotations (QR of a Gaussian from a ``torch.Generator``, not
  threefry): orthonormality within 1e-5; equal to the JAX package's only
  through a carried matrix;
* ITQ from the JAX package's own PCA projection and start rotation: the
  rotation within 1e-4 elementwise after 50 alternations (a sign code of
  a value within rounding of zero could move one iteration; none does on
  these rows), the binarization error within 1e-5 relative; seeded ITQ
  runs (different start rotations) on binarization error within 2%;
* ``TransformedIndex`` searches from carried checkpoints: ids equal,
  values rtol 1e-5 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.transforms as jtr
import vq_tpu_torch
import vq_tpu_torch.transforms as ttr
from vq_tpu_torch import (
    CenteringTransform,
    FlatIndex,
    NormalizeTransform,
    PCATransform,
    RotationTransform,
    TransformedIndex,
    itq_train,
    load_index,
)
from vq_tpu_torch.convert import from_state, state_of
from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    """Low-rank rows plus noise, the JAX tests' shape (2000 x 32, rank 8)."""
    rng = np.random.default_rng(66)
    basis = rng.standard_normal((8, 32)).astype(np.float32)
    coef = rng.standard_normal((2000, 8)).astype(np.float32)
    return coef @ basis + 0.05 * rng.standard_normal((2000, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def gapped():
    """Rows whose covariance has a known, well-gapped spectrum along a
    random orthonormal basis: variances 16 * 0.75^j for j < 12 (gaps
    above 0.7), then a 1e-4 floor."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    sd = np.sqrt(np.concatenate([16 * 0.75 ** np.arange(12), np.full(12, 1e-4)]))
    z = rng.standard_normal((4000, 24)) * sd
    z -= z.mean(0)
    z = z / z.std(0) * sd  # the sample variances are the design's
    return (z @ q.T + 3.0).astype(np.float32)


@pytest.fixture(scope="module")
def correlated():
    """The JAX ITQ tests' correlated rows and queries (d = 32)."""
    r = np.random.default_rng(41)
    a = r.normal(size=(32, 32)) * (0.9 ** np.arange(32))[None, :]
    x = (r.normal(size=(3000, 32)) @ a.T).astype(np.float32)
    q = (r.normal(size=(24, 32)) @ a.T).astype(np.float32)
    return x, q


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _carry(jt):
    """The port's transform built from a JAX transform's fitted state."""
    return from_state(*jt._state())


def _bin_error(v, r):
    z = v @ r
    return float(((np.where(z >= 0, 1.0, -1.0) - z) ** 2).sum())


# ---------------------------------------------------------------------------
# PCA.
# ---------------------------------------------------------------------------


class TestPCATransform:
    @pytest.mark.parametrize("d_out", [6, 12])
    def test_fit_matches_jax_up_to_sign(self, gapped, d_out):
        jt = jtr.PCATransform(24, d_out).fit(gapped)
        tt = PCATransform(24, d_out).fit(gapped)
        np.testing.assert_allclose(tt._mean.numpy(), np.asarray(jt._mean), **_TOL)
        jw = np.asarray(jt.explained_variance)
        np.testing.assert_allclose(tt.explained_variance.numpy(), jw, rtol=0, atol=1e-4 * jw[0])
        jc, tc = np.asarray(jt._components), tt._components.numpy()
        for j in range(d_out):
            sign = 1.0 if jc[:, j] @ tc[:, j] >= 0 else -1.0
            np.testing.assert_allclose(sign * tc[:, j], jc[:, j], rtol=0, atol=1e-4)

    @pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whiten"])
    def test_apply_reverse_from_carried_state(self, data, whiten):
        jt = jtr.PCATransform(32, 8, whiten=whiten).fit(data)
        tt = _carry(jt)
        assert isinstance(tt, PCATransform) and tt.whiten == whiten
        y = tt.apply(data[:200])
        np.testing.assert_allclose(y.numpy(), np.asarray(jt.apply(data[:200])), **_TOL)
        np.testing.assert_allclose(tt.reverse(y).numpy(), np.asarray(jt.reverse(y.numpy())),
                                   rtol=1e-5, atol=1e-4)

    def test_projection_recovers_structure(self, data):
        t = PCATransform(32, 8).fit(data)
        y = t.apply(data)
        assert tuple(y.shape) == (2000, 8)
        back = t.reverse(y).numpy()
        assert np.linalg.norm(back - data) / np.linalg.norm(data) < 0.05

    def test_whiten_unit_variance(self, data):
        y = PCATransform(32, 8, whiten=True).fit(data).apply(data).numpy()
        np.testing.assert_allclose(y.var(axis=0), 1.0, rtol=0.05)

    def test_full_rank_roundtrip_exact(self, data):
        t = PCATransform(32).fit(data)
        np.testing.assert_allclose(t.reverse(t.apply(data[:50])).numpy(), data[:50], atol=1e-3)

    def test_explained_variance_descending(self, data):
        ev = PCATransform(32, 16).fit(data).explained_variance.numpy()
        assert (np.diff(ev) <= 1e-5).all() and (ev >= 0).all()

    def test_unfitted_raises(self, data):
        t = PCATransform(32, 8)
        assert not t.is_fitted
        with pytest.raises(InvalidData):
            t.apply(data)
        with pytest.raises(InvalidData):
            _ = t.explained_variance

    def test_validation(self, data):
        with pytest.raises(InvalidParameter):
            PCATransform(32, 0)
        with pytest.raises(InvalidParameter):
            PCATransform(32, 33)
        with pytest.raises(InvalidData):
            PCATransform(32).fit(data[:1])
        with pytest.raises(DimensionMismatch):
            PCATransform(16).fit(data)


# ---------------------------------------------------------------------------
# Rotations, normalization, centering.
# ---------------------------------------------------------------------------


class TestRotationTransform:
    def test_orthonormal_and_invertible(self, data):
        t = RotationTransform.random(32, seed=3)
        r = t.matrix.numpy()
        np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)
        np.testing.assert_allclose(t.reverse(t.apply(data[:20])).numpy(), data[:20], atol=1e-4)

    def test_deterministic_by_seed(self):
        a = RotationTransform.random(16, seed=7).matrix
        assert torch.equal(a, RotationTransform.random(16, seed=7).matrix)
        assert not torch.allclose(a, RotationTransform.random(16, seed=8).matrix)

    def test_projection_orthonormal_columns(self):
        m = RotationTransform.random(48, seed=3, d_out=16).matrix.numpy()
        assert m.shape == (48, 16)
        np.testing.assert_allclose(m.T @ m, np.eye(16), atol=1e-5)
        with pytest.raises(InvalidParameter):
            RotationTransform.random(16, d_out=17)

    def test_preserves_distances(self, data):
        x = data[:10]
        y = RotationTransform.random(32, seed=1).apply(x).numpy()
        dx = ((x[:, None] - x[None, :]) ** 2).sum(-1)
        dy = ((y[:, None] - y[None, :]) ** 2).sum(-1)
        np.testing.assert_allclose(dx, dy, rtol=1e-3, atol=1e-3)

    def test_carried_matrix_matches_jax(self, data):
        jt = jtr.RotationTransform.random(32, seed=9, d_out=20)
        tt = _carry(jt)
        np.testing.assert_array_equal(tt.matrix.numpy(), np.asarray(jt.matrix))
        y = tt.apply(data[:64])
        np.testing.assert_allclose(y.numpy(), np.asarray(jt.apply(data[:64])), **_TOL)
        np.testing.assert_allclose(tt.reverse(y).numpy(), np.asarray(jt.reverse(y.numpy())), **_TOL)

    def test_not_2d_rejected(self):
        with pytest.raises(InvalidParameter):
            RotationTransform(np.zeros(4, np.float32))


class TestSimpleTransforms:
    def test_normalize_matches_jax(self, data):
        x = np.concatenate([data[:100], np.zeros((1, 32), np.float32),
                            np.full((1, 32), 1e-12, np.float32)])
        y = NormalizeTransform(32).apply(x)
        np.testing.assert_allclose(y.numpy(), np.asarray(jtr.NormalizeTransform(32).apply(x)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.linalg.norm(y.numpy()[:100], axis=1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(y.numpy()[100:], x[100:])  # below the norm guard
        with pytest.raises(InvalidData):
            NormalizeTransform(32).reverse(y)

    def test_centering_matches_jax(self, data):
        jt = jtr.CenteringTransform(32).fit(data)
        tt = CenteringTransform(32).fit(data)
        np.testing.assert_allclose(tt._mean.numpy(), np.asarray(jt._mean), **_TOL)
        y = tt.apply(data[:50])
        np.testing.assert_allclose(y.numpy(), np.asarray(jt.apply(data[:50])), **_TOL)
        np.testing.assert_allclose(tt.reverse(y).numpy(), data[:50], atol=1e-5)
        carried = _carry(jt)
        np.testing.assert_array_equal(carried._mean.numpy(), np.asarray(jt._mean))

    def test_centering_contract(self):
        t = CenteringTransform(4)
        with pytest.raises(InvalidData):
            t.apply(np.zeros((1, 4), np.float32))
        with pytest.raises(EmptyInput):
            t.fit(np.zeros((0, 4), np.float32))
        with pytest.raises(DimensionMismatch):
            CenteringTransform(4, mean=np.zeros(3, np.float32))
        with pytest.raises(InvalidParameter):
            t.fit(np.zeros((2, 2, 4), np.float32))

    @pytest.mark.parametrize("kind", ["center", "l2norm", "rotation", "pca"])
    def test_state_round_trips_both_ways(self, data, kind):
        jt = {"center": lambda: jtr.CenteringTransform(32).fit(data),
              "l2norm": lambda: jtr.NormalizeTransform(32),
              "rotation": lambda: jtr.RotationTransform.random(32, seed=4),
              "pca": lambda: jtr.PCATransform(32, 8, whiten=True).fit(data)}[kind]()
        jk, jc, ja = jt._state()
        tk, tc, ta = state_of(from_state(jk, jc, ja))
        assert (tk, tc) == (jk, jc) and set(ta) == set(ja)
        for name in ja:
            np.testing.assert_array_equal(ta[name], np.asarray(ja[name]))
        back = jtr.VectorTransform._from_state(tk, tc, ta)
        np.testing.assert_array_equal(np.asarray(back.apply(data[:4])), np.asarray(jt.apply(data[:4])))

    def test_unknown_kind_rejected(self):
        with pytest.raises(InvalidData):
            ttr.VectorTransform._from_state("spin", {}, {})


# ---------------------------------------------------------------------------
# ITQ.
# ---------------------------------------------------------------------------


class TestITQ:
    def test_rotation_from_the_jax_start_matches(self, correlated):
        """The alternation alone, from the JAX package's PCA projection and
        start rotation: the same 50 sign / Procrustes steps."""
        x, _ = correlated
        pca = jtr.PCATransform(32, 16).fit(x)
        v = np.array(pca.apply(x))  # writable copies for torch.from_numpy
        r0 = np.array(jtr.RotationTransform.random(16, seed=1).matrix)
        want = np.asarray(jtr._itq_rotation_jit(v, r0, 50))
        got = ttr._itq_rotation(torch.from_numpy(v), torch.from_numpy(r0), 50).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert _bin_error(v, got) == pytest.approx(_bin_error(v, want), rel=1e-5)

    def test_seeded_binarization_error_matches_jax(self, correlated):
        x, _ = correlated
        jchain = jtr.itq_train(x, 16, seed=1)
        tchain = itq_train(x, 16, seed=1)
        jv, tv = np.asarray(jchain[0].apply(x)), tchain[0].apply(x).numpy()
        want = _bin_error(jv, np.asarray(jchain[1].matrix))
        got = _bin_error(tv, tchain[1].matrix.numpy())
        r0 = RotationTransform.random(16, seed=1).matrix.numpy()
        assert got < _bin_error(tv, r0)  # ITQ lowers the start's error
        assert got == pytest.approx(want, rel=0.02)

    def test_rotation_is_orthogonal(self, correlated):
        chain = itq_train(correlated[0], 16, seed=1)
        assert len(chain) == 2 and isinstance(chain[0], PCATransform)
        r = chain[1].matrix.numpy()
        np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-4)

    def test_beats_random_rotation_on_hamming(self, correlated):
        x, q = correlated
        gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), axis=1)[:, :10]

        def recall(ids):
            ids = _np(ids)
            return np.mean([len(set(ids[i]) & set(gt[i])) / 10 for i in range(len(q))])

        def mean_recall(chain_of_seed):
            out = []
            for seed in range(6):  # 24 queries over 16-bit codes: one seed is noise
                idx = TransformedIndex(chain_of_seed(seed), vq_tpu_torch.BinaryIndex(16))
                idx.add(x)
                out.append(recall(idx.search(q, 10)[0]))
            return np.mean(out)

        rnd = mean_recall(lambda s: [RotationTransform.random(32, seed=s, d_out=16)])
        assert mean_recall(lambda s: itq_train(x, 16, seed=s)) > rnd

    def test_round_trip_through_load_index(self, correlated, tmp_path):
        x, q = correlated
        idx = TransformedIndex(itq_train(x, 16), vq_tpu_torch.BinaryIndex(16))
        idx.add(x)
        back = load_index(idx.save(str(tmp_path / "itq")))
        assert torch.equal(back.search(q, 5)[0], idx.search(q, 5)[0])
        jback = vq_tpu.load_index(str(tmp_path / "itq.npz"))
        np.testing.assert_array_equal(np.asarray(jback.search(q, 5)[0]), idx.search(q, 5)[0].numpy())

    def test_bad_params(self, correlated):
        x, _ = correlated
        with pytest.raises(InvalidParameter):
            itq_train(x, 0)
        with pytest.raises(InvalidParameter):
            itq_train(x, 16, iters=0)
        with pytest.raises(InvalidParameter):
            itq_train(x[0], 4)


# ---------------------------------------------------------------------------
# TransformedIndex.
# ---------------------------------------------------------------------------


def _jax_pca_flat(data, n=300, metric="squared_euclidean"):
    t = jtr.PCATransform(32, 8).fit(data)
    idx = jtr.TransformedIndex([t], vq_tpu.FlatIndex(8, metric=metric))
    idx.add(data[:n])
    return idx


class TestTransformedIndex:
    def test_pca_flat_search_matches_projected(self, data):
        idx = TransformedIndex([PCATransform(32, 16).fit(data)], FlatIndex(16))
        idx.add(data)
        assert idx.ntotal == 2000 and idx.dim == 32
        ids, _ = idx.search(data[10:13], k=1)
        np.testing.assert_array_equal(ids[:, 0].numpy(), [10, 11, 12])

    @pytest.mark.parametrize("metric", ["squared_euclidean", "dot"])
    def test_jax_checkpoint_searches_alike(self, data, tmp_path, metric):
        jidx = _jax_pca_flat(data, metric=metric)
        tidx = TransformedIndex.load(jidx.save(str(tmp_path / "j")))
        assert isinstance(tidx.base, FlatIndex) and tidx.base.metric == metric
        q = data[1000:1016]
        (ti, tv), (ji, jv) = tidx.search(q, k=5), jidx.search(q, k=5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)

    def test_port_checkpoint_loads_in_jax(self, data, tmp_path):
        t = PCATransform(32, 8, whiten=True).fit(data)
        idx = TransformedIndex([CenteringTransform(32).fit(data), t], FlatIndex(8))
        idx.add(data[:300])
        p = idx.save(str(tmp_path / "t"))
        assert p.endswith("t.npz") and (tmp_path / "t.base.npz").exists()
        jidx = vq_tpu.load_index(p)
        assert [type(s).__name__ for s in jidx.transforms] == ["CenteringTransform", "PCATransform"]
        q = data[1500:1510]
        np.testing.assert_array_equal(np.asarray(jidx.search(q, k=4)[0]), idx.search(q, k=4)[0].numpy())

    def test_fit_transforms_matches_jax(self, data):
        jidx = jtr.TransformedIndex([jtr.CenteringTransform(32), jtr.NormalizeTransform(32)],
                                    vq_tpu.FlatIndex(32))
        tidx = TransformedIndex([CenteringTransform(32), NormalizeTransform(32)], FlatIndex(32))
        jidx.fit_transforms(data)
        tidx.fit_transforms(data)
        np.testing.assert_allclose(tidx.transforms[0]._mean.numpy(),
                                   np.asarray(jidx.transforms[0]._mean), **_TOL)

    def test_search_core_equals_search(self, data):
        idx = TransformedIndex([PCATransform(32, 8).fit(data)], FlatIndex(8))
        idx.add(data[:500])
        fn, arrays = idx._search_core(5)
        q = data[600:610]
        got, want = fn(torch.from_numpy(q), *arrays), idx.search(q, 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def test_reconstruct_reverses_chain(self, data):
        idx = TransformedIndex([RotationTransform.random(32, seed=5)], FlatIndex(32))
        idx.add(data[:100])
        np.testing.assert_allclose(idx.reconstruct([7]).numpy()[0], data[7], atol=1e-4)

    def test_search_and_reconstruct_in_input_space(self, data):
        idx = TransformedIndex([RotationTransform.random(32, seed=6)], FlatIndex(32))
        idx.add(data[:100])
        ids, vals, rec = idx.search_and_reconstruct(data[:3], k=2)
        assert tuple(rec.shape) == (3, 2, 32)
        np.testing.assert_allclose(rec.numpy()[:, 0], data[ids[:, 0].numpy()], atol=1e-4)
        norm = TransformedIndex([NormalizeTransform(32)], FlatIndex(32))
        norm.add(data[:10])
        with pytest.raises(InvalidData):
            norm.search_and_reconstruct(data[:2], k=2)

    def test_range_search_and_remove(self, data, tmp_path):
        jidx = _jax_pca_flat(data, n=200)
        tidx = TransformedIndex.load(jidx.save(str(tmp_path / "r")))
        radius = float(np.median(np.asarray(jidx.search(data[:4], k=10)[1])[:, -1]))
        (ti, tv, tc), (ji, jv, jc) = (tidx.range_search(data[:4], radius, max_results=50),
                                      jidx.range_search(data[:4], radius, max_results=50))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tidx.remove_ids([0, 5]) == jidx.remove_ids(np.array([0, 5])) == 2
        assert tidx.ntotal == jidx.ntotal == 198

    def test_merge_from(self, data):
        t = PCATransform(32, 8).fit(data)
        a, b = (TransformedIndex([from_state(*state_of(t))], FlatIndex(8)) for _ in range(2))
        a.add(data[:100])
        b.add(data[100:150])
        assert a.merge_from(b) == 50 and a.ntotal == 150 and b.ntotal == 0
        other = TransformedIndex([PCATransform(32, 8).fit(data[:500])], FlatIndex(8))
        other.add(data[:10])
        with pytest.raises(InvalidData):
            a.merge_from(other)
        with pytest.raises(InvalidParameter):
            a.merge_from(FlatIndex(8))

    def test_chain_dim_check(self):
        with pytest.raises(DimensionMismatch):
            TransformedIndex([PCATransform(32, 8), NormalizeTransform(16)], FlatIndex(16))
        with pytest.raises(DimensionMismatch):
            TransformedIndex([PCATransform(32, 8)], FlatIndex(9))
        with pytest.raises(InvalidParameter):
            TransformedIndex([], FlatIndex(9))

    def test_generic_load_index(self, data, tmp_path):
        idx = TransformedIndex([NormalizeTransform(32)], FlatIndex(32, metric="dot"))
        idx.add(data[:100])
        back = load_index(idx.save(str(tmp_path / "gen.npz")))
        assert isinstance(back, TransformedIndex) and back.base.metric == "dot"
        assert repr(back).startswith("TransformedIndex(NormalizeTransform -> FlatIndex(")

