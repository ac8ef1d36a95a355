"""``vq_tpu_torch.Kmeans`` against ``vq_tpu.Kmeans`` on the same seeded
numpy inputs (JAX on the CPU, its XLA Lloyd; the port's K1 / K2 plain
versions), mirroring ``tests/test_clustering.py``'s surface.

Tolerances:

* warm-started training (``init_centroids``, no subsample): centroids
  within 1e-5 (absolute and relative), the objective within 1e-7 of
  ``sum ||x||^2`` (each distance carries the fp32 rounding of
  ``||x||^2``), labels of ``assign`` equal (the blobs' distances are far
  apart), distances rtol 1e-5 / atol 1e-5 times the score scale;
* seeded training, whose streams differ by design (torch cannot replay
  threefry; the subsample is ``torch.randperm``): the objective within
  5% of the JAX package's on uniform data, whose local minima lie within
  ~2% of each other;
* checkpoints either way: centroids, ``obj`` and ``all_objs`` exact.

R6: the reference divides the weighted sums by ``max(Σw, 1)``; the port
by ``Σw`` (``test_weighted_light_cluster_R6``).
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from vq_tpu_torch.errors import EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _blobs(n=600, k=4, d=8, seed=0, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3.0
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(size=(n, d)).astype(np.float32) * spread
    return pts.astype(np.float32), centers


class TestConstruction:
    @pytest.mark.parametrize("kw", [dict(d=0, k=4), dict(d=8, k=0), dict(d=8, k=4, nredo=0),
                                    dict(d=8, k=4, niter=-1),
                                    dict(d=8, k=4, max_points_per_centroid=-1)])
    def test_validation_matches_jax(self, kw):
        d, k = kw.pop("d"), kw.pop("k")
        with pytest.raises(vq_tpu.errors.InvalidParameter):
            vq_tpu.Kmeans(d, k, **kw)
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.Kmeans(d, k, **kw)

    def test_repr_state(self):
        km = vq_tpu_torch.Kmeans(8, 4)
        assert repr(km) == repr(vq_tpu.Kmeans(8, 4))
        km.train(_blobs()[0])
        assert "trained" in repr(km) and "untrained" not in repr(km)

    def test_untrained_raises(self):
        km = vq_tpu_torch.Kmeans(8, 4)
        with pytest.raises(InvalidParameter):
            km.assign(np.zeros((3, 8), np.float32))
        with pytest.raises(InvalidParameter):
            _ = km.index

    def test_exported(self):
        assert vq_tpu_torch.Kmeans is vq_tpu_torch.clustering.Kmeans
        assert "Kmeans" in vq_tpu_torch.__all__


class TestTraining:
    def test_recovers_blobs(self):
        data, centers = _blobs()
        km = vq_tpu_torch.Kmeans(8, 4, niter=20, nredo=4, seed=3)
        obj = km.train(data)
        assert tuple(km.centroids.shape) == (4, 8) and obj == km.obj
        assert len(km.all_objs) == 4 and obj == min(km.all_objs)
        c = km.centroids.numpy()
        for t in centers:
            assert np.min(np.sum((c - t) ** 2, axis=1)) < 0.1

    def test_deterministic(self):
        data, _ = _blobs(seed=1)
        a = vq_tpu_torch.Kmeans(8, 4, nredo=2, seed=7)
        b = vq_tpu_torch.Kmeans(8, 4, nredo=2, seed=7)
        assert a.train(data) == b.train(data)
        assert torch.equal(a.centroids, b.centroids)

    def test_nredo_never_worse(self):
        data, _ = _blobs(n=800, k=6, seed=2, spread=0.5)
        one = vq_tpu_torch.Kmeans(8, 6, niter=10, nredo=1, seed=11).train(data)
        many = vq_tpu_torch.Kmeans(8, 6, niter=10, nredo=5, seed=11).train(data)
        assert many <= one  # restart 0 is the same run

    def test_dim_mismatch_and_too_few_rows(self):
        data, _ = _blobs()
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.Kmeans(7, 4).train(data)
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.Kmeans(8, 700).train(data)

    def test_subsampling_caps_training_set(self):
        data, _ = _blobs(n=3000)
        km = vq_tpu_torch.Kmeans(8, 4, niter=5, max_points_per_centroid=50, seed=1)
        km.train(data)
        assert km.result.assignments.shape[0] == 200  # k * max_points_per_centroid
        full = vq_tpu_torch.Kmeans(8, 4, niter=5, max_points_per_centroid=0, seed=1)
        full.train(data)
        assert full.result.assignments.shape[0] == 3000

    def test_spherical_unit_norm(self):
        data, _ = _blobs(seed=4)
        km = vq_tpu_torch.Kmeans(8, 4, spherical=True, seed=2)
        km.train(data / np.linalg.norm(data, axis=1, keepdims=True))
        np.testing.assert_allclose(torch.linalg.vector_norm(km.centroids, dim=1).numpy(), 1.0,
                                   atol=1e-5)

    @pytest.mark.parametrize("spherical", [False, True], ids=["l2", "spherical"])
    def test_warm_start_matches_jax(self, spherical):
        data, centers = _blobs(seed=22, spread=0.4)
        init = centers + np.random.default_rng(5).normal(0, 0.3, centers.shape).astype(np.float32)
        if spherical:
            data = data / np.linalg.norm(data, axis=1, keepdims=True)
            init = init / np.linalg.norm(init, axis=1, keepdims=True)
        kw = dict(niter=8, nredo=3, seed=1, spherical=spherical, max_points_per_centroid=0)
        jk, tk = vq_tpu.Kmeans(8, 4, **kw), vq_tpu_torch.Kmeans(8, 4, **kw)
        want, got = jk.train(data, init_centroids=init), tk.train(data, init_centroids=init)
        assert len(tk.all_objs) == len(jk.all_objs) == 1  # a warm start skips the restarts
        np.testing.assert_allclose(tk.centroids.numpy(), np.asarray(jk.centroids),
                                   rtol=1e-5, atol=1e-5)
        assert got == pytest.approx(want, rel=0, abs=1e-7 * float((data * data).sum()))
        (jd, jl), (td, tl) = jk.assign(data), tk.assign(data)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        scale = (data * data).sum(1) + (np.asarray(jk.centroids) ** 2).sum(1).max()
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5 * scale.max())

    def test_weighted_warm_start_matches_jax(self):
        data, centers = _blobs(seed=24, spread=0.4)
        w = np.random.default_rng(6).uniform(0.5, 2.0, data.shape[0]).astype(np.float32)
        kw = dict(niter=6, seed=1, max_points_per_centroid=0)
        jk, tk = vq_tpu.Kmeans(8, 4, **kw), vq_tpu_torch.Kmeans(8, 4, **kw)
        want = jk.train(data, init_centroids=centers, weights=w)
        got = tk.train(data, init_centroids=centers, weights=w)
        sums = np.bincount(np.asarray(jk.result.assignments), weights=w, minlength=4)
        assert (sums >= 1).all(), sums  # no light cluster: R6's divisors agree
        np.testing.assert_allclose(tk.centroids.numpy(), np.asarray(jk.centroids),
                                   rtol=1e-5, atol=1e-5)
        assert got == pytest.approx(want, rel=1e-5)

    @pytest.mark.parametrize("init", ["sample", "kmeans++"])
    def test_seeded_objective_matches_jax(self, init):
        x = np.random.default_rng(42).random((3000, 8), dtype=np.float32)
        kw = dict(niter=15, nredo=2, seed=3, init=init, max_points_per_centroid=100)
        want = vq_tpu.Kmeans(8, 16, **kw).train(x)  # both subsample to 1600 rows
        got = vq_tpu_torch.Kmeans(8, 16, **kw).train(x)
        assert abs(got - want) <= 0.05 * want

    def test_weighted_light_cluster_R6(self):
        """R6 through the harness: rows 1..10 at weight 0.05 (Σw = 0.5)
        give the reference's clamped 2.75, the port's weighted mean 5.5."""
        x = np.arange(1, 11, dtype=np.float32)[:, None]
        w = np.full(10, 0.05, np.float32)
        init = np.zeros((1, 1), np.float32)
        jk, tk = vq_tpu.Kmeans(1, 1, niter=5), vq_tpu_torch.Kmeans(1, 1, niter=5)
        jk.train(x, init_centroids=init, weights=w)
        tk.train(x, init_centroids=init, weights=w)
        assert float(np.asarray(jk.centroids)[0, 0]) == pytest.approx(2.75, rel=1e-6)
        assert float(tk.centroids[0, 0]) == pytest.approx(5.5, rel=1e-6)


class TestAssign:
    def test_assign_matches_bruteforce(self):
        data, _ = _blobs(seed=5)
        km = vq_tpu_torch.Kmeans(8, 4, seed=1)
        km.train(data)
        d, lab = km.assign(data)
        c = km.centroids.numpy()
        d2 = ((data[:, None, :] - c[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(lab.numpy(), d2.argmin(1))
        np.testing.assert_allclose(d.numpy(), d2.min(1), rtol=1e-4, atol=1e-3)

    def test_index_surface(self):
        data, _ = _blobs(seed=6)
        km = vq_tpu_torch.Kmeans(8, 4, seed=1)
        km.train(data)
        ids, dist = km.index.search(data[:20], 1)
        np.testing.assert_array_equal(ids[:, 0].numpy(), km.assign(data[:20])[1].numpy())
        assert isinstance(km.index, vq_tpu_torch.FlatIndex) and km.index.ntotal == 4

    def test_assign_bad_shape(self):
        data, _ = _blobs()
        km = vq_tpu_torch.Kmeans(8, 4)
        km.train(data)
        with pytest.raises(InvalidParameter):
            km.assign(np.zeros((3, 7), np.float32))
        with pytest.raises(InvalidParameter):
            km.assign(np.zeros(8, np.float32))
        with pytest.raises(EmptyInput):
            km.assign(np.zeros((0, 8), np.float32))


class TestPersistence:
    def test_jax_checkpoint_loads_in_the_port(self, tmp_path):
        data, _ = _blobs(seed=23)
        jk = vq_tpu.Kmeans(8, 4, niter=8, nredo=2, seed=3, spherical=True)
        jk.train(data)
        tk = vq_tpu_torch.Kmeans.load(jk.save(str(tmp_path / "j")))
        np.testing.assert_array_equal(tk.centroids.numpy(), np.asarray(jk.centroids))
        assert tk.obj == jk.obj and tk.all_objs == jk.all_objs
        assert tk.spherical and tk.nredo == 2 and tk.seed == 3
        np.testing.assert_array_equal(tk.assign(data)[1].numpy(), np.asarray(jk.assign(data)[1]))

    def test_port_checkpoint_loads_in_jax(self, tmp_path):
        data, _ = _blobs(seed=25)
        tk = vq_tpu_torch.Kmeans(8, 4, niter=8, nredo=2, seed=3)
        tk.train(data)
        back = vq_tpu.Kmeans.load(tk.save(str(tmp_path / "t")))
        np.testing.assert_array_equal(np.asarray(back.centroids), tk.centroids.numpy())
        assert back.obj == tk.obj and back.all_objs == tk.all_objs
        again = vq_tpu_torch.Kmeans.load(str(tmp_path / "t"))
        assert torch.equal(again.centroids, tk.centroids)

    def test_untrained_round_trip(self, tmp_path):
        km = vq_tpu.Kmeans(8, 4)
        back = vq_tpu_torch.Kmeans.load(km.save(str(tmp_path / "km0")))
        assert back.centroids is None and "untrained" in repr(back)

    def test_wrong_kind_rejected(self, tmp_path):
        idx = vq_tpu_torch.FlatIndex.from_data(np.zeros((4, 8), np.float32))
        with pytest.raises(InvalidData):
            vq_tpu_torch.Kmeans.load(idx.save(str(tmp_path / "flat")))


class TestWeights:
    def test_weighted_train_biases_centroids(self):
        r = np.random.default_rng(31)
        a = r.normal(0, 0.2, (300, 8)).astype(np.float32)
        b = (r.normal(0, 0.2, (300, 8)) + 5.0).astype(np.float32)
        w = np.concatenate([np.full(300, 100.0), np.ones(300)]).astype(np.float32)
        km = vq_tpu_torch.Kmeans(8, 1, niter=10, seed=0)
        km.train(np.concatenate([a, b]), weights=w)
        c = km.centroids.numpy()[0]
        assert np.linalg.norm(c - a.mean(0)) < np.linalg.norm(c - b.mean(0))

    def test_weights_follow_subsample(self):
        r = np.random.default_rng(32)
        x = r.normal(size=(4000, 4)).astype(np.float32)
        w = r.uniform(0.1, 2.0, 4000).astype(np.float32)
        km = vq_tpu_torch.Kmeans(4, 4, niter=3, seed=1, max_points_per_centroid=64)
        assert np.isfinite(km.train(x, weights=w))
        assert km.result.assignments.shape[0] == 256

    def test_bad_weight_length(self):
        x = np.random.default_rng(33).normal(size=(100, 4)).astype(np.float32)
        with pytest.raises(InvalidParameter):
            vq_tpu_torch.Kmeans(4, 4, niter=2).train(x, weights=np.ones(5, np.float32))
