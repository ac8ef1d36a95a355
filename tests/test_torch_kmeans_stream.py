"""``vq_tpu_torch.ops.kmeans_stream`` against ``vq_tpu.ops.kmeans_stream``
(JAX on the CPU), mirroring ``tests/test_kmeans_stream.py``; the port runs
K1's, K2's and K3's plain versions here.

Tolerances and splits:

* ``kmeans_plusplus_init``: bit-identical (both numpy, one generator);
* ``minibatch_update`` / ``pq_minibatch_update``: the JAX package assigns
  by ``jnp.argmin`` and sums by a one-hot product at HIGHEST precision,
  the port by K2's / K3's ``int2`` argmin and segmented sums. Counts
  (the batch's codes, summed) equal; centroids within rtol / atol 1e-5;
  inertia within rtol 1e-5. The data's nearest centroids are far apart,
  so no code sits at a float near tie. R1: a NaN centroid wins the JAX
  argmin and never the port's (``test_minibatch_update_nan_centroid_R1``);
* ``lloyd_minibatch`` from the same init and the same shuffle (one numpy
  generator in both): centroids within 1e-4, the same step count, and
  the final inertia within 1e-7 of ``sum ||x||^2`` (each row's distance
  carries the fp32 rounding of ``||x||^2``) for an array, within rtol
  1e-5 for a stream's last batch;
* the errors: the same parameter names.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vq_tpu.errors import EmptyInput as JaxEmpty
from vq_tpu.errors import InvalidParameter as JaxInvalid
from vq_tpu.ops import kmeans_stream as J
from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import kmeans_stream as T
from vq_tpu_torch.ops.kmeans import lloyd
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(1234)
    centers = rng.random((4, 8)).astype(np.float32) * 20
    data = np.concatenate([c + rng.normal(0, 0.3, (500, 8)).astype(np.float32) for c in centers])
    np.random.default_rng(0).shuffle(data)
    return data.astype(np.float32), centers


@pytest.mark.parametrize("as_tensor", [False, True])
def test_kmeans_plusplus_init_bit_identical(blobs, as_tensor):
    data, _ = blobs
    src = torch.from_numpy(data) if as_tensor else data
    for sample in (100_000, 700):  # whole data, then a subsample
        a = J.kmeans_plusplus_init(data, 9, np.random.default_rng(3), sample=sample)
        b = T.kmeans_plusplus_init(src, 9, np.random.default_rng(3), sample=sample)
        np.testing.assert_array_equal(a, b)


def _near(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_minibatch_update_matches_jax(blobs):
    data, _ = blobs
    init = data[:4] + 0.5
    counts = np.array([0.0, 3.0, 10.0, 1.0], np.float32)
    jc, jn, ji = J.minibatch_update(jnp.asarray(init), jnp.asarray(counts),
                                    jnp.asarray(data[:300]), 4)
    tc, tn, ti = T.minibatch_update(init, counts, data[:300], 4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _near(tc.numpy(), jc)
    _near(float(ti), float(ji), atol=0)


def test_minibatch_update_leaves_untouched_centres(blobs):
    data, _ = blobs
    init = np.concatenate([data[:3], np.full((1, 8), 1e4, np.float32)])
    tc, tn, _ = T.minibatch_update(init, np.zeros(4, np.float32), data[:64])
    assert float(tn[3]) == 0.0 and torch.equal(tc[3], torch.from_numpy(init[3]))


def test_minibatch_update_nan_centroid_R1():
    x = np.array([[0.0], [0.2], [5.0]], np.float32)
    init = np.array([[np.nan], [0.0], [5.0]], np.float32)
    _, jn, _ = J.minibatch_update(jnp.asarray(init), jnp.zeros(3), jnp.asarray(x), 3)
    _, tn, _ = T.minibatch_update(init, np.zeros(3, np.float32), x)
    assert np.asarray(jn).tolist() == [3.0, 0.0, 0.0]  # every row to the NaN centre
    assert tn.tolist() == [0.0, 2.0, 1.0]


def test_pq_minibatch_update_matches_jax():
    r = np.random.default_rng(5)
    m, k, s, b = 4, 8, 6, 64
    cents = r.random((m, k, s), dtype=np.float32)
    counts = r.integers(0, 50, (m, k)).astype(np.float32)
    batch = r.random((b, m * s), dtype=np.float32)
    jc, jn, ji = J.pq_minibatch_update(jnp.asarray(cents), jnp.asarray(counts),
                                       jnp.asarray(batch))
    tc, tn, ti = T.pq_minibatch_update(cents, counts, batch)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _near(tc.numpy(), jc)
    assert tuple(ti.shape) == (m,)
    _near(ti.numpy(), ji, atol=0)


def test_pq_minibatch_update_is_minibatch_update_per_subspace():
    r = np.random.default_rng(6)
    m, k, s, b = 3, 5, 4, 40
    cents = r.random((m, k, s), dtype=np.float32)
    counts = r.integers(0, 9, (m, k)).astype(np.float32)
    batch = r.random((b, m * s), dtype=np.float32)
    nc, nct, inertia = T.pq_minibatch_update(cents, counts, batch)
    xb = batch.reshape(b, m, s)
    for i in range(m):
        ci, cti, ii = T.minibatch_update(cents[i], counts[i], np.ascontiguousarray(xb[:, i]))
        _near(nc[i].numpy(), ci.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(nct[i].numpy(), cti.numpy())
        _near(float(inertia[i]), float(ii), atol=0)


def test_pq_minibatch_update_shape_validation():
    with pytest.raises(JaxInvalid, match="batch"):
        J.pq_minibatch_update(jnp.zeros((2, 4, 3)), jnp.zeros((2, 4)), jnp.zeros((8, 5)))
    with pytest.raises(InvalidParameter, match="batch"):
        T.pq_minibatch_update(np.zeros((2, 4, 3), np.float32), np.zeros((2, 4), np.float32),
                              np.zeros((8, 5), np.float32))


@pytest.mark.parametrize("shuffle", [True, False])
def test_lloyd_minibatch_matches_jax(blobs, shuffle):
    data, _ = blobs
    j = J.lloyd_minibatch(data, 4, batch_size=256, epochs=2, seed=1, shuffle=shuffle)
    t = T.lloyd_minibatch(data, 4, batch_size=256, epochs=2, seed=1, shuffle=shuffle)
    _near(t.centroids.numpy(), j.centroids, atol=1e-4)
    _near(float(t.inertia), float(j.inertia), atol=1e-7 * float((data.astype(np.float64) ** 2).sum()))
    assert int(t.iterations) == int(j.iterations) == 2 * (2000 // 256 + 1)
    np.testing.assert_array_equal(t.assignments.numpy(), np.asarray(j.assignments))


def test_lloyd_minibatch_tensor_batches_stay_on_the_device(blobs):
    data, _ = blobs
    a = T.lloyd_minibatch(data, 4, batch_size=300, seed=2)
    b = T.lloyd_minibatch(torch.from_numpy(data), 4, batch_size=300, seed=2)
    assert torch.equal(a.centroids, b.centroids) and b.centroids.device.type == "cpu"


def test_minibatch_near_full_lloyd(blobs):
    data, _ = blobs
    mb = T.lloyd_minibatch(data, 4, batch_size=256, epochs=4, seed=1)
    full = lloyd(data, 4, max_iters=20, seed=1)
    assert float(mb.inertia) < 1.1 * float(full.inertia)


def test_minibatch_recovers_blob_centers(blobs):
    data, centers = blobs
    got = T.lloyd_minibatch(data, 4, batch_size=512, epochs=5, seed=0).centroids.numpy()
    for c in centers:
        assert np.min(np.linalg.norm(got - c, axis=1)) < 1.0


def test_streamed_batches_match_jax(blobs):
    data, _ = blobs

    def gen():
        for lo in range(0, len(data), 400):
            yield data[lo:lo + 400]

    j = J.lloyd_minibatch(gen(), 4, init=data[:4])
    t = T.lloyd_minibatch(gen(), 4, init=data[:4])
    assert int(t.iterations) == int(j.iterations) == 5
    assert tuple(t.assignments.shape) == (0,)
    _near(t.centroids.numpy(), j.centroids, atol=1e-4)
    _near(float(t.inertia), float(j.inertia), atol=0)


@pytest.mark.parametrize("case", ["no_init", "two_epochs", "no_batches", "k0", "k_gt_n",
                                  "init_count", "empty"])
def test_errors_match_jax(blobs, case):
    data, _ = blobs
    calls = {
        "no_init": ((lambda: iter([data])), 4, {}, "init"),
        "two_epochs": ((lambda: iter([data])), 4, {"init": data[:4], "epochs": 2}, "epochs"),
        "no_batches": ((lambda: iter([])), 4, {"init": data[:4]}, None),
        "k0": ((lambda: data), 0, {}, "k"),
        "k_gt_n": ((lambda: np.zeros((3, 2), np.float32)), 5, {}, "k"),
        "init_count": ((lambda: data), 4, {"init": data[:3]}, "init"),
        "empty": ((lambda: np.zeros((0, 2), np.float32)), 2, {}, None),
    }
    make, k, kw, param = calls[case]
    jerr, terr = (JaxEmpty, EmptyInput) if param is None else (JaxInvalid, InvalidParameter)
    with pytest.raises(jerr) as je:
        J.lloyd_minibatch(make(), k, **kw)
    with pytest.raises(terr) as te:
        T.lloyd_minibatch(make(), k, **kw)
    if param is not None:
        assert te.value.parameter == je.value.parameter == param
