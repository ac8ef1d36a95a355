"""``vq_tpu_torch.knn_graph`` against ``vq_tpu.knn_graph`` on the same
seeded numpy rows (JAX on the CPU), the cases of ``tests/test_knn.py``.

Tolerances: values within rtol 1e-5 / atol 1e-4 (both packages assemble
``||q||^2 - 2 q.y + ||y||^2`` in f32, in their own summation orders), ids
equal at every rank whose value lies farther than that from every other
value of its row (``assert_probe_parity``); against a float64 brute force,
values within 1e-4 and >= 0.99 of the ids equal (near ties may swap).
Within the port, the graph does not depend on ``query_batch``: ids at
separated ranks equal and values within the same tolerance (the batch's
product may sum in another order).
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

_TOL = {"rtol": 1e-5, "atol": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(29).standard_normal((300, 16)).astype(np.float32)


def brute_knn(x, k, include_self):
    x = x.astype(np.float64)
    d = ((x[None, :, :] - x[:, None, :]) ** 2).sum(-1)
    if not include_self:
        np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, axis=1)


def _dense(metric, x):
    """float64 values of every pair, self-pairs worst; scores for dot."""
    x = x.astype(np.float64)
    if metric == "dot":
        d = x @ x.T
        np.fill_diagonal(d, -np.inf)
        return d
    if metric == "manhattan":
        d = np.abs(x[:, None] - x[None]).sum(-1)
    else:
        n = np.linalg.norm(x, axis=1)
        d = 1 - (x @ x.T) / np.outer(n, n)
    np.fill_diagonal(d, np.inf)
    return d


@pytest.mark.parametrize("case", [(5, 64, "squared_euclidean"), (4, 128, "dot"),
                                  (3, 300, "cosine"), (2, 77, "manhattan")],
                         ids=lambda c: "k%d-qb%d-%s" % c)
def test_knn_graph_matches_jax(data, case):
    """Every metric, batches that do and do not divide n (77: a ragged
    last batch, which the JAX package pads and the port does not): the
    JAX graph for the metrics of ``tests/test_knn.py`` (squared L2, dot),
    a float64 brute force for cosine and Manhattan."""
    k, qb, metric = case
    got = vq_tpu_torch.knn_graph(data, k=k, metric=metric, query_batch=qb)
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (300, k)
    if metric in ("squared_euclidean", "dot"):
        want = vq_tpu.knn_graph(data, k=k, metric=metric, query_batch=qb)
    else:
        d = _dense(metric, data)
        ids = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
        want = ids, np.take_along_axis(d, ids, axis=1)
    assert_probe_parity(got, want, **_TOL)
    assert not (got[0].numpy() == np.arange(300)[:, None]).any()
    if metric == "dot":
        assert (np.diff(got[1].numpy(), axis=1) <= 0).all()
    else:
        assert (np.diff(got[1].numpy(), axis=1) >= 0).all()


def test_knn_graph_matches_bruteforce(data):
    ids, vals = vq_tpu_torch.knn_graph(data, k=5, query_batch=64)
    ref_ids, ref_d = brute_knn(data, 5, include_self=False)
    np.testing.assert_allclose(vals.numpy(), ref_d, rtol=1e-4, atol=1e-4)
    assert (ids.numpy() == ref_ids).mean() > 0.99


def test_include_self_puts_self_first(data):
    ids, vals = vq_tpu_torch.knn_graph(data, k=3, include_self=True, query_batch=50)
    want = vq_tpu.knn_graph(data, k=3, include_self=True, query_batch=50)
    np.testing.assert_array_equal(ids.numpy()[:, 0], np.arange(300))
    assert vals.numpy()[:, 0].max() < 1e-3
    assert_probe_parity((ids, vals), want, **_TOL)


def test_small_n_pads(data):
    for metric, worst in (("squared_euclidean", np.inf), ("dot", -np.inf)):
        ids, vals = vq_tpu_torch.knn_graph(data[:4], k=10, metric=metric)
        wids, wvals = vq_tpu.knn_graph(data[:4], k=10, metric=metric)
        assert tuple(ids.shape) == (4, 10)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
        assert (ids.numpy()[:, 3:] == -1).all()  # only 3 neighbours
        assert (vals.numpy()[:, 3:] == worst).all()
        np.testing.assert_allclose(vals.numpy()[:, :3], np.asarray(wvals)[:, :3], **_TOL)


def test_ragged_tail_batch_and_batch_independence(data):
    """300 rows in batches of 77: the last batch is 69 rows as it stands;
    the graph equals the one-batch graph."""
    ragged = vq_tpu_torch.knn_graph(data, k=2, query_batch=77)
    whole = vq_tpu_torch.knn_graph(data, k=2, query_batch=300)
    assert_probe_parity(ragged, whole, **_TOL)
    ref_ids, _ = brute_knn(data, 2, include_self=False)
    assert (ragged[0].numpy() == ref_ids).mean() > 0.99


def test_validation(data):
    for pkg, err in ((vq_tpu, jerr), (vq_tpu_torch, terr)):
        with pytest.raises(err.InvalidParameter):
            pkg.knn_graph(data, k=0)
        with pytest.raises(err.InvalidParameter):
            pkg.knn_graph(np.zeros((0, 4), np.float32), k=1)
