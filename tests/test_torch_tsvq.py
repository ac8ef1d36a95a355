"""``vq_tpu_torch.models.tsvq`` and the rest of ``vq_tpu_torch.ops.distance``
against the JAX package on the same seeded numpy inputs.

Tolerances and named splits:

* Distances: ``pairwise`` and ``distance`` within rtol 1e-5 / atol 1e-5
  (two summation orders of an fp32 dot); ``rowwise`` within rtol 1e-6 /
  atol 1e-6 (both sum ``(x - y)^2`` elementwise, in their own order).
  ``nearest`` codes exact off NaN; on a NaN distance the port keeps the
  ``int2`` rule (a NaN never wins) where the reference's ``jnp.argmin``
  picks the NaN (``ROADMAP.md``, R1).
* Host-built trees: bit for bit (the port's numpy recursion is the JAX
  package's). Device-built trees: topology exact, centroids within
  rtol 1e-6 / atol 1e-6 of the JAX host build's, and bit for bit from
  one run to the next.
* Leaf ids: the port holds one traversal, the JAX package's gather form
  (R2: the JAX TPU forms are not bit-identical to it). Ids are equal
  except where the two child distances at the deciding node are a float
  near tie, a float64 gap within ``TIE_RTOL`` (``descent_gaps``).
* Checkpoints: ``tsvq`` files load across packages in both directions,
  trees and codes exact.
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from vq_tpu.models import tsvq as jt
from vq_tpu.ops import distance as jd
from vq_tpu.utils import load as jload
from vq_tpu.utils import save as jsave
from vq_tpu_torch.models import tsvq as tt
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import distance as td
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

TIE_RTOL = 1e-5
METRICS = ["squared_euclidean", "euclidean", "manhattan", "cosine"]


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _close(got, want, rtol, atol):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_jax(metric):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 9)).astype(np.float32)
    c = rng.standard_normal((12, 9)).astype(np.float32)
    x[3] = 0.0  # cosine's zero-norm guard
    _close(td.pairwise(x, c, metric), jd.pairwise(x, c, metric), 1e-5, 1e-5)
    assert td.distance(x[1], c[2], metric) == pytest.approx(
        jd.distance(x[1], c[2], metric), rel=1e-5, abs=1e-5)
    _close(td.rowwise(x, c[np.arange(30) % 12], metric),
           jd.rowwise(x, c[np.arange(30) % 12], metric), 1e-6, 1e-6)
    tcodes, tdists = td.nearest(x, c, metric)
    jcodes, jdists = jd.nearest(x, c, metric)
    assert tcodes.dtype == torch.int32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    _close(tdists, jdists, 1e-5, 1e-5)
    obj = td.Distance(metric)
    assert obj == jd.Distance(metric).name and obj.name == metric and repr(obj) == repr(
        jd.Distance(metric))
    assert obj.compute(x[0], c[0]) == pytest.approx(jd.Distance(metric).compute(x[0], c[0]),
                                                    rel=1e-5, abs=1e-5)


def test_nearest_nan_never_wins_r1():
    """R1: the reference's ``jnp.argmin`` lets a NaN distance win; the
    port's ``int2`` argmin never does and keeps the lowest index on ties."""
    c = np.array([[np.nan, 0.0], [1.0, 1.0], [1.0, 1.0], [5.0, 5.0]], np.float32)
    x = np.array([[1.0, 1.0], [4.0, 4.0]], np.float32)
    codes, dists = td.nearest(x, c)
    assert codes.tolist() == [1, 3] and dists.tolist() == [0.0, 2.0]
    assert np.asarray(jd.nearest(x, c)[0]).tolist() == [0, 0]  # the reference picks the NaN


def test_distance_errors_match_jax():
    with pytest.raises(vq_tpu.DimensionMismatch):
        jd.distance(np.ones(3), np.ones(4))
    with pytest.raises(vq_tpu_torch.DimensionMismatch):
        td.distance(np.ones(3), np.ones(4))
    with pytest.raises(vq_tpu_torch.InvalidParameter):
        td.distance(np.ones((2, 3)), np.ones(3))
    with pytest.raises(vq_tpu_torch.InvalidParameter):
        td.Distance("chebyshev")
    with pytest.raises(vq_tpu_torch.DimensionMismatch):
        td.rowwise(np.ones((2, 3)), np.ones((2, 4)))


def _tree_cases():
    rng = np.random.default_rng(42)
    uniform = rng.random((2000, 16), dtype=np.float32)
    nan_rows = rng.random((300, 8), dtype=np.float32)
    nan_rows[7, 2] = nan_rows[100, 5] = np.nan
    ramp = np.ones((20, 4), np.float32)
    ramp[:, 0] = np.arange(20)
    ramp[3, 0] = np.nan  # a NaN row goes right
    same = np.tile(np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32), (10, 1))
    return {
        "uniform-2000x16-d5": (uniform, 5),
        "nan-rows-300x8-d4": (nan_rows, 4),
        "nan-goes-right-20x4-d3": (ramp, 3),
        "identical-10x5-d3": (same, 3),
        "depth0-5x4": (rng.random((5, 4), dtype=np.float32), 0),
        "one-row-1x4-d3": (rng.random((1, 4), dtype=np.float32), 3),
    }


TREE_CASES = _tree_cases()


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_trees_match_jax(case):
    data, depth = TREE_CASES[case]
    want = jt.tsvq_build(data, depth)
    host = tt.tsvq_build(data, depth)
    np.testing.assert_array_equal(host.centroids.numpy(), np.asarray(want.centroids))
    np.testing.assert_array_equal(host.left.numpy(), np.asarray(want.left))
    np.testing.assert_array_equal(host.right.numpy(), np.asarray(want.right))
    dev = tt.tsvq_build_batched(data, depth)
    assert dev.num_nodes == want.num_nodes == tt.tsvq_build_batched(data, depth).num_nodes
    np.testing.assert_array_equal(dev.left.numpy(), np.asarray(want.left))
    np.testing.assert_array_equal(dev.right.numpy(), np.asarray(want.right))
    np.testing.assert_allclose(dev.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-6, atol=1e-6)
    assert tt.split_differences(data, host, dev) == []
    again = tt.tsvq_build_batched(data, depth)
    assert torch.equal(again.centroids.nan_to_num(7.0), dev.centroids.nan_to_num(7.0))


def test_split_differences_reports_a_changed_split():
    data, depth = TREE_CASES["uniform-2000x16-d5"]
    a, b = tt.tsvq_build(data, depth), tt.tsvq_build(data, depth)
    dims, thr = b.splits
    b.splits = (np.where(np.arange(dims.shape[0]) == 1, (dims + 1) % 16, dims), thr)
    (node, dim_a, dim_b, dev_a, dev_b), = tt.split_differences(data, a, b)
    assert (node, dim_b) == (1, (dim_a + 1) % 16) and dev_a > dev_b > 0


@pytest.mark.parametrize("metric", METRICS)
def test_encode_matches_jax_gather_traversal_r2(metric):
    """R2: held to the JAX package's gather traversal (on the CPU it is the
    one ``_find_leaves`` takes); ids equal except float near ties."""
    rng = np.random.default_rng(7)
    data = rng.random((1500, 16), dtype=np.float32)
    x = rng.random((2000, 16), dtype=np.float32)
    jq = vq_tpu.TSVQ(data, 5, metric)
    tq = tt.TSVQ(data, 5, metric)
    want = np.asarray(jq.encode(x))
    got = tq.encode(x)
    assert got.dtype == torch.int32
    gaps = tt.descent_gaps(tq.tree, x, got, want, metric)
    assert (gaps <= TIE_RTOL).all(), gaps
    assert gaps.size <= 2, gaps
    q = tq.quantize(x[:50])
    assert q.dtype == torch.float16
    same = got[:50].numpy() == want[:50]
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq.quantize(x[:50]))[same])
    assert tq.encode(x[3]).ndim == 0 and tq.quantize(x[3]).shape == (16,)


def test_descent_gaps_flags_a_forced_flip():
    data, depth = TREE_CASES["uniform-2000x16-d5"]
    tq = tt.TSVQ(data, depth)
    x = data[:20]
    codes = tq.encode(x)
    left, right = tq.tree.left.numpy(), tq.tree.right.numpy()
    sibling = {int(c): int(r) for c, r in zip(left, right) if c >= 0}
    sibling.update({v: k for k, v in sibling.items()})
    flipped = codes.clone()
    flipped[0] = sibling[int(codes[0])]
    gaps = tt.descent_gaps(tq.tree, x, codes, flipped)
    assert gaps.shape == (1,) and gaps[0] > TIE_RTOL


def test_class_surface_matches_jax():
    data, depth = TREE_CASES["uniform-2000x16-d5"]
    jq, tq = vq_tpu.TSVQ(data, depth), tt.TSVQ(data, depth, build="device")
    assert (tq.dim, tq.max_depth, tq.num_nodes, tq.num_leaves, tq.distance_metric) == (
        jq.dim, jq.max_depth, jq.num_nodes, jq.num_leaves, jq.distance_metric)
    assert tq.distance == "euclidean" and repr(tq) == repr(jq)
    q = tq.quantize(data[:4])
    back = tq.dequantize(q)
    assert back.dtype == torch.float32 and torch.equal(back, q.float())
    np.testing.assert_allclose(tq.decode(tq.encode(data[:5])).numpy(),
                               np.asarray(jq.decode(jq.encode(data[:5]))), rtol=1e-6, atol=1e-6)
    prebuilt = tt.TSVQ(tree=tq.tree, distance="manhattan")
    assert prebuilt.distance_metric == "manhattan" and prebuilt.num_nodes == tq.num_nodes


def test_errors_match_jax():
    data, depth = TREE_CASES["uniform-2000x16-d5"]
    tq = tt.TSVQ(data, 3)
    with pytest.raises(vq_tpu_torch.EmptyInput):
        tt.TSVQ(np.zeros((0, 4), np.float32), 3)
    with pytest.raises(vq_tpu_torch.DimensionMismatch):
        tq.quantize(np.ones(5, np.float32))
    with pytest.raises(vq_tpu_torch.DimensionMismatch):
        tq.dequantize(np.ones(5, np.float16))
    with pytest.raises(vq_tpu_torch.DimensionMismatch):
        tt.TSVQ([[1.0, 2.0], [1.0]], 2)
    with pytest.raises(vq_tpu_torch.InvalidParameter):
        tt.TSVQ(data, -1)
    with pytest.raises(vq_tpu_torch.InvalidParameter):
        tt.TSVQ(data, 2, build="gpu")
    with pytest.raises(vq_tpu_torch.InvalidParameter):
        tt.TSVQ()


def test_checkpoints_load_across_packages(tmp_path):
    data, _ = TREE_CASES["nan-rows-300x8-d4"]
    x = np.random.default_rng(3).random((100, 8), dtype=np.float32)
    jq = vq_tpu.TSVQ(data, 4, "manhattan")
    tq = vq_tpu_torch.load(jsave(str(tmp_path / "jax_tsvq"), jq))
    assert isinstance(tq, tt.TSVQ) and tq.distance_metric == "manhattan" and tq.tree.splits is None
    np.testing.assert_array_equal(tq.tree.centroids.numpy(), np.asarray(jq.tree.centroids))
    np.testing.assert_array_equal(tq.encode(x).numpy(), np.asarray(jq.encode(x)))
    back = jload(vq_tpu_torch.save(str(tmp_path / "port_tsvq"), tt.TSVQ(data, 4, "cosine")))
    want = vq_tpu.TSVQ(data, 4, "cosine")
    assert isinstance(back, vq_tpu.TSVQ) and back.distance_metric == "cosine"
    assert back.max_depth == 4
    np.testing.assert_array_equal(np.asarray(back.tree.centroids), np.asarray(want.tree.centroids))
    np.testing.assert_array_equal(np.asarray(back.tree.left), np.asarray(want.tree.left))
    np.testing.assert_array_equal(np.asarray(back.tree.right), np.asarray(want.tree.right))
