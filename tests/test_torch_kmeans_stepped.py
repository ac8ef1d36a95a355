"""``vq_tpu_torch.lloyd_stepped`` and the ``kmeans_state`` checkpoints
against ``vq_tpu.ops.kmeans_stepped`` (JAX on the CPU), mirroring
``tests/test_kmeans_stepped.py``; the port runs K2's and K1's plain
versions here.

Tolerances and splits:

* checkpoints cross-load both ways: centroids, iteration and seed exact;
* a resumed run, from one shared checkpoint, in both packages: centroids
  within rtol / atol 1e-5 and the same iteration count, on well-separated
  blobs where no cluster empties (so neither package draws a reseed,
  whose streams differ: threefry against ``torch.Generator``);
* seeded runs: the inertia within 5% of the JAX package's on uniform
  data, whose local minima lie close together;
* the ``kmeans_iter`` events carry the same field names;
* R1: the final assignment is K1's ``int2`` argmin, where the JAX
  package's ``jnp.argmin`` lets a NaN score win
  (``test_final_assignment_nan_never_wins_R1``).
"""

import json

import numpy as np
import pytest
import torch

import vq_tpu_torch
from vq_tpu.ops.kmeans_stepped import lloyd_stepped as jax_stepped
from vq_tpu.utils import serialize as jser
from vq_tpu.utils.metrics import MetricsLogger as JaxLogger
from vq_tpu_torch.errors import InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops.kmeans_stepped import lloyd_stepped
from vq_tpu_torch.utils import serialize as tser
from vq_tpu_torch.utils.metrics import MetricsLogger
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

K = 6


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    centres = rng.normal(0, 6, (K, 8)).astype(np.float32)
    x = centres[rng.integers(0, K, 480)] + rng.normal(0, 0.4, (480, 8)).astype(np.float32)
    return x.astype(np.float32)


def test_exported():
    assert {"lloyd_stepped", "lloyd_minibatch", "lloyd_batched"} <= set(vq_tpu_torch.__all__)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load(tmp_path, writer):
    c = np.random.default_rng(1).random((K, 8)).astype(np.float32)
    path = str(tmp_path / "km")
    if writer == "jax":
        path = jser.save_kmeans_state(path, jser.KMeansCheckpoint(c, 4, 9))
        st = tser.load_kmeans_state(path)
        assert isinstance(st.centroids, torch.Tensor)
    else:
        path = tser.save_kmeans_state(path, tser.KMeansCheckpoint(torch.from_numpy(c), 4, 9))
        st = jser.load_kmeans_state(path)
    np.testing.assert_array_equal(np.asarray(st.centroids), c)
    assert (st.iteration, st.seed) == (4, 9)


def test_wrong_kind_rejected(tmp_path):
    pq = vq_tpu_torch.ProductQuantizer(np.random.default_rng(0).random((64, 4), np.float32), 2, 4)
    path = vq_tpu_torch.save(str(tmp_path / "pq"), pq)
    with pytest.raises(InvalidData, match="kmeans_state"):
        tser.load_kmeans_state(path)


def test_resume_from_a_shared_checkpoint_matches_jax(blobs, tmp_path):
    ck = str(tmp_path / "shared.npz")
    jax_stepped(blobs, K, max_iters=2, seed=5, checkpoint_path=ck)
    j = jax_stepped(blobs, K, max_iters=8, seed=5, resume_from=ck)
    t = lloyd_stepped(blobs, K, max_iters=8, seed=5, resume_from=ck)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-5, atol=1e-5)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    np.testing.assert_array_equal(t.assignments.numpy(), np.asarray(j.assignments))
    np.testing.assert_allclose(float(t.inertia), float(j.inertia), rtol=1e-5)


def test_seeded_runs_agree_on_inertia():
    x = np.random.default_rng(11).random((600, 4)).astype(np.float32)
    j = jax_stepped(x, K, max_iters=20, seed=3)
    t = lloyd_stepped(x, K, max_iters=20, seed=3)
    assert abs(float(t.inertia) - float(j.inertia)) <= 0.05 * float(j.inertia)


def test_checkpoint_resume_is_bit_exact(blobs, tmp_path):
    ck = str(tmp_path / "km.npz")
    full = lloyd_stepped(blobs, K, max_iters=6, seed=2)
    lloyd_stepped(blobs, K, max_iters=3, seed=2, checkpoint_path=ck)
    resumed = lloyd_stepped(blobs, K, max_iters=6, seed=2, resume_from=ck)
    assert torch.equal(full.centroids, resumed.centroids)
    assert int(full.iterations) == int(resumed.iterations)


def test_resume_replays_the_reseed_stream(tmp_path):
    """Uniform data with more clusters than it fills early: reseeds occur,
    and the resumed run still ends where the uninterrupted one does."""
    x = np.random.default_rng(4).random((60, 2)).astype(np.float32)
    x[:40] = 0.5  # 40 identical rows: many clusters start on them and empty
    ck = str(tmp_path / "km.npz")
    full = lloyd_stepped(x, 12, max_iters=8, seed=1, eps=0.0)
    lloyd_stepped(x, 12, max_iters=4, seed=1, eps=0.0, checkpoint_path=ck)
    resumed = lloyd_stepped(x, 12, max_iters=8, seed=1, eps=0.0, resume_from=ck)
    assert torch.equal(full.centroids, resumed.centroids)


def test_logger_field_names_match_jax(blobs):
    jev, tev = [], []
    jax_stepped(blobs, K, max_iters=3, seed=0, logger=JaxLogger(jev.append))
    lloyd_stepped(blobs, K, max_iters=3, seed=0, logger=MetricsLogger(tev.append))
    assert [e["event"] for e in tev] == [e["event"] for e in jev] == ["kmeans_iter"] * 3
    assert [sorted(e) for e in tev] == [sorted(e) for e in jev]
    assert [e["iteration"] for e in tev] == [1, 2, 3]


def test_metrics_stream_to_a_file(blobs, tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with MetricsLogger(path) as logger:
        res = lloyd_stepped(blobs, K, max_iters=4, seed=0, logger=logger)
    iters = [json.loads(line) for line in open(path)]
    assert len(iters) == int(res.iterations)
    assert all(e["inertia"] > 0 and e["occupancy_min"] >= 0 and e["step_s"] >= 0 for e in iters)
    assert iters[-1]["inertia"] <= iters[0]["inertia"] + 1e-3


def test_checkpoint_every(blobs, tmp_path):
    ck = str(tmp_path / "every.npz")
    lloyd_stepped(blobs, K, max_iters=5, seed=0, eps=0.0, checkpoint_path=ck, checkpoint_every=2)
    assert tser.load_kmeans_state(ck).iteration == 4


def test_resume_shape_mismatch(blobs, tmp_path):
    ck = str(tmp_path / "km.npz")
    lloyd_stepped(blobs, K, max_iters=1, seed=0, checkpoint_path=ck)
    with pytest.raises(InvalidParameter):
        lloyd_stepped(blobs, 2 * K, max_iters=2, seed=0, resume_from=ck)


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=10_000), dict(k=4, max_iters=-1)])
def test_validation_matches_jax(blobs, kw):
    from vq_tpu.errors import InvalidParameter as JaxInvalid

    with pytest.raises(JaxInvalid):
        jax_stepped(blobs, **kw)
    with pytest.raises(InvalidParameter):
        lloyd_stepped(blobs, **kw)


def test_final_assignment_nan_never_wins_R1(tmp_path):
    """R1: resumed at its last iteration, each package only assigns. With
    a NaN centroid every row scores NaN against it: the JAX package's
    ``jnp.argmin`` picks the NaN (code 0 for every row), K1's ``int2``
    argmin never does."""
    x = np.array([[0.0], [0.1], [5.0], [5.1]], np.float32)
    cents = np.array([[np.nan], [0.0], [5.0]], np.float32)
    ck = jser.save_kmeans_state(str(tmp_path / "nan"), jser.KMeansCheckpoint(cents, 3, 0))
    j = jax_stepped(x, 3, max_iters=3, resume_from=ck)
    t = lloyd_stepped(x, 3, max_iters=3, resume_from=ck)
    assert int(j.iterations) == int(t.iterations) == 3
    assert np.asarray(j.assignments).tolist() == [0, 0, 0, 0]
    assert t.assignments.tolist() == [1, 1, 2, 2]
