"""``vq_tpu_torch.BatchPipeline`` / ``pipelined_search`` against
``vq_tpu.serving`` (JAX on the CPU), mirroring
``tests/test_serving_pipeline.py`` without ``GraphIndex`` and the
factory, which the port does not have yet (a ``TransformedIndex`` over
IVF-Flat stands in for the factory's ``"PCA8,IVF4,Flat"``).

* Each port pipeline's batches equal one ``search`` call each, ids and
  values bit for bit (``torch.equal``): the same core runs on the same
  operands.
* Against the JAX pipeline over the same index (its checkpoint loaded by
  the port): values within rtol 1e-5 / atol 1e-4, ids equal at every
  rank whose value is apart from its row's others by more than that
  (``assert_probe_parity``); Hamming counts exactly.
* R11: after ``rebalance()`` the JAX pipeline, which checks ``ntotal``
  alone, fails inside XLA on a donated buffer; the port's pipeline also
  checks its pool's ``version`` and raises ``InvalidData``
  (``test_stale_after_rebalance_R11``).
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch import (
    BatchPipeline,
    BinaryIndex,
    FlatIndex,
    IdMapIndex,
    IVFBinaryIndex,
    IVFFlatIndex,
    IVFPQIndex,
    IVFRQIndex,
    IVFSQIndex,
    PCATransform,
    PQIndex,
    ProductQuantizer,
    RefineIndex,
    ResidualQuantizer,
    RQIndex,
    SQIndex,
    TransformedIndex,
    load_index,
    pipelined_search,
)
from vq_tpu_torch.errors import DimensionMismatch, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

T, Q, D, K = 3, 16, 16, 5


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _data(n=400, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _batches(seed=1):
    return np.random.default_rng(seed).normal(size=(T, Q, D)).astype(np.float32)


def _assert_pipeline_matches(index, batches, **params):
    pipe = BatchPipeline(index, k=K, **params)
    ids_p, vals_p = pipe.search(batches)
    assert tuple(ids_p.shape[:2]) == (T, Q)
    for t in range(T):
        ids_s, vals_s = index.search(batches[t], K, **params)
        assert torch.equal(ids_p[t], ids_s) and torch.equal(vals_p[t], vals_s), t
    return ids_p, vals_p


def _pq(x):
    return ProductQuantizer(x, 4, 16, max_iters=3, seed=1)


_BUILDERS = {
    "flat": (lambda x: FlatIndex.from_data(x), {}),
    "flat_dot": (lambda x: FlatIndex.from_data(x, metric="dot"), {}),
    "pq": (lambda x: _filled(PQIndex(_pq(x)), x), {}),
    "pq_rerank": (lambda x: _filled(PQIndex(_pq(x), keep_corpus=True), x), {"rerank": 20}),
    "sq": (lambda x: SQIndex.from_data(x), {}),
    "sq_rerank": (lambda x: SQIndex.from_data(x, keep_corpus=True), {"rerank": 20}),
    "rq": (lambda x: _filled(RQIndex(ResidualQuantizer(x, 2, 16, max_iters=3, seed=1)), x), {}),
    "binary": (lambda x: _filled(BinaryIndex(D), x), {}),
    "binary_rerank": (lambda x: _filled(BinaryIndex(D, keep_corpus=True), x), {"rerank": 20}),
    "ivf_flat": (lambda x: _filled(IVFFlatIndex.train(x, 4, max_iters=3, seed=1), x),
                 {"nprobe": 2}),
    "ivf_sq": (lambda x: _filled(IVFSQIndex.train(x, 4, max_iters=3, seed=1), x), {"nprobe": 2}),
    "ivf_rq": (lambda x: _filled(IVFRQIndex.train(x, 4, num_stages=2, num_centroids=16,
                                                  max_iters=3, seed=1), x), {"nprobe": 2}),
    "ivf_pq": (lambda x: _filled(IVFPQIndex.train(x, 4, 4, 16, max_iters=3, seed=1), x),
               {"nprobe": 2}),
    "ivf_pq_rerank": (lambda x: _filled(IVFPQIndex.train(x, 4, 4, 16, max_iters=3, seed=1,
                                                         keep_corpus=True), x),
                      {"nprobe": 2, "rerank": 20}),
    "ivf_binary": (lambda x: _filled(IVFBinaryIndex.train(x, 4, max_iters=3, seed=1), x),
                   {"nprobe": 2}),
    "transformed": (lambda x: _filled(_pca_ivf(x), x), {"nprobe": 2}),
    "refine": (lambda x: _filled(RefineIndex(IVFPQIndex.train(x, 4, 4, 16, max_iters=3, seed=1),
                                             "sq8"), x), {"nprobe": 2, "k_factor": 4}),
}


def _pca_ivf(x):
    """The factory's ``"PCA8,IVF4,Flat"``: PCA to 8, IVF-Flat on the projection."""
    pca = PCATransform(D, 8).fit(x)
    return TransformedIndex([pca], IVFFlatIndex.train(pca.apply(x), 4, max_iters=3, seed=1))


def _filled(idx, x):
    idx.add(x)
    return idx


@pytest.mark.parametrize("name", list(_BUILDERS))
def test_pipeline_equals_per_batch_search(name):
    build, params = _BUILDERS[name]
    _assert_pipeline_matches(build(_data()), _batches(), **params)


@pytest.fixture(scope="module")
def jax_ivf(tmp_path_factory):
    """A JAX IVF-Flat index over ``_data()`` and its checkpoint."""
    idx = vq_tpu.IVFFlatIndex.train(_data(), 4, max_iters=3, seed=1)
    idx.add(_data())
    return idx, idx.save(str(tmp_path_factory.mktemp("serving") / "ivf"))


def test_matches_the_jax_pipeline(jax_ivf):
    jidx, path = jax_ivf
    want = vq_tpu.BatchPipeline(jidx, k=K, nprobe=2).search(_batches())
    got = _assert_pipeline_matches(load_index(path), _batches(), nprobe=2)
    for t in range(T):
        assert_probe_parity((got[0][t].numpy(), got[1][t].numpy()),
                            (np.asarray(want[0][t]), np.asarray(want[1][t])), rtol=1e-5, atol=1e-4)


def test_pipelined_search_matches_jax(jax_ivf):
    jidx, path = jax_ivf
    q = _data(n=37, seed=5)
    want = vq_tpu.pipelined_search(jidx, q, k=K, batch=8, nprobe=2)
    got = pipelined_search(load_index(path), q, k=K, batch=8, nprobe=2)
    assert tuple(got[0].shape) == (37, K)
    assert_probe_parity((got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1])),
                        rtol=1e-5, atol=1e-4)


def test_stale_after_rebalance_R11(jax_ivf):
    """R11: ``rebalance()`` keeps ``ntotal``, the one thing the JAX
    pipeline checks, so it does not raise its ``InvalidData``; nor does it
    serve a snapshot: the JAX pool's appends donate its buffers, and the
    stale pipeline fails inside XLA on a deleted buffer. The port's pool
    changes in place too; its pipeline also checks the pool's ``version``
    and raises ``InvalidData``, and a new pipeline serves the new lists."""
    _, path = jax_ivf
    jidx, tidx = vq_tpu.IVFFlatIndex.load(path), load_index(path)
    jpipe = vq_tpu.BatchPipeline(jidx, k=K, nprobe=2)
    tpipe = BatchPipeline(tidx, k=K, nprobe=2)
    jpipe.search(_batches())
    tpipe.search(_batches())
    jinfo, tinfo = jidx.rebalance(target_max=40), tidx.rebalance(target_max=40)
    assert jinfo["split"] > 0 and tinfo["split"] > 0
    assert jidx.ntotal == tidx.ntotal == 400
    with pytest.raises(ValueError, match="deleted or donated") as err:
        jpipe.search(_batches())
    assert not isinstance(err.value, vq_tpu.errors.VqError)
    with pytest.raises(InvalidData):
        tpipe.search(_batches())
    _assert_pipeline_matches(tidx, _batches(), nprobe=2)


@pytest.mark.parametrize("wrap", ["transformed", "refine", "plain"])
@pytest.mark.parametrize("edit", ["rebalance", "remove_ids", "add", "merge_from"])
def test_stale_pipeline_raises(wrap, edit):
    x = _data()
    base = IVFFlatIndex.train(x, 4, max_iters=3, seed=1)
    other = IVFFlatIndex(base.coarse)
    if wrap == "transformed":
        t = PCATransform(D).fit(x)
        idx, donor = TransformedIndex([t], base), TransformedIndex([t], other)
    elif wrap == "refine":
        idx, donor = RefineIndex(base, "flat"), RefineIndex(other, "flat")
    else:
        idx, donor = base, other
    idx.add(x)
    donor.add(x[:10])
    pipe = BatchPipeline(idx, k=K, nprobe=2)
    pipe.search(_batches())
    {"rebalance": lambda: base.rebalance(target_max=40),
     "remove_ids": lambda: idx.remove_ids([0, 1]),
     "add": lambda: idx.add(x[:3]),
     "merge_from": lambda: idx.merge_from(donor)}[edit]()
    with pytest.raises(InvalidData):
        pipe.search(_batches())


class TestContract:
    def test_stale_flat_pipeline_raises(self):
        x = _data()
        idx = FlatIndex.from_data(x)
        pipe = BatchPipeline(idx, k=K)
        idx.add(x[:10])
        with pytest.raises(InvalidData):
            pipe.search(_batches())

    def test_bad_rank(self):
        pipe = BatchPipeline(FlatIndex.from_data(_data()), k=K)
        with pytest.raises(InvalidParameter):
            pipe.search(np.zeros((Q, D), np.float32))

    def test_dim_mismatch(self):
        pipe = BatchPipeline(FlatIndex.from_data(_data()), k=K)
        with pytest.raises(DimensionMismatch):
            pipe.search(np.zeros((T, Q, D + 1), np.float32))

    def test_unsupported_index(self):
        with pytest.raises(InvalidParameter):
            BatchPipeline(IdMapIndex(FlatIndex.from_data(_data())), k=K)

    def test_list_of_batches(self):
        idx = FlatIndex.from_data(_data())
        b = _batches()
        got = BatchPipeline(idx, k=K).search([torch.from_numpy(b[t]) for t in range(T)])
        want = BatchPipeline(idx, k=K).search(b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def test_from_core(self):
        idx = IVFFlatIndex.train(_data(), 4, max_iters=3, seed=1)
        idx.add(_data())
        fn, arrays = idx._search_core(K, nprobe=2)
        pipe = BatchPipeline.from_core(fn, arrays, dim=D)
        ids, vals = pipe.search(_batches())
        want = idx.search(_batches()[1], K, nprobe=2)
        assert torch.equal(ids[1], want[0]) and torch.equal(vals[1], want[1])
        with pytest.raises(DimensionMismatch):
            pipe.search(np.zeros((T, Q, D + 1), np.float32))

    def test_pipelined_search_flat_queries(self):
        idx = FlatIndex.from_data(_data())
        q = _data(n=37, seed=5)  # not a multiple of batch
        ids_p, vals_p = pipelined_search(idx, q, k=K, batch=8)
        ids_s, vals_s = idx.search(q, K)
        assert torch.equal(ids_p, ids_s) and torch.equal(vals_p, vals_s)
        ids_1, _ = pipelined_search(idx, q[0], k=K)
        assert torch.equal(ids_1, ids_s[:1])
        with pytest.raises(InvalidParameter):
            pipelined_search(idx, np.zeros((0, D), np.float32), k=K)
        with pytest.raises(InvalidParameter):
            pipelined_search(idx, np.zeros((2, 2, D), np.float32), k=K)

    def test_pipelined_search_reuses_pipeline(self):
        idx = IVFFlatIndex.train(_data(), 4, max_iters=3, seed=1)
        idx.add(_data())
        pipe = BatchPipeline(idx, k=K, nprobe=2)
        q = _data(n=24, seed=6)
        ids_p, _ = pipelined_search(idx, q, k=K, batch=8, pipeline=pipe)
        assert torch.equal(ids_p[:8], idx.search(q[:8], K, nprobe=2)[0])

    def test_exported(self):
        assert vq_tpu_torch.BatchPipeline is BatchPipeline
        assert {"BatchPipeline", "pipelined_search"} <= set(vq_tpu_torch.__all__)
