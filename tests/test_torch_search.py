"""The port's flat serving layer — ``FlatIndex``, ``SQIndex``,
``BinaryIndex`` and the ``range_search`` / ``search_and_reconstruct`` /
``_search_core`` / ``_reconstruct_core`` forms of ``PQIndex`` and
``RQIndex`` — against ``vq_tpu.search`` on the same seeded numpy inputs
(JAX on the CPU; no Pallas kernel is on these paths there), and the merge
step every new scan shares.

Tolerances:

* Flat, SQ, PQ and RQ values: rtol 1e-5 / atol 1e-4 (both packages
  assemble ``||q||^2 - 2 q.y + ||y||^2`` or sum ADC tables in f32, in
  their own summation orders, at ``||q||^2`` up to ~60 here); ids equal
  at every rank whose value lies farther than that from every other
  value of its row (``assert_probe_parity``).
* ``range_search`` counts: exact, at radii chosen at least 1e-3 from
  every value (float64 reference), so no value sits on the boundary.
* Binary: Hamming counts, ids and values bit for bit (both sides count
  the same integers); reranked values within the tolerance above.
* Stored state: SQ codes, packed words and stored rows exact; row norms
  rtol 1e-6. ``reconstruct``: exact, SQ within 1e-5 (``lo + c*step`` is
  one fused multiply-add in XLA's CPU backend, two roundings here).
* The port's own forms: ``_search_core``'s ``fn(q, *arrays)`` equals
  ``search``, and the chunked PQ / RQ scans equal a copy of the loop the
  port ran before ``_topk_scan`` (kept below), with ``torch.equal``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu.search as jsearch
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.models import pq as tpq
from vq_tpu_torch.models.pq import _adc_lookup, _smallest, _topk_scan
from vq_tpu_torch.search import _chunk_values
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

NEG_NAN = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
_TOL = {"rtol": 1e-5, "atol": 1e-4}
_METRICS = ("squared_euclidean", "euclidean", "cosine", "dot", "manhattan")


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _data(seed=19, n=1200, d=16, nq=8):
    """Clustered rows (and queries near them, none an exact row), so that
    neighbours are well apart and no dot score is exactly zero."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 3, (24, d)).astype(np.float32)
    x = (centres[rng.integers(0, 24, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)
    q = (x[rng.choice(n, nq, replace=False)] + rng.normal(0, 0.3, (nq, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def data():
    return _data()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense(metric, q, y):
    """float64 values of every (query, row): scores for ``dot``."""
    q, y = q.astype(np.float64), y.astype(np.float64)
    if metric == "dot":
        return q @ y.T
    if metric == "manhattan":
        return np.abs(q[:, None] - y[None]).sum(-1)
    if metric == "cosine":
        return 1 - (q @ y.T) / np.outer(np.linalg.norm(q, axis=1), np.linalg.norm(y, axis=1))
    d2 = ((q[:, None] - y[None]) ** 2).sum(-1)
    return np.sqrt(d2) if metric == "euclidean" else d2


def _clear_radius(vals, quantile, gap=1e-3):
    """A radius near ``quantile`` of ``vals`` at least ``gap`` from every
    value, so a last-bit difference cannot move a count."""
    s = np.sort(vals.ravel())
    i = int(quantile * (s.size - 1))
    while s[i + 1] - s[i] <= 2 * gap:
        i += 1
    return float((s[i] + s[i + 1]) / 2)


def assert_range_parity(got, want, dense, radius, dot):
    gi, gv, gc = (_np(a) for a in got)
    wi, wv, wc = (_np(a) for a in want)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gc, ((dense >= radius) if dot else (dense <= radius)).sum(1))
    np.testing.assert_array_equal(gi >= 0, wi >= 0)
    hit = wi >= 0
    assert_probe_parity((np.where(hit, gi, -1).astype(np.int32), np.where(hit, gv, 0.0)),
                        (np.where(hit, wi, -1), np.where(hit, wv, 0.0)), **_TOL)
    assert (gv[hit] >= radius if dot else gv[hit] <= radius).all()


# ---------------------------------------------------------------------------
# The merge step (R8).
# ---------------------------------------------------------------------------


def _jax_merge(d, fetch):
    """The reference's merge step (``_flat_scan_jit``'s body, the same in
    its SQ, PQ and RQ scans) over one chunk from an empty best list."""
    cat_d = jnp.concatenate([jnp.full((1, fetch), jnp.inf), jnp.asarray(d)[None]], axis=1)
    cat_i = jnp.concatenate([jnp.full((1, fetch), -1), jnp.arange(len(d))[None]], axis=1)
    _, pos = jax.lax.top_k(-cat_d, fetch)
    return np.asarray(jnp.take_along_axis(cat_i, pos, axis=1))[0].tolist()


_R8_ROWS = [
    # (d, lax.top_k(-d), _smallest(d), the reference's merge, _topk_scan)
    ([1.0, NEG_NAN, 2.0, 0.5], [1, 3, 0, 2], [3, 0, 2, 1], [1, 3, 0, 2], [3, 0, 2, -1]),
    ([0.0, -0.0, 1.0, np.nan, -0.0, 0.0], [1, 4, 0, 5, 2, 3], [0, 1, 4, 5, 2, 3],
     [1, 4, 0, 5, 2, -1], [0, 1, 4, 5, 2, -1]),
]


@pytest.mark.parametrize("row", _R8_ROWS, ids=["negative-nan", "signed-zeros"])
def test_r8_merge_order_splits_from_lax_top_k(row):
    """R8 (ROADMAP.md Queue 3): the reference ranks ``lax.top_k(-d)``, so a
    NaN with its sign bit set (x86's ``inf - inf``) ranks first and -0.0
    before +0.0 whatever their positions. The port's merge keeps the
    stable ascending order: every NaN last (behind an empty slot, too),
    +-0.0 tied by position. Both orders are asserted."""
    d, ref_topk, port_smallest, ref_merge, port_merge = row
    d32 = np.asarray(d, np.float32)
    fetch = len(d)
    assert np.asarray(jax.lax.top_k(-jnp.asarray(d32), fetch)[1]).tolist() == ref_topk
    assert _smallest(torch.from_numpy(d32)[None], fetch)[1][0].tolist() == port_smallest
    assert _jax_merge(d32, fetch) == ref_merge
    got = _topk_scan(lambda c0, c1: torch.from_numpy(d32)[None, c0:c1], fetch, 1, fetch, fetch,
                     "cpu")[0]
    assert got[0].tolist() == port_merge


def test_topk_scan_equals_one_sort_over_chunks():
    """Merging chunk by chunk gives the ids and values of one stable sort
    of the whole row, at chunk sizes that do and do not divide n, and
    counts the radius hits."""
    g = torch.Generator().manual_seed(3)
    d = torch.randint(0, 40, (5, 333), generator=g).float()  # heavy ties
    want_v, want_i = _smallest(d, 17)
    for chunk in (333, 100, 7):
        ids, vals, hits = _topk_scan(lambda c0, c1: d[:, c0:c1], 333, 5, 17, chunk, "cpu", 12.0)
        assert torch.equal(ids, want_i.to(torch.int32)) and torch.equal(vals, want_v)
        assert torch.equal(hits, (d <= 12.0).sum(1).to(torch.int32))


# ---------------------------------------------------------------------------
# FlatIndex.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("metric", _METRICS)
def test_flat_search_matches_jax(data, metric, storage):
    """Against the JAX index at f32 for every metric and at every storage
    for squared L2; a half-width index is also, for every metric, bit for
    bit the f32 index over its rounded rows (it upcasts a chunk at a
    time, so it computes exactly that)."""
    x, q = data
    tidx = vq_tpu_torch.FlatIndex.from_data(x, metric=metric, storage=storage)
    assert tidx._rows.dtype == getattr(torch, storage)
    got = tidx.search(q, k=10, chunk=500)  # three chunks, the last ragged
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    if storage == "float32" or metric == "squared_euclidean":
        jidx = jsearch.FlatIndex.from_data(x, metric=metric, storage=storage)
        np.testing.assert_array_equal(tidx._rows.float().numpy(),
                                      np.asarray(jidx._rows.astype(jnp.float32)))
        np.testing.assert_allclose(tidx._row_sqn.numpy(), np.asarray(jidx._row_sqn), rtol=1e-6)
        assert_probe_parity(got, jidx.search(q, k=10, chunk=500), **_TOL)
    if storage != "float32":
        rounded = vq_tpu_torch.FlatIndex.from_data(tidx._rows.float(), metric=metric)
        want = rounded.search(q, k=10, chunk=500)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fn, arrays = tidx._search_core(10, chunk=500)
    core = fn(torch.from_numpy(q), *arrays)
    assert torch.equal(core[0], got[0]) and torch.equal(core[1], got[1])


@pytest.mark.parametrize("case", [("squared_euclidean", 400), ("euclidean", 6), ("cosine", 6),
                                  ("dot", 400), ("manhattan", 6)], ids=lambda c: "%s-%d" % c)
def test_flat_range_search_matches_jax(data, case):
    """Counts exact; ``max_results = 6`` is below most counts (the true
    count still comes back), 400 above them."""
    metric, max_results = case
    x, q = data
    dot = metric == "dot"
    dense = _dense(metric, q, x)
    radius = _clear_radius(-dense if dot else dense, 0.05)
    radius = -radius if dot else radius
    jidx = jsearch.FlatIndex.from_data(x, metric=metric)
    tidx = vq_tpu_torch.FlatIndex.from_data(x, metric=metric)
    got = tidx.range_search(q, radius, max_results=max_results, chunk=500)
    want = jidx.range_search(q, radius, max_results=max_results, chunk=500)
    assert_range_parity(got, want, dense, radius, dot)
    if max_results == 6:
        assert (got[2] > 6).any()
        # the hits are the prefix of search(k=max_results)
        ids, _ = tidx.search(q, k=6, chunk=500)
        assert torch.equal(got[0], torch.where(got[0] >= 0, ids, -1))


def test_flat_reconstruct_forms_and_padding(data):
    x, q = data
    tidx = vq_tpu_torch.FlatIndex.from_data(x, storage="bfloat16")
    jidx = jsearch.FlatIndex.from_data(x, storage="bfloat16")
    np.testing.assert_array_equal(tidx.reconstruct([3, 7]).numpy(),
                                  np.asarray(jidx.reconstruct([3, 7])))
    ids, vals, rec = tidx.search_and_reconstruct(q, k=4)
    assert tuple(rec.shape) == (8, 4, 16)
    assert torch.equal(rec, tidx.reconstruct(ids.reshape(-1)).reshape(8, 4, 16))
    # Rows of +inf are infinitely far (Manhattan): the empty slots of the
    # best list outrank them, so their ids come back -1 and reconstruct
    # as zero rows, in both packages.
    y = np.concatenate([x[:2], np.full((2, 16), np.inf, np.float32)])
    for pkg in (jsearch, vq_tpu_torch):
        i, v, r = pkg.FlatIndex.from_data(y, metric="manhattan").search_and_reconstruct(q[:3], k=4)
        assert _np(i)[:, 2:].tolist() == [[-1, -1]] * 3
        assert (_np(r)[:, 2:] == 0).all() and np.isfinite(_np(r)).all()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "float16"])
def test_flat_checkpoints_cross_packages(data, tmp_path, storage):
    """Either package's ``flat_index`` checkpoint loads in the other (bf16
    rows saved as f32 and reloaded at bf16) and searches the same."""
    x, q = data
    jidx = jsearch.FlatIndex.from_data(x, metric="cosine", storage=storage)
    tidx = vq_tpu_torch.FlatIndex.load(jidx.save(str(tmp_path / "j")), device="cpu")
    assert (tidx.metric, tidx.storage, tidx._rows.dtype) == ("cosine", storage,
                                                             getattr(torch, storage))
    back = jsearch.FlatIndex.load(tidx.save(str(tmp_path / "t")))
    np.testing.assert_array_equal(np.asarray(back._rows), np.asarray(jidx._rows))
    assert_probe_parity(tidx.search(q, k=5), jidx.search(q, k=5), **_TOL)
    assert repr(tidx) == repr(jidx)


def assert_same_search(a, b, q, **kw):
    ga, gb = a.search(q, **kw), b.search(q, **kw)
    assert torch.equal(ga[0], gb[0]) and torch.equal(ga[1], gb[1])


def _kept(x, drop):
    return x[np.setdiff1d(np.arange(len(x)), drop)]


def test_flat_remove_and_merge(data):
    """faiss's ``remove_ids`` / ``merge_from`` contract, as
    ``tests/test_search.py`` and ``tests/test_merge.py`` hold the JAX
    package to it: the edited index searches exactly as a fresh index over
    the rows it keeps, in their order."""
    x, q = data
    a = vq_tpu_torch.FlatIndex.from_data(x[:700])
    b = vq_tpu_torch.FlatIndex.from_data(x[700:])
    assert a.remove_ids([0, 5, 5, 699]) == 3 and a.ntotal == 697
    assert a.merge_from(b) == 500 and b.ntotal == 0 and a.ntotal == 1197
    fresh = vq_tpu_torch.FlatIndex.from_data(np.concatenate([_kept(x[:700], [0, 5, 699]), x[700:]]))
    assert_same_search(a, fresh, q, k=10)
    idx = vq_tpu_torch.FlatIndex.from_data(x[:10])
    for other, err in ((vq_tpu_torch.FlatIndex(16, metric="dot"), terr.InvalidData),
                       (vq_tpu_torch.FlatIndex(16, storage="float16"), terr.InvalidData),
                       (vq_tpu_torch.FlatIndex(8), terr.InvalidData),
                       (vq_tpu_torch.BinaryIndex(16), terr.InvalidParameter)):
        with pytest.raises(err):
            idx.merge_from(other)


def test_flat_validation():
    for pkg, err in ((jsearch, jerr), (vq_tpu_torch, terr)):
        with pytest.raises(err.InvalidParameter):
            pkg.FlatIndex(8, metric="nope")
        with pytest.raises(err.InvalidParameter):
            pkg.FlatIndex(8, storage="f64")
        idx = pkg.FlatIndex(8)
        with pytest.raises(err.EmptyInput):
            idx.search(np.zeros((1, 8), np.float32))
        with pytest.raises(err.EmptyInput):
            idx.range_search(np.zeros((1, 8), np.float32), 1.0)
        with pytest.raises(err.EmptyInput):
            idx.remove_ids([0])
        idx.add(np.zeros((4, 8), np.float32))
        with pytest.raises(err.DimensionMismatch):
            idx.search(np.zeros((1, 9), np.float32))
        with pytest.raises(err.InvalidParameter):
            idx.range_search(np.zeros((1, 8), np.float32), 1.0, max_results=0)
        with pytest.raises(err.InvalidParameter):
            idx.remove_ids([4])


# ---------------------------------------------------------------------------
# SQIndex.
# ---------------------------------------------------------------------------


# (levels, pack_bits, metric): every storage width and every metric.
_SQ_CASES = [(256, 8, "squared_euclidean"), (256, 8, "dot"), (16, 4, "euclidean"),
             (4, 2, "cosine"), (2, 1, "squared_euclidean")]


@pytest.mark.parametrize("case", _SQ_CASES, ids=lambda c: "L%d-b%d-%s" % c)
def test_sq_search_matches_jax(data, case):
    x, q = data
    lv, bits, metric = case
    jidx = jsearch.SQIndex.from_data(x, lv, metric=metric)
    tidx = vq_tpu_torch.SQIndex.from_data(x, lv, metric=metric)
    assert tidx.pack_bits == jidx.pack_bits == bits
    assert tidx.code_bytes_per_vector == jidx.code_bytes_per_vector
    np.testing.assert_array_equal(tidx._codes.numpy(), np.asarray(jidx._codes))
    np.testing.assert_allclose(tidx._row_sqn.numpy(), np.asarray(jidx._row_sqn), rtol=1e-6)
    got = tidx.search(q, k=10, chunk=500)
    assert_probe_parity(got, jidx.search(q, k=10, chunk=500), **_TOL)
    fn, arrays = tidx._search_core(10, chunk=500)
    core = fn(torch.from_numpy(q), *arrays)
    assert torch.equal(core[0], got[0]) and torch.equal(core[1], got[1])
    np.testing.assert_allclose(tidx.reconstruct(np.arange(50)).numpy(),
                               np.asarray(jidx.reconstruct(np.arange(50))), atol=1e-5)


@pytest.mark.parametrize("metric", ["squared_euclidean", "cosine", "dot"])
def test_sq_rerank_matches_jax(data, metric):
    """``dot`` reranks by the exact scores' top-k, the rest by
    ``_PAIRWISE``, from the kept corpus."""
    x, q = data
    jidx = jsearch.SQIndex.from_data(x, 16, metric=metric, keep_corpus=True)
    tidx = vq_tpu_torch.SQIndex.from_data(x, 16, metric=metric, keep_corpus=True)
    assert_probe_parity(tidx.search(q, k=5, rerank=40), jidx.search(q, k=5, rerank=40), **_TOL)
    ids, vals, rec = tidx.search_and_reconstruct(q, k=5, rerank=40)
    assert torch.equal(rec, tidx.reconstruct(ids.reshape(-1)).reshape(8, 5, 16))
    for pkg, err in ((jsearch, jerr), (vq_tpu_torch, terr)):
        with pytest.raises(err.InvalidData):
            pkg.SQIndex.from_data(x[:50]).search(q, k=3, rerank=10)


@pytest.mark.parametrize("case", [(256, "squared_euclidean"), (16, "euclidean"), (256, "dot")],
                         ids=lambda c: "L%d-%s" % c)
def test_sq_range_search_matches_jax(data, case):
    x, q = data
    lv, metric = case
    dot = metric == "dot"
    jidx = jsearch.SQIndex.from_data(x, lv, metric=metric)
    tidx = vq_tpu_torch.SQIndex.from_data(x, lv, metric=metric)
    dense = _dense(metric, q, tidx.reconstruct(np.arange(len(x))).numpy())
    radius = _clear_radius(-dense if dot else dense, 0.05)
    radius = -radius if dot else radius
    assert_range_parity(tidx.range_search(q, radius, max_results=64, chunk=500),
                        jidx.range_search(q, radius, max_results=64, chunk=500),
                        dense, radius, dot)


def test_sq_checkpoints_remove_and_merge(data, tmp_path):
    x, q = data
    jidx = jsearch.SQIndex.from_data(x, 16, metric="cosine", keep_corpus=True)
    tidx = vq_tpu_torch.SQIndex.load(jidx.save(str(tmp_path / "j")), device="cpu")
    assert (tidx.pack_bits, tidx.metric, tidx.keep_corpus) == (4, "cosine", True)
    back = jsearch.SQIndex.load(tidx.save(str(tmp_path / "t")))
    np.testing.assert_array_equal(np.asarray(back._codes), np.asarray(jidx._codes))
    assert_probe_parity(tidx.search(q, k=5, rerank=20), jidx.search(q, k=5, rerank=20), **_TOL)
    assert repr(tidx) == repr(jidx)
    with pytest.raises(terr.InvalidData):
        vq_tpu_torch.PQIndex.load(str(tmp_path / "t"), device="cpu")
    a = vq_tpu_torch.SQIndex.from_data(x, keep_corpus=True)
    b = vq_tpu_torch.SQIndex(a.sq, keep_corpus=True)
    b.add(x[:300])
    assert a.remove_ids(np.arange(0, 1200, 3)) == 400
    assert a.merge_from(b) == 300 and a.ntotal == 1100 and b.ntotal == 0
    fresh = vq_tpu_torch.SQIndex(a.sq, keep_corpus=True)
    fresh.add(np.concatenate([_kept(x, np.arange(0, 1200, 3)), x[:300]]))
    assert_same_search(a, fresh, q, k=6, rerank=30)
    a = vq_tpu_torch.SQIndex.from_data(x)
    for other in (vq_tpu_torch.SQIndex.from_data(x[:600]),
                  vq_tpu_torch.SQIndex(a.sq, metric="dot"),
                  vq_tpu_torch.SQIndex(vq_tpu_torch.PerDimScalarQuantizer(
                      a.sq.mins, a.sq.maxs, 16))):
        with pytest.raises(terr.InvalidData):
            a.merge_from(other)
    with pytest.raises(terr.InvalidData, match="rerank corpus"):
        vq_tpu_torch.SQIndex(a.sq, keep_corpus=True).merge_from(a)
    for pkg, err in ((jsearch, jerr), (vq_tpu_torch, terr)):
        with pytest.raises(err.InvalidParameter):
            pkg.SQIndex.from_data(x, metric="manhattan")


# ---------------------------------------------------------------------------
# BinaryIndex.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 33])
def test_binary_search_matches_jax(dim):
    x, q = _data(seed=23, d=dim)
    jidx = jsearch.BinaryIndex(dim, threshold=0.5, keep_corpus=True)
    tidx = vq_tpu_torch.BinaryIndex(dim, threshold=0.5, keep_corpus=True)
    jidx.add(x)
    tidx.add(x)
    assert tidx._packed.dtype == torch.uint32
    np.testing.assert_array_equal(tidx._packed.numpy(), np.asarray(jidx._packed))
    gi, gv = tidx.search(q, k=12)
    wi, wv = jidx.search(q, k=12)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert_probe_parity(tidx.search(q, k=5, rerank=60), jidx.search(q, k=5, rerank=60), **_TOL)
    fn, arrays = tidx._search_core(5, rerank=60)
    core, direct = fn(torch.from_numpy(q), *arrays), tidx.search(q, k=5, rerank=60)
    assert torch.equal(core[0], direct[0]) and torch.equal(core[1], direct[1])


def test_binary_checkpoints_remove_and_merge(data, tmp_path):
    x, q = data
    jidx = jsearch.BinaryIndex(16, threshold=0.25, keep_corpus=True)
    jidx.add(x)
    tidx = vq_tpu_torch.BinaryIndex.load(jidx.save(str(tmp_path / "j")), device="cpu")
    assert (tidx.bq.threshold, tidx.keep_corpus, tidx.ntotal) == (0.25, True, 1200)
    back = jsearch.BinaryIndex.load(tidx.save(str(tmp_path / "t")))
    np.testing.assert_array_equal(np.asarray(back._packed), np.asarray(jidx._packed))
    for a, b in ((tidx.search(q, k=7), jidx.search(q, k=7)),):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
    assert repr(tidx) == repr(jidx)
    a = vq_tpu_torch.BinaryIndex(16, keep_corpus=True)
    a.add(x[:800])
    b = vq_tpu_torch.BinaryIndex(16, keep_corpus=True)
    b.add(x[800:])
    assert a.remove_ids([5, 6, 799]) == 3
    assert a.merge_from(b) == 400 and a.ntotal == 1197
    fresh = vq_tpu_torch.BinaryIndex(16, keep_corpus=True)
    fresh.add(np.concatenate([_kept(x[:800], [5, 6, 799]), x[800:]]))
    assert_same_search(a, fresh, q, k=9, rerank=40)
    a = vq_tpu_torch.BinaryIndex(16)
    for other, err in ((vq_tpu_torch.BinaryIndex(16, threshold=1.0), terr.InvalidData),
                       (vq_tpu_torch.BinaryIndex(32), terr.InvalidData),
                       (vq_tpu_torch.FlatIndex(16), terr.InvalidParameter)):
        with pytest.raises(err):
            a.merge_from(other)
    for pkg, err in ((jsearch, jerr), (vq_tpu_torch, terr)):
        idx = pkg.BinaryIndex(16)
        with pytest.raises(err.EmptyInput):
            idx.search(q)
        idx.add(x[:20])
        with pytest.raises(err.InvalidData):
            idx.search(q, rerank=5)


# ---------------------------------------------------------------------------
# PQIndex and RQIndex: the new forms.
# ---------------------------------------------------------------------------


def _parent_chunked(values, n, nq, fetch, chunk):
    """The loop the port's PQ and RQ chunked scans ran before
    ``_topk_scan``: ids concatenated beside the values, then gathered."""
    best_d = torch.full((nq, fetch), float("inf"))
    best_i = torch.full((nq, fetch), -1, dtype=torch.int64)
    for c0 in range(0, n, chunk):
        d = values(c0, min(c0 + chunk, n))
        gidx = torch.arange(c0, c0 + d.shape[1])
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, gidx[None, :].expand(nq, -1)], dim=1)
        best_d, pos = _smallest(cat_d, fetch)
        best_i = torch.gather(cat_i, 1, pos)
    return best_i.to(torch.int32), best_d


@pytest.fixture(scope="module")
def pq_pair(data):
    """Random 4x16 codebooks (no training: the tests hold the searches)."""
    x, _ = data
    return x, np.random.default_rng(5).normal(0, 3, (4, 16, 4)).astype(np.float32)


@pytest.mark.parametrize("case", [("squared_euclidean", True), ("euclidean", False),
                                  ("cosine", False), ("manhattan", False)],
                         ids=lambda c: c[0] + ("-packed" if c[1] else ""))
def test_pq_index_forms_match_jax(data, pq_pair, case):
    """``range_search`` (K8's plain version a chunk), ``_search_core``,
    ``_reconstruct_core`` and ``search_and_reconstruct`` against the JAX
    index carrying the same codebooks and codes."""
    metric, packed = case
    x, q = data
    cb = pq_pair[1]
    tidx = vq_tpu_torch.PQIndex(vq_tpu_torch.ProductQuantizer(
        codebooks=cb, distance=metric, device="cpu"), keep_corpus=True, packed=packed)
    tidx.add(x)
    jidx, _ = _carry(jsearch.PQIndex(vq_tpu.ProductQuantizer(codebooks=cb, distance=metric),
                                     keep_corpus=True, packed=packed), tidx, "_codes", "_corpus")
    back = from_state("pq_index", *state_of_jax_pq(jidx), device="cpu")
    assert torch.equal(back._codes, tidx._codes)
    assert tidx.pack_bits == (4 if packed else 8)
    # ADC values are distances to the decoded rows, summed a subspace at a time
    dense = _dense(metric, q, tidx.reconstruct(np.arange(len(x))).numpy())
    radius = _clear_radius(dense, 0.05)
    assert_range_parity(tidx.range_search(q, radius, max_results=32, chunk=500),
                        jidx.range_search(q, radius, max_results=32, chunk=500),
                        dense, radius, False)
    got = tidx.search(q, k=6, rerank=30)
    assert_probe_parity(got, jidx.search(q, k=6, rerank=30), **_TOL)
    fn, arrays = tidx._search_core(6, rerank=30)
    core = fn(torch.from_numpy(q), *arrays)
    assert torch.equal(core[0], got[0]) and torch.equal(core[1], got[1])
    ids = np.array([0, 17, 1199, 17])
    rfn, rarrays = tidx._reconstruct_core()
    assert torch.equal(rfn(torch.from_numpy(ids), *rarrays), tidx.reconstruct(ids))
    np.testing.assert_array_equal(tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids)))
    i, v, rec = tidx.search_and_reconstruct(q, k=6, rerank=30)
    assert torch.equal(i, got[0]) and torch.equal(v, got[1])
    assert torch.equal(rec, tidx.reconstruct(i.reshape(-1)).reshape(8, 6, 16))


def state_of_jax_pq(jidx):
    """A JAX PQIndex as ``(config, arrays)`` of the ``pq_index`` kind."""
    config = {"distance": jidx.pq.distance_metric, "keep_corpus": jidx.keep_corpus,
              "pack_bits": jidx.pack_bits}
    return config, {"codebooks": np.asarray(jidx.pq.codebooks), "codes": np.asarray(jidx._codes),
                    "corpus": np.asarray(jidx._corpus)}


def test_pq_chunked_search_equals_the_parent_loop(data, pq_pair):
    x, q = data
    for metric in ("euclidean", "cosine"):
        pq = vq_tpu_torch.ProductQuantizer(codebooks=pq_pair[1], distance=metric, device="cpu")
        codes = pq.encode(x)
        tables = tpq._adc_tables(torch.from_numpy(q), pq.codebooks, pq._metric)
        # fetch 130 > 128 leaves K5's route: the chunked scan runs
        got = pq.adc_search(q, codes, k=130, chunk=500)
        ids, d, _ = pq._adc_search_chunked(torch.from_numpy(q), codes, 130, 500)
        qn = torch.sqrt((torch.from_numpy(q) ** 2).sum(-1))

        def values(c0, c1):
            acc = _adc_lookup(tables, codes[c0:c1])
            if metric == "euclidean":
                return torch.sqrt(acc.clamp_min(0.0))
            return tpq._cosine_from_dots(acc, pq.codebooks, codes[c0:c1], qn)

        want = _parent_chunked(values, len(x), 8, 130, 500)
        assert torch.equal(ids, want[0]) and torch.equal(d, want[1])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def rq_pair(data):
    """Random 3x16 stage codebooks, each stage a third the scale of the
    last (no training: the tests hold the searches)."""
    rng = np.random.default_rng(6)
    return (rng.normal(0, 1, (3, 16, 16)) * np.array([3.0, 1.0, 0.3])[:, None, None]).astype(
        np.float32)


def _carry(jidx, tidx, *names):
    """Give the JAX index the port's stored arrays (the encodes are held
    to each other in ``tests/test_torch_pq.py`` / ``test_torch_rq.py``)."""
    for name in names:
        setattr(jidx, name, jnp.asarray(getattr(tidx, name).numpy()))
    return jidx, tidx


def _rq_indexes(x, cbs, metric):
    tidx = vq_tpu_torch.RQIndex(vq_tpu_torch.ResidualQuantizer(codebooks=cbs, device="cpu"),
                                metric=metric, keep_corpus=True)
    tidx.add(x)
    jidx = jsearch.RQIndex(vq_tpu.ResidualQuantizer(codebooks=cbs), metric=metric, keep_corpus=True)
    return _carry(jidx, tidx, "_codes", "_row_sqn", "_corpus")


@pytest.mark.parametrize("metric", ["squared_euclidean", "cosine", "dot"])
def test_rq_index_forms_match_jax(data, rq_pair, metric):
    x, q = data
    dot = metric == "dot"
    jidx, tidx = _rq_indexes(x, rq_pair, metric)
    dense = _dense(metric, q, tidx.reconstruct(np.arange(len(x))).numpy())
    radius = _clear_radius(-dense if dot else dense, 0.05)
    radius = -radius if dot else radius
    assert_range_parity(tidx.range_search(q, radius, max_results=32, chunk=500),
                        jidx.range_search(q, radius, max_results=32, chunk=500),
                        dense, radius, dot)
    assert_probe_parity(tidx.search(q, k=6, rerank=30), jidx.search(q, k=6, rerank=30), **_TOL)
    for kw in (dict(k=6), dict(k=6, rerank=30), dict(k=6, chunk=500, rerank=200)):
        got = tidx.search(q, **kw)
        fn, arrays = tidx._search_core(kw.pop("k"), **kw)
        core = fn(torch.from_numpy(q), *arrays)
        assert torch.equal(core[0], got[0]) and torch.equal(core[1], got[1])
    ids = np.array([3, 1199, 3])
    rfn, rarrays = tidx._reconstruct_core()
    assert torch.equal(rfn(torch.from_numpy(ids), *rarrays), tidx.reconstruct(ids))
    np.testing.assert_array_equal(tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids)))
    i, v, rec = tidx.search_and_reconstruct(q, k=4)
    want = tidx.search(q, k=4)
    assert torch.equal(i, want[0]) and torch.equal(v, want[1])
    assert torch.equal(rec, tidx.reconstruct(i.reshape(-1)).reshape(8, 4, 16))


@pytest.mark.parametrize("metric", ["squared_euclidean", "cosine"])
def test_rq_chunked_search_equals_the_parent_loop(data, rq_pair, metric):
    """With no radius, the chunked scan's ids and values are bit for bit
    the parent's loop (cosine and fetch > 128 take it)."""
    x, q = data
    _, tidx = _rq_indexes(x, rq_pair, metric)
    qt = torch.from_numpy(q)
    tables = torch.einsum("qd,skd->qsk", qt, tidx.rq.codebooks)
    qn2 = (qt * qt).sum(-1)
    want = _parent_chunked(lambda c0, c1: _chunk_values(
        _adc_lookup(tables, tidx._codes[c0:c1]), qn2, tidx._row_sqn[c0:c1], metric),
        len(x), 8, 150, 500)
    got = tidx.search(q, k=150, chunk=500)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pq_and_rq_merge_checks(data, pq_pair, rq_pair):
    x, _ = data
    pq = vq_tpu_torch.ProductQuantizer(codebooks=pq_pair[1], device="cpu")
    a = vq_tpu_torch.PQIndex(pq, keep_corpus=True)
    a.add(x[:100])
    b = vq_tpu_torch.PQIndex(pq)
    b.add(x[100:200])
    with pytest.raises(terr.InvalidData, match="rerank corpus"):
        a.merge_from(b)
    with pytest.raises(terr.InvalidData, match="pack_bits"):
        a.merge_from(vq_tpu_torch.PQIndex(pq, packed=False))
    with pytest.raises(terr.InvalidData, match="codebooks"):
        a.merge_from(vq_tpu_torch.PQIndex(vq_tpu_torch.ProductQuantizer(
            codebooks=pq_pair[1] + 1, device="cpu")))
    c = vq_tpu_torch.PQIndex(pq, keep_corpus=True)
    c.add(x[100:200])
    assert a.merge_from(c) == 100 and a.ntotal == 200 and a._corpus.shape[0] == 200
    rq = vq_tpu_torch.ResidualQuantizer(codebooks=rq_pair, device="cpu")
    r = vq_tpu_torch.RQIndex(rq)
    with pytest.raises(terr.InvalidData, match="metric"):
        r.merge_from(vq_tpu_torch.RQIndex(rq, metric="dot"))
    with pytest.raises(terr.InvalidParameter):
        r.merge_from(a)
