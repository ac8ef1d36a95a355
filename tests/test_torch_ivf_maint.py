"""IVF maintenance in ``vq_tpu_torch`` — ``rebalance``, ``remove_ids``,
``merge_from``, ``range_search``, ``search_and_reconstruct`` and the
``_search_core`` / ``_reconstruct_core`` forms of ``IVFFlatIndex``,
``IVFSQIndex``, ``IVFRQIndex`` and ``IVFPQIndex`` (L2, and dot on raw
rows with anisotropic codes) — against the JAX package on the same seeded
numpy inputs (JAX on the CPU, its XLA routes).

Both packages build each index from the same coarse centroids and
codebooks (no seeded training) over a deliberately skewed mixture: one
list holds about half of the 3000 rows, the smallest about 20, and two
centroids lie far from every row, so a rebalance both splits and retires.

Seeded k-means++ cannot replay JAX's threefry stream, so the exact
rebalance cases patch the split's ``lloyd`` in both packages
(``vq_tpu.ivf_flat.lloyd`` and ``vq_tpu_torch.ivf_flat.lloyd``) with a
stub that returns the first k rows of its input: the subsample is
numpy's in both, so the splits, the reassignment (K1's plain version
against JAX's ``assign``) and the moves can be held exactly. One unpatched
seeded rebalance is compared on invariants.

Tolerances:

* ``split``, ``retired``, ``new_nlist``, the lists, the pool layout
  (chains, lengths, ``slot_ids``, ``pos``, the free list, ``stats``) and
  codes: exact. The coarse centroids after a rebalance: exact for
  IVF-Flat, IVF-RQ and IVF-PQ (their members are stored rows, or decoded
  by gathers and one add), within 1e-5 for IVF-SQ (its members are
  decoded as ``lo + c*step``, one fused multiply-add in XLA's CPU
  backend, two roundings here). ``sqn`` / ``cross``: rtol 1e-6 / atol
  1e-5 (fp32 summation order).
* Searches: values within rtol 1e-5 / atol 1e-3 (IVF-PQ 1e-4), ids equal
  at every rank whose value lies farther than that from every other
  value of its row (``assert_probe_parity``).
* ``range_search``: values to the same tolerance; ids equal at every hit
  whose value lies farther than it from the radius and from every other
  value of its row; ``counts`` may differ only by the hits (of either
  package) within the tolerance of the radius. The radii are chosen
  clear of every value, so the counts come out equal. Padding (-1 and
  inf, -inf for dot) is checked in both.
* ``reconstruct`` forms: as the coarse centroids above.

Queries lie off the stored rows, so no value reaches a merge as NaN or
+-0.0 and the order split of R8 (``ROADMAP.md``) does not arise here.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from test_torch_ivf_flat import assert_probe_parity
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)
from vq_tpu.models.pq import ProductQuantizer as JPQ
from vq_tpu.models.pq_anisotropic import AnisotropicProductQuantizer as JAPQ
from vq_tpu.models.rq import ResidualQuantizer as JRQ
from vq_tpu.models.sq import PerDimScalarQuantizer as JSQ
from vq_tpu_torch.models.base import default_device


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_NLIST, _D, _N = 16, 16, 3000
_TOL = {"rtol": 1e-5, "atol": 1e-3}
_PQ_TOL = {"rtol": 1e-5, "atol": 1e-4}
_NORM_TOL = {"rtol": 1e-6, "atol": 1e-5}
_REBALANCED = ("flat", "sq", "rq", "pq", "pq_dot")


def _skewed(seed=81):
    """Zipf-sized clusters around 14 of 16 centroids (the last two far
    from every row), queries near random rows, and the trained parts:
    SQ ranges of the residuals, RQ 4x16 and PQ 4x16 codebooks drawn from
    residual (or raw) rows."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 3.0, (_NLIST, _D))
    w = 1.0 / np.arange(1, _NLIST + 1) ** 1.6
    w[-2:] = 0.0
    lab = rng.choice(_NLIST, _N, p=w / w.sum())
    x = (centres[lab] + rng.normal(0, 1.0, (_N, _D))).astype(np.float32)
    coarse = (centres + rng.normal(0, 0.2, centres.shape)).astype(np.float32)
    coarse[-2:] += 40.0
    q = (x[rng.choice(_N, 12, replace=False)] + rng.normal(0, 0.3, (12, _D))).astype(np.float32)
    near = ((x[:, None, :] - coarse[None]) ** 2).sum(-1).argmin(1)
    res = x - coarse[near]
    pick = rng.choice(_N, 64, replace=False)
    parts = {
        "lo": res.min(0), "hi": res.max(0),
        "rq": np.stack([res[pick[16 * s:16 * s + 16]] * 0.5 ** s for s in range(4)]),
        "pq": res[pick[:16]].reshape(16, 4, 4).transpose(1, 0, 2).copy(),
        "pq_raw": x[pick[16:32]].reshape(16, 4, 4).transpose(1, 0, 2).copy(),
    }
    return x, coarse, q, {k: v.astype(np.float32) for k, v in parts.items()}


@pytest.fixture(scope="module")
def data():
    return _skewed()


def _empty(family, jax_side, coarse, parts):
    """An empty index of ``family`` in one package, from shared arrays."""
    if jax_side:
        m, sq, rq, pq, apq = vq_tpu, JSQ, JRQ, JPQ, JAPQ
    else:
        t = vq_tpu_torch
        m, sq, rq, pq, apq = t, t.PerDimScalarQuantizer, t.ResidualQuantizer, t.ProductQuantizer, \
            t.AnisotropicProductQuantizer
    if family in ("flat", "flat_dot"):
        return m.IVFFlatIndex(coarse, metric="dot" if family == "flat_dot" else "l2")
    if family == "sq":
        return m.IVFSQIndex(coarse, sq(parts["lo"], parts["hi"]))
    if family == "rq":
        return m.IVFRQIndex(coarse, rq(codebooks=parts["rq"]))
    if family == "pq":
        return m.IVFPQIndex(coarse, pq(codebooks=parts["pq"], distance="squared_euclidean"),
                            keep_corpus=True)
    return m.IVFPQIndex(coarse, apq(codebooks=parts["pq_raw"], eta=4.0), by_residual=False,
                        metric="dot")


def _pair(family, data, batches=((0, 2000), (2000, _N))):
    """The family's JAX index and the port's, filled by the same adds."""
    x, coarse, _, parts = data
    jidx, tidx = _empty(family, True, coarse, parts), _empty(family, False, coarse, parts)
    for a, b in batches:
        jidx.add(x[a:b])
        tidx.add(x[a:b])
    return jidx, tidx


def _tol(family):
    return _PQ_TOL if family.startswith("pq") else _TOL


def _payload_names(tidx):
    return list(tidx._pool.specs)


def assert_same_layout(jidx, tidx):
    """Lists and pool layout exactly; payloads: codes and rows exactly,
    norms to ``_NORM_TOL``."""
    jp, tp = jidx._pool, tidx._pool
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    n = jp.n_rows
    assert (tp.n_rows, tp.nlist, tp._tail) == (n, jp.nlist, jp._tail) and tp._free == jp._free
    np.testing.assert_array_equal(tp.lens_h, jp.lens_h)
    np.testing.assert_array_equal(tp._chains_h, jp._chains_h)
    np.testing.assert_array_equal(tp.slot_ids.numpy(), np.asarray(jp.slot_ids))
    np.testing.assert_array_equal(tp.pos.numpy()[:n], np.asarray(jp.pos)[:n])
    assert tp.stats() == jp.stats() and tidx.bucket_stats() == jidx.bucket_stats()
    for name in _payload_names(tidx):  # whole pool tensors: with equal slots, equal rows
        got, want = tp.data[name].numpy(), np.asarray(jp.data[name])
        if name in ("sqn", "cross"):
            np.testing.assert_allclose(got, want, **_NORM_TOL)
        else:
            np.testing.assert_array_equal(got, want)


def assert_search_close(jidx, tidx, q, family, **kw):
    assert_probe_parity(tidx.search(q, **kw), jidx.search(q, **kw), **_tol(family))


# ---------------------------------------------------------------------------
# Rebalance, exactly: the split's lloyd patched in both packages.
# ---------------------------------------------------------------------------


def _stub(to_array):
    """``lloyd``'s stand-in: the first k rows of its input as centroids."""
    return lambda x, k, **_: types.SimpleNamespace(centroids=to_array(x)[:k])


@pytest.fixture(scope="module", params=_REBALANCED)
def rebalanced(request, data):
    """A pair rebalanced alike (stubbed split, ``min_size=30``; IVF-Flat
    in two rounds, the second without ``min_size``), with the two
    summaries."""
    jidx, tidx = _pair(request.param, data)
    before = tidx.bucket_stats()
    rounds = 2 if request.param == "flat" else 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vq_tpu.ivf_flat, "lloyd", _stub(jnp.asarray))
        mp.setattr(vq_tpu_torch.ivf_flat, "lloyd", _stub(torch.as_tensor))
        jinfo = jidx.rebalance(min_size=30, rounds=rounds)
        tinfo = tidx.rebalance(min_size=30, rounds=rounds)
    return request.param, jidx, tidx, jinfo, tinfo, before


def test_rebalance_splits_retires_and_moves_like_jax(rebalanced):
    family, jidx, tidx, jinfo, tinfo, before = rebalanced
    assert tinfo == jinfo and tinfo["split"] >= 2 and tinfo["retired"] >= 3
    assert tidx.nlist == jidx.nlist == tinfo["new_nlist"]
    if family == "sq":
        np.testing.assert_allclose(tidx.coarse.numpy(), np.asarray(jidx.coarse), rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(tidx.coarse.numpy(), np.asarray(jidx.coarse))
    assert_same_layout(jidx, tidx)
    after = tidx.bucket_stats()
    assert after["ntotal"] == _N and after["max"] < before["max"]


def test_search_after_rebalance_matches_jax(rebalanced, data):
    family, jidx, tidx, *_ = rebalanced
    assert_search_close(jidx, tidx, data[2], family, k=10, nprobe=4)


def _radius(tidx, q, dot, nprobe):
    """A radius near the median 5th value of a search, at least 2e-3
    from every value the probe sees, so no count sits on the boundary."""
    vals = tidx.search(q, k=400, nprobe=nprobe)[1].numpy().astype(np.float64)
    r = float(np.median(vals[:, 4]))
    vals = vals[np.isfinite(vals)]
    while np.abs(vals - r).min() <= 2e-3:
        r += -1e-3 if dot else 1e-3
    return r


def assert_range_close(got, want, radius, dot, max_results, tol):
    """The range contract of both results and their agreement, as the
    module docstring states."""
    gi, gv, gc = (np.asarray(a) for a in got)
    wi, wv, wc = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape == (wi.shape[0], max_results)
    assert gi.dtype == np.int32 and gc.dtype == np.int32 and gc.shape == wc.shape
    pad = -np.inf if dot else np.inf
    near = tol["atol"] + tol["rtol"] * abs(radius)
    for r in range(gi.shape[0]):
        rows = []
        for ids, vals, count in ((gi[r], gv[r], gc[r]), (wi[r], wv[r], wc[r])):
            n = int((ids >= 0).sum())
            assert n == min(int(count), max_results) and (ids[:n] >= 0).all()
            assert (vals[n:] == pad).all() and (vals[:n] >= radius if dot else vals[:n] <= radius).all()
            clear = np.abs(vals[:n] - radius) > near
            rows.append((ids[:n][clear], vals[:n][clear], int((~clear).sum())))
        (g_i, g_v, g_near), (w_i, w_v, w_near) = rows
        assert abs(int(gc[r]) - int(wc[r])) <= g_near + w_near
        width = min(g_i.size, w_i.size)
        if max(gc[r], wc[r]) <= max_results:
            assert g_i.size == w_i.size
        assert_probe_parity((g_i[None, :width].astype(np.int32), g_v[None, :width]),
                            (w_i[None, :width], w_v[None, :width]), **tol)


def _check_range(family, jidx, tidx, q, nprobe, max_results):
    dot = family.endswith("dot")
    radius = _radius(tidx, q, dot, nprobe)
    got = tidx.range_search(q, radius, nprobe=nprobe, max_results=max_results)
    want = jidx.range_search(q, radius, nprobe=nprobe, max_results=max_results)
    assert_range_close(got, want, radius, dot, max_results, _tol(family))
    assert int(got[2].sum()) > 0
    if nprobe == 1:
        assert bool((got[0] == -1).any())  # padded past the probed rows
    else:
        assert bool((got[2] > max_results).any())  # truncated to the best hits


_RANGE_CASES = {"nprobe4-truncated": (4, 32), "nprobe1-padded": (1, 2048)}


@pytest.mark.parametrize("case", sorted(_RANGE_CASES))
def test_range_search_matches_jax(rebalanced, data, case):
    """Over chains freed, recycled and relabelled by the rebalance: the
    probe is the search's (K6 for IVF-Flat / IVF-SQ, K7 for IVF-RQ and
    IVF-PQ, their plain versions here)."""
    family, jidx, tidx, *_ = rebalanced
    _check_range(family, jidx, tidx, data[2], *_RANGE_CASES[case])


@pytest.mark.parametrize("case", sorted(_RANGE_CASES))
def test_flat_dot_range_search_matches_jax(data, case):
    """IVF-Flat over dot scores (K6, negated): the radius is a score."""
    jidx, tidx = _pair("flat_dot", data)
    _check_range("flat_dot", jidx, tidx, data[2], *_RANGE_CASES[case])


def test_search_core_and_search_and_reconstruct(rebalanced, data):
    family, jidx, tidx, *_ = rebalanced
    q = data[2]
    fn, arrays = tidx._search_core(10, nprobe=4)
    want_ids, want_d = tidx.search(q, k=10, nprobe=4)
    ids, d = fn(torch.from_numpy(q), *arrays)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)
    ids, d, vecs = tidx.search_and_reconstruct(q, k=10, nprobe=4)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)
    assert torch.equal(vecs.reshape(-1, _D), tidx.reconstruct(ids.reshape(-1).clamp_min(0)))
    j_ids, _, j_vecs = jidx.search_and_reconstruct(q, k=10, nprobe=4)
    same = ids.numpy() == np.asarray(j_ids)
    tol = 1e-5 if family == "sq" else 0.0
    np.testing.assert_allclose(vecs.numpy()[same], np.asarray(j_vecs)[same], rtol=0, atol=tol)
    if family.startswith("pq"):
        fn, arrays = tidx._reconstruct_core()
        jfn, jarrays = jidx._reconstruct_core()
        rows = np.array([0, 5, 1499, 2999, 17])
        got = fn(torch.from_numpy(rows), *arrays)
        assert torch.equal(got, tidx.reconstruct(rows))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jnp.asarray(rows), *jarrays)))


# ---------------------------------------------------------------------------
# Rebalance, seeded and unpatched: invariants.
# ---------------------------------------------------------------------------


def test_seeded_rebalance_invariants(data):
    """Real k-means++ splits (seeded streams differ by design): the rows
    are all kept, no list passes the target where JAX's rebalance gets
    under it, nothing overflows, and a full-probe IVF-Flat search is
    still brute force."""
    x, _, q, _ = data
    jidx, tidx = _pair("flat", data)
    jidx.rebalance(target_max=300, min_size=30, seed=3, rounds=2)
    info = tidx.rebalance(target_max=300, min_size=30, seed=3, rounds=2)
    stats, jstats = tidx.bucket_stats(), jidx.bucket_stats()
    assert tidx.ntotal == jidx.ntotal == _N and info["new_nlist"] == tidx.nlist
    assert stats["overflow_dropped"] == 0 and int(tidx._pool.lens_h.sum()) == _N
    if jstats["max"] <= 300:
        assert stats["max"] <= 300
    ids, d = tidx.search(q, k=10, nprobe=tidx.nlist)
    exact = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    order = np.argsort(exact, axis=1, kind="stable")[:, :10]
    assert_probe_parity((ids, d), (order.astype(np.int32), np.take_along_axis(exact, order, 1)),
                        **_TOL)


# ---------------------------------------------------------------------------
# remove_ids and merge_from.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", _REBALANCED)
def test_remove_ids_and_merge_from_match_jax(family, data):
    """Every 7th row (and a few more) of an index of the first 2000 rows
    removed, then the other 1000 rows merged in from a second index:
    layouts and searches equal JAX's, and the donor is left empty. The
    port's merged index equals the one built by the same two adds."""
    x, q = data[0], data[2]
    ja, ta = _pair(family, data, batches=((0, 2000),))
    jb, tb = _pair(family, data, batches=((2000, _N),))
    ids = np.r_[np.arange(0, 2000, 7), [1, 2, 1999]]
    assert ta.remove_ids(ids) == ja.remove_ids(ids) == np.unique(ids).size
    assert_same_layout(ja, ta)
    assert ta.merge_from(tb) == jb.ntotal == ja.merge_from(jb) == _N - 2000
    assert tb.ntotal == jb.ntotal == 0 and tb._pool is None
    assert_same_layout(ja, ta)
    assert_search_close(ja, ta, q, family, k=10, nprobe=4)
    if family == "pq":
        kept = np.r_[np.setdiff1d(np.arange(2000), ids), np.arange(2000, _N)]
        np.testing.assert_array_equal(ta._corpus.numpy(), x[kept])

    a, b, whole = (_empty(family, False, data[1], data[3]) for _ in range(3))
    a.add(x[:2000])
    b.add(x[2000:])
    a.merge_from(b)
    whole.add(x[:2000])
    whole.add(x[2000:])
    for name in _payload_names(a):
        assert torch.equal(a._pool.to_flat([name])[name], whole._pool.to_flat([name])[name])
    for got, want in zip(a.search(q, k=10, nprobe=4), whole.search(q, k=10, nprobe=4)):
        assert torch.equal(got, want)


def _merge_cases(data):
    """(receiver, donor) builders for each mismatch the merge refuses."""
    x, coarse, _, parts = data
    other = coarse[::-1].copy()
    lo2 = parts["lo"] - 1.0

    def make(m, jax_side):
        sq = JSQ if jax_side else m.PerDimScalarQuantizer
        rq = JRQ if jax_side else m.ResidualQuantizer
        pq = JPQ if jax_side else m.ProductQuantizer
        flat = lambda c=coarse, **kw: m.IVFFlatIndex(c, **kw)  # noqa: E731
        return {
            "type": (flat(), m.IVFSQIndex(coarse, sq(parts["lo"], parts["hi"]))),
            "metric": (flat(), flat(metric="dot")),
            "store_dtype": (flat(), flat(store_dtype="bfloat16")),
            "coarse": (flat(), flat(other)),
            "sq_ranges": (m.IVFSQIndex(coarse, sq(parts["lo"], parts["hi"])),
                          m.IVFSQIndex(coarse, sq(lo2, parts["hi"]))),
            "sq_levels": (m.IVFSQIndex(coarse, sq(parts["lo"], parts["hi"])),
                          m.IVFSQIndex(coarse, sq(parts["lo"], parts["hi"], 16))),
            "rq_codebooks": (m.IVFRQIndex(coarse, rq(codebooks=parts["rq"])),
                             m.IVFRQIndex(coarse, rq(codebooks=parts["rq"] * 2))),
            "pq_codebooks": (m.IVFPQIndex(coarse, pq(codebooks=parts["pq"])),
                             m.IVFPQIndex(coarse, pq(codebooks=parts["pq"] + 1))),
            "pq_residual": (m.IVFPQIndex(coarse, pq(codebooks=parts["pq"])),
                            m.IVFPQIndex(coarse, pq(codebooks=parts["pq"]), by_residual=False)),
            "binary_threshold": (m.IVFBinaryIndex(coarse), m.IVFBinaryIndex(coarse, threshold=0.5)),
            "binary_keep_corpus": (m.IVFBinaryIndex(coarse),
                                   m.IVFBinaryIndex(coarse, keep_corpus=True)),
        }

    return make


_MERGE_CASES = ("type", "metric", "store_dtype", "coarse", "sq_ranges", "sq_levels", "rq_codebooks",
                "pq_codebooks", "pq_residual", "binary_threshold", "binary_keep_corpus")


@pytest.mark.parametrize("case", _MERGE_CASES)
def test_merge_refusals_match_jax(case, data):
    make = _merge_cases(data)
    j_recv, j_donor = make(vq_tpu, True)[case]
    t_recv, t_donor = make(vq_tpu_torch, False)[case]
    with pytest.raises(jerr.VqError) as want:
        j_recv.merge_from(j_donor)
    with pytest.raises(terr.VqError) as got:
        t_recv.merge_from(t_donor)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


_EMPTY_CALLS = {
    "rebalance": lambda i, q: i.rebalance(),
    "remove_ids": lambda i, q: i.remove_ids([0]),
    "range_search": lambda i, q: i.range_search(q, 1.0),
    "search_core": lambda i, q: i._search_core(5),
}


@pytest.mark.parametrize("family", ["flat", "pq"])
@pytest.mark.parametrize("call", sorted(_EMPTY_CALLS))
def test_errors_on_empty_indexes_match_jax(family, call, data):
    _, coarse, q, parts = data
    with pytest.raises(jerr.VqError) as want:
        _EMPTY_CALLS[call](_empty(family, True, coarse, parts), q)
    with pytest.raises(terr.VqError) as got:
        _EMPTY_CALLS[call](_empty(family, False, coarse, parts), q)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_range_search_rejects_max_results_below_one(data):
    jidx, tidx = _pair("flat", data, batches=((0, 2000),))
    for idx, err in ((jidx, jerr.InvalidParameter), (tidx, terr.InvalidParameter)):
        with pytest.raises(err):
            idx.range_search(data[2], 1.0, max_results=0)
