"""Score-aware quantization in the port — ``ops/kmeans_anisotropic.py`` and
``models/pq_anisotropic.py`` — against the JAX package on the same seeded
numpy inputs (JAX on the CPU, where its MIPS search takes the chunked
XLA scan; the port on its plain CPU paths: K4's and K5's plain versions).
Every JAX output is computed once, in the module fixture ``jax_out``, and
the other JAX calls take its shapes, so that they reuse its compiled
programs.

Tolerances:

* ``anisotropic_assign``: codes exact, losses within rtol 1e-5 / atol
  1e-4 (two fp32 products summing in their own orders).
* Warm-started runs, which need no random draws (``pq_encode_anisotropic``
  from given codebooks, ``pq_refine_anisotropic`` at ``iters`` 1 and 2,
  ``anisotropic_pq_loss``): losses within rtol 1e-5, codebooks within
  atol 1e-4, codes equal on at least 99.9% of the rows and every other
  row a float near tie: its float64 loss under the two code rows within
  1e-5 of the larger (the encode near-tie rule, at the row level, since
  coordinate descent carries a flipped code into later subspaces).
* ``eta = 1`` gives the plain PQ codes exactly; zero-norm rows the plain
  L2 codes.
* Seeded training (``lloyd_anisotropic``, ``pq_train_anisotropic``, the
  trained quantizer; the random streams differ by design): the
  anisotropic loss and the reconstruction MSE within 5% of the JAX run's.
* ``mips_adc_search``: ids equal at every rank whose score is unique in
  its row, scores within rtol 1e-5 / atol 1e-5 (the same fp32 table sums
  in the same order), -1 / -inf padding equal.
* Named splits: R1 (the reference's argmin lets a NaN score win; the
  port's int2 rule never does) and R8 (the reference's top-k on scores
  returns NaN scores as the best; the port's merge never returns them).
"""

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu.models.pq as jpq
import vq_tpu.models.pq_anisotropic as jpa
import vq_tpu.ops.kmeans_anisotropic as jka
import vq_tpu.utils.serialize as jser
import vq_tpu_torch
import vq_tpu_torch.errors as terr
import vq_tpu_torch.models.pq_anisotropic as tpa
import vq_tpu_torch.ops.kmeans_anisotropic as tka
from test_torch_pq import assert_search_parity, one_torch_thread  # noqa: F401  (an autouse fixture)
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_N, _D, _M, _K = 2000, 32, 4, 16
_ETA = jka.anisotropic_eta(0.2, _D)
_TIE_RTOL = 1e-5
_MIPS_TOL = {"rtol": 1e-5, "atol": 1e-5}


def _mips_data(seed=20):
    """Rows of varied norms (MIPS cares about them), random codebooks,
    centroids and queries."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(_N, _D)) * rng.uniform(0.2, 3.0, (_N, 1))).astype(np.float32)
    cb = rng.normal(size=(_M, _K, _D // _M)).astype(np.float32)
    cents = rng.normal(size=(24, _D)).astype(np.float32)
    q = rng.normal(size=(7, _D)).astype(np.float32)
    return x, cb, cents, q


@pytest.fixture(scope="module")
def jax_out():
    x, cb, cents, q = _mips_data()
    out = {"x": x, "cb": cb, "cents": cents, "q": q}
    out["assign"] = [np.asarray(a) for a in jka.anisotropic_assign(x, cents, _ETA)]
    out["encode"] = np.asarray(jpa.pq_encode_anisotropic(x, cb, _ETA))
    out["loss"] = jpa.anisotropic_pq_loss(x, cb, out["encode"], _ETA)
    for it in (1, 2):
        out[("refine", it)] = [np.asarray(a) for a in
                               jpa.pq_refine_anisotropic(x, cb, eta=_ETA, iters=it)]
    codes = out["encode"].astype(np.uint8)
    out["codes"] = codes
    for name, kw in _SEARCHES.items():
        out[("mips", name)] = [np.asarray(a) for a in jpa.mips_adc_search(
            q, cb, codes[:kw.get("rows", _N)], k=kw["k"], chunk=kw.get("chunk", 262_144))]
    out["lloyd"] = jka.lloyd_anisotropic(x, 24, max_iters=10, seed=1)
    out["trained"] = vq_tpu.AnisotropicProductQuantizer(x, _M, _K, max_iters=8, seed=3,
                                                        refine_iters=2)
    return out


def _row_losses(x, cb, codes, eta):
    """float64 anisotropic loss of each row under ``codes``."""
    x = np.asarray(x, np.float64)
    cb = np.asarray(cb, np.float64)
    rec = cb[np.arange(cb.shape[0])[None, :], np.asarray(codes, np.int64)].reshape(x.shape)
    r = x - rec
    norm = np.linalg.norm(x, axis=1)
    par = np.where(norm > 0, (r * x).sum(1) / np.where(norm > 0, norm, 1.0), 0.0)
    return (r * r).sum(1) + (eta - 1.0) * par * par


def assert_aniso_codes(got, want, x, cb, eta):
    """At least 99.9% of the rows equal, every other row a float near tie
    of its loss (module docstring)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    rows = np.nonzero((got != want).any(1))[0]
    assert rows.size <= 0.001 * got.shape[0], rows.size
    if rows.size:
        lg = _row_losses(x[rows], cb, got[rows], eta)
        lw = _row_losses(x[rows], cb, want[rows], eta)
        assert np.all(np.abs(lg - lw) <= _TIE_RTOL * np.maximum(np.abs(lw), 1.0)), (lg, lw)


# ---------------------------------------------------------------------------
# ops/kmeans_anisotropic.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,dim", [(0.0, 32), (0.2, 32), (0.2, 2), (0.5, 128),
                                           (0.999, 8), (1.0, 8), (-0.1, 8)])
def test_anisotropic_eta_matches_jax(threshold, dim):
    try:
        want = jka.anisotropic_eta(threshold, dim)
    except jerr.VqError as e:
        with pytest.raises(terr.VqError) as got:
            tka.anisotropic_eta(threshold, dim)
        assert type(got.value).__name__ == type(e).__name__ and str(got.value) == str(e)
        return
    assert tka.anisotropic_eta(threshold, dim) == want


def test_anisotropic_assign_matches_jax(jax_out):
    codes, losses = tka.anisotropic_assign(jax_out["x"], jax_out["cents"], _ETA)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), jax_out["assign"][0])
    np.testing.assert_allclose(losses.numpy(), jax_out["assign"][1], rtol=1e-5, atol=1e-4)


def test_anisotropic_assign_nan_never_wins_R1(jax_out):
    """R1: centroid 0 scores NaN for every row. The reference's argmin
    picks it; the port's int2 rule picks the best finite centroid: its
    own choice among the other centroids."""
    x, cents = jax_out["x"], jax_out["cents"].copy()
    cents[0, 3] = np.nan
    jc = np.asarray(jka.anisotropic_assign(x, cents, _ETA)[0])
    assert (jc == 0).all()  # the split: NaN wins in the reference
    tc, tl = tka.anisotropic_assign(x, cents, _ETA)
    np.testing.assert_array_equal(tc.numpy(), tka.anisotropic_assign(x, cents[1:], _ETA)[0] + 1)
    assert bool(torch.isfinite(tl).all())


def test_lloyd_anisotropic_seeded_objective_matches_jax(jax_out):
    got = tka.lloyd_anisotropic(jax_out["x"], 24, max_iters=10, seed=1)
    want = jax_out["lloyd"]
    assert got.centroids.shape == (24, _D) and got.assignments.dtype == torch.int32
    assert abs(float(got.inertia) - float(want.inertia)) <= 0.05 * float(want.inertia)
    # its inertia is its own loss at its own assignment
    codes, losses = tka.anisotropic_assign(jax_out["x"], got.centroids, _ETA)
    assert torch.equal(codes, got.assignments)
    assert float(got.inertia) == pytest.approx(float(losses.sum()), rel=1e-6)


def test_lloyd_anisotropic_eta_one_is_plain_lloyd_objective(jax_out):
    x = jax_out["x"][:500]
    res = tka.lloyd_anisotropic(x, 8, max_iters=5, seed=2, eta=1.0)
    sq = ((x[:, None, :] - res.centroids.numpy()[None]) ** 2).sum(-1).min(1)
    assert float(res.inertia) == pytest.approx(float(sq.sum()), rel=1e-5)


# ---------------------------------------------------------------------------
# models/pq_anisotropic.py: warm-started runs.
# ---------------------------------------------------------------------------


def test_encode_matches_jax(jax_out):
    x, cb = jax_out["x"], jax_out["cb"]
    got = tpa.pq_encode_anisotropic(torch.from_numpy(x), torch.from_numpy(cb), _ETA)
    assert got.dtype == torch.int32 and got.shape == (_N, _M)
    assert_aniso_codes(got.numpy(), jax_out["encode"], x, cb, _ETA)
    loss = tpa.anisotropic_pq_loss(x, cb, got, _ETA)
    assert loss == pytest.approx(jax_out["loss"], rel=1e-5)


def test_encode_eta_one_is_plain_pq(jax_out):
    x, cb = jax_out["x"], jax_out["cb"]
    got = tpa.pq_encode_anisotropic(x, cb, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpq.pq_encode(x, cb, "euclidean")))
    assert torch.equal(got, vq_tpu_torch.pq_encode(x, cb, "euclidean"))


def test_zero_norm_rows_fall_back_to_l2(jax_out):
    x, cb = jax_out["x"].copy(), jax_out["cb"]
    x[::4] = 0.0
    got = tpa.pq_encode_anisotropic(x, cb, 50.0).numpy()
    plain = vq_tpu_torch.pq_encode(x, cb, "euclidean").numpy()
    np.testing.assert_array_equal(got[::4], plain[::4])
    assert_aniso_codes(got, np.asarray(jpa.pq_encode_anisotropic(x, cb, 50.0)), x, cb, 50.0)


@pytest.mark.parametrize("iters", [1, 2])
def test_refine_matches_jax(jax_out, iters):
    x, cb = jax_out["x"], jax_out["cb"]
    jcb, jcodes, jloss = jax_out[("refine", iters)]
    tcb, tcodes, tloss = tpa.pq_refine_anisotropic(x, cb, eta=_ETA, iters=iters)
    assert tcb.shape == cb.shape and tcodes.dtype == torch.int32
    np.testing.assert_allclose(tcb.numpy(), jcb, atol=1e-4, rtol=0)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert_aniso_codes(tcodes.numpy(), jcodes, x, jcb, _ETA)


def test_refine_loss_is_non_increasing(jax_out):
    x, cb = jax_out["x"][:800], jax_out["cb"]
    losses = [float(tpa.pq_refine_anisotropic(x, cb, eta=_ETA, iters=i)[2]) for i in (0, 1, 3)]
    assert losses[0] >= losses[1] >= losses[2], losses


# ---------------------------------------------------------------------------
# Seeded training and the quantizer.
# ---------------------------------------------------------------------------


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def test_trained_quantizer_matches_jax(jax_out):
    """Seeded construction (K3 init then two refine rounds) against the
    JAX package's on loss and MSE; then ``pq_train_anisotropic`` with the
    same arguments gives the quantizer's codebooks."""
    x, want = jax_out["x"], jax_out["trained"]
    got = vq_tpu_torch.AnisotropicProductQuantizer(x, _M, _K, max_iters=8, seed=3, refine_iters=2)
    assert got.eta == want.eta == _ETA
    codes = got.encode(x)
    assert codes.dtype == torch.uint8 and codes.shape == (_N, _M)
    jcodes = np.asarray(want.encode(x))
    l_t = tpa.anisotropic_pq_loss(x, got.codebooks, codes, _ETA)
    l_j = jpa.anisotropic_pq_loss(x, want.codebooks, jcodes, _ETA)
    assert abs(l_t - l_j) <= 0.05 * l_j, (l_t, l_j)
    m_t, m_j = _mse(got.decode(codes).numpy(), x), _mse(want.decode(jcodes), x)
    assert abs(m_t - m_j) <= 0.05 * m_j, (m_t, m_j)
    cb = tpa.pq_train_anisotropic(x, _M, _K, max_iters=8, seed=3, refine_iters=2)
    assert torch.equal(cb, got.codebooks)


def test_restored_quantizer_matches_jax(jax_out):
    want = vq_tpu.AnisotropicProductQuantizer(codebooks=jax_out["cb"], threshold=0.2)
    got = vq_tpu_torch.AnisotropicProductQuantizer(codebooks=jax_out["cb"], threshold=0.2)
    assert got.eta == want.eta and got.dim == want.dim == _D
    assert repr(got).startswith(repr(want)[:-1])
    x = jax_out["x"]
    assert_aniso_codes(got.encode(x).numpy(), np.asarray(want.encode(x)), x, jax_out["cb"], _ETA)
    one = got.encode(x[0])
    assert one.shape == (_M,) and one.dtype == torch.uint8
    ids, scores = got.mips_search(jax_out["q"], jax_out["codes"], k=10)
    assert_search_parity((ids, scores), jax_out[("mips", "k10")], **_MIPS_TOL)


# ---------------------------------------------------------------------------
# mips_adc_search.
# ---------------------------------------------------------------------------


# k, rows searched, chunk: K5's route (k <= 128); the chunked route
# (k > 128, three chunks); a corpus shorter than k (padding).
_SEARCHES = {"k10": {"k": 10}, "k150": {"k": 150, "chunk": 700}, "short": {"k": 10, "rows": 5}}


@pytest.mark.parametrize("name", sorted(_SEARCHES))
def test_mips_search_matches_jax(jax_out, name):
    kw = _SEARCHES[name]
    codes = jax_out["codes"][:kw.get("rows", _N)]
    got = tpa.mips_adc_search(jax_out["q"], jax_out["cb"], codes, k=kw["k"],
                              chunk=kw.get("chunk", 262_144))
    want = jax_out[("mips", name)]
    assert got[0].dtype == torch.int32 and got[0].shape == (7, kw["k"])
    assert_search_parity(got, want, **_MIPS_TOL)
    if name == "short":
        assert (got[0][:, 5:] == -1).all() and torch.isneginf(got[1][:, 5:]).all()


@pytest.mark.parametrize("name", ["k10", "k150"], ids=["k5_route", "chunked_route"])
def test_mips_search_nan_and_zero_scores_R8(jax_out, name):
    """R8: query 2 holds a NaN, so every score of its row is NaN (a NaN
    table entry reaches every row through the reference's one-hot lookup
    as well as through the port's gathers). ``lax.top_k`` returns those
    NaN scores as the best, under ids 0, 1, 2, ...; the port's merge
    (``_smallest``'s order, NaN never wins) returns no row: -1 / -inf.
    Query 1 is zero, so every score is +0.0: both return ids 0, 1, 2, ...
    The other rows agree."""
    k, chunk = _SEARCHES[name]["k"], _SEARCHES[name].get("chunk", 262_144)
    q = jax_out["q"].copy()
    q[1] = 0.0
    q[2, 5] = np.nan
    ji, js = (np.asarray(a) for a in jpa.mips_adc_search(q, jax_out["cb"], jax_out["codes"], k=k,
                                                           chunk=chunk))
    assert np.isnan(js[2]).all() and (ji[2] >= 0).all()  # the split
    ti, ts = tpa.mips_adc_search(q, jax_out["cb"], jax_out["codes"], k=k, chunk=chunk)
    assert (ti[2] == -1).all() and torch.isneginf(ts[2]).all()
    np.testing.assert_array_equal(ti[1].numpy(), np.arange(k))
    np.testing.assert_array_equal(ji[1], np.arange(k))
    rows = [0, 1, 3, 4, 5, 6]
    assert_search_parity((ti[rows], ts[rows]), (ji[rows], js[rows]), **_MIPS_TOL)


# ---------------------------------------------------------------------------
# Checkpoints, errors, the card default.
# ---------------------------------------------------------------------------


def test_checkpoints_load_across_packages(jax_out, tmp_path):
    x = jax_out["x"]
    jq = vq_tpu.AnisotropicProductQuantizer(codebooks=jax_out["cb"], eta=3.5)
    loaded = vq_tpu_torch.load(jser.save(str(tmp_path / "jax"), jq))
    assert isinstance(loaded, vq_tpu_torch.AnisotropicProductQuantizer) and loaded.eta == 3.5
    assert_aniso_codes(loaded.encode(x).numpy(), np.asarray(jq.encode(x)), x, jax_out["cb"], 3.5)
    back = jser.load(vq_tpu_torch.save(str(tmp_path / "port"), loaded))
    assert isinstance(back, vq_tpu.AnisotropicProductQuantizer) and back.eta == 3.5
    np.testing.assert_array_equal(np.asarray(back.codebooks), jax_out["cb"])


_BAD = {
    "encode_eta": lambda p, x, cb: p.pq_encode_anisotropic(x, cb, 0.5),
    "encode_dim": lambda p, x, cb: p.pq_encode_anisotropic(x[:, :30], cb, 2.0),
    "refine_eta": lambda p, x, cb: p.pq_refine_anisotropic(x, cb, eta=0.9),
    "refine_threshold": lambda p, x, cb: p.pq_refine_anisotropic(x, cb, threshold=1.5),
    "refine_dim": lambda p, x, cb: p.pq_refine_anisotropic(x[:, :24], cb),
    "loss_dim": lambda p, x, cb: p.anisotropic_pq_loss(x[:, :30], cb, x[:, :4], 2.0),
    "mips_dim": lambda p, x, cb: p.mips_adc_search(x[:2, :30], cb, np.zeros((4, 4), np.uint8)),
    "restore_eta": lambda p, x, cb: p.AnisotropicProductQuantizer(codebooks=cb, eta=0.5),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(jax_out, case):
    x, cb = jax_out["x"][:50], jax_out["cb"]
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](jpa, x, cb)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](tpa, x, cb)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


_X = np.random.default_rng(21).random((64, 8), dtype=np.float32)
_CB = np.random.default_rng(22).random((2, 4, 4), dtype=np.float32)
_ENTRY_POINTS = {
    "lloyd_anisotropic": lambda: vq_tpu_torch.lloyd_anisotropic(_X, 4, max_iters=1),
    "anisotropic_assign": lambda: vq_tpu_torch.anisotropic_assign(_X, _X[:4], 2.0),
    "pq_encode_anisotropic": lambda: vq_tpu_torch.pq_encode_anisotropic(_X, _CB, 2.0),
    "pq_train_anisotropic": lambda: vq_tpu_torch.pq_train_anisotropic(_X, 2, 4, max_iters=1,
                                                                      refine_iters=1),
    "mips_adc_search": lambda: vq_tpu_torch.mips_adc_search(_X, _CB, np.zeros((5, 2), np.uint8)),
    "AnisotropicProductQuantizer": lambda: vq_tpu_torch.AnisotropicProductQuantizer(codebooks=_CB),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Numpy input and no ``device`` go to ``cuda``: with no card, that
    raises rather than running on the CPU."""
    with default_device(None):
        with pytest.raises(terr.InvalidParameter, match="no CUDA device"):
            _ENTRY_POINTS[entry]()
    assert _ENTRY_POINTS[entry]() is not None  # the module's CPU default


def test_cpu_tensors_never_launch(jax_out):
    fns = (ck.pq_encode_fused, ck.adc_scan_topk_fused, ck.adc_lookup_fused)
    before = [f.launches for f in fns]
    codes = tpa.pq_encode_anisotropic(jax_out["x"][:100], jax_out["cb"], _ETA)
    tpa.mips_adc_search(jax_out["q"], jax_out["cb"], codes, k=5)
    tpa.mips_adc_search(jax_out["q"], jax_out["cb"], codes, k=150, chunk=30)
    assert [f.launches for f in fns] == before
