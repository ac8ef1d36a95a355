"""Residual quantization in the port — ``models/rq.py``, ``RQIndex`` and
``IVFRQIndex`` — against the JAX package on the same seeded numpy inputs
(JAX on the CPU: its RQ search on the chunked XLA scan, its IVF-RQ search
on the XLA route and on the Pallas K7 route in interpret mode), and the
card default of the port's entry points.

Tolerances:

* Greedy and beam encodes: rows identical except where, at the first
  stage the two differ, the two prefixes' squared residuals (float64)
  are within 1e-5 of the residual's scale — a near tie, where the two
  packages' fp32 summation orders may pick differently; for beam search
  a near tie of the final costs also counts.
* ``rq_decode`` and ``reconstruct``: exact (the same gathers added in the
  same order).
* ``rq_refine_joint`` from the same start: after one round, MSE within
  1e-3 relative (1e-2 after two, whose codes differ at near ties), and
  codebooks within rtol 1e-3 / atol 1e-3 once each stage's
  mean codeword is taken out, and the sum of those means within 1e-3.
  A constant moved from one stage's codewords to another's leaves every
  reconstruction unchanged, so the normal equations barely fix it (only
  the ridge does), and the two packages' fp32 Cholesky solves drift
  along it by ~1e-2 while the rest agrees to ~1e-6; a second round's
  beam encode then flips codes at near ties. Seeded training (random
  streams differ by design): MSE within 5%.
* Searches (JAX indexes carried across with their codes): values within
  rtol 1e-5 / atol 1e-3 (distances assembled as ``||q||^2 - 2 q.y +
  ||y||^2``), ids equal wherever a value stands apart from the others of
  its row by more than that (``assert_probe_parity``). Stored norms
  ``||y||^2`` and ``c.y``: rtol 1e-5 / atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu.models.rq as jrq
import vq_tpu_torch
import vq_tpu_torch.errors as terr
import vq_tpu_torch.models.rq as trq
from test_torch_ivf_flat import _clustered, _queries, assert_probe_parity
from vq_tpu.ivf_flat import _ivf_rq_search_jit
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.models.base import default_device, resolve_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_TIE_RTOL = 1e-5
_NORM_TOL = {"rtol": 1e-5, "atol": 1e-4}


def _data(seed=50, n=2000, d=16):
    """Correlated rows (a low-rank mix plus noise), as RQ is used for."""
    rng = np.random.default_rng(seed)
    latent = rng.normal(0, 1, (n, 6)).astype(np.float32)
    mix = rng.normal(0, 1, (6, d)).astype(np.float32)
    return (latent @ mix + rng.normal(0, 0.1, (n, d))).astype(np.float32)


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def _prefix_cost(x, cbs, codes, upto):
    rec = sum(cbs[t, codes[t]].astype(np.float64) for t in range(upto + 1))
    return float(((x.astype(np.float64) - rec) ** 2).sum())


def assert_rq_codes_near_ties(got, want, x, cbs):
    """Rows equal except at float64-verified near ties (see the module
    docstring)."""
    got, want, cbs = np.asarray(got, np.int64), np.asarray(want, np.int64), np.asarray(cbs)
    stages = cbs.shape[0]
    for r in np.nonzero((got != want).any(1))[0]:
        s = int(np.nonzero(got[r] != want[r])[0][0])
        scale = float((x[r].astype(np.float64) ** 2).sum()) + 1.0
        tol = _TIE_RTOL * scale
        at_s = abs(_prefix_cost(x[r], cbs, got[r], s) - _prefix_cost(x[r], cbs, want[r], s))
        final = abs(_prefix_cost(x[r], cbs, got[r], stages - 1)
                    - _prefix_cost(x[r], cbs, want[r], stages - 1))
        assert min(at_s, final) <= tol, (r, s, at_s, final)


@pytest.fixture(scope="module")
def trained():
    x = _data()
    jq = vq_tpu.ResidualQuantizer(x[:1500], 4, 32, max_iters=6, seed=3)
    return x, np.array(jq.codebooks)


# ---------------------------------------------------------------------------
# models/rq.py.
# ---------------------------------------------------------------------------


# (stages, k): u8 codes, k not a power of two, i32 codes (k > 256).
_ENCODE_SHAPES = [(4, 32), (3, 100), (2, 300)]


@pytest.mark.parametrize("shape", _ENCODE_SHAPES, ids=lambda c: "S%d-k%d" % c)
def test_greedy_encode_matches_jax(shape):
    stages, k = shape
    x = _data(seed=51 + k)
    cbs = np.array(jrq.rq_train(x[:1500], stages, k, max_iters=4, seed=2))
    want = np.asarray(jrq.rq_encode(x, cbs))
    got = trq.rq_encode(torch.from_numpy(x), torch.from_numpy(cbs))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert (got.numpy() == want).mean() >= 0.999
    assert_rq_codes_near_ties(got.numpy(), want, x, cbs)


@pytest.mark.parametrize("beam", [2, 4])
@pytest.mark.parametrize("block_rows", [4096, 333])
def test_beam_encode_matches_jax(trained, beam, block_rows):
    x, cbs = trained
    want = np.asarray(jrq.rq_encode(x, cbs, beam=beam, block_rows=block_rows))
    got = trq.rq_encode(torch.from_numpy(x), torch.from_numpy(cbs), beam=beam,
                        block_rows=block_rows).numpy()
    assert (got == want).mean() >= 0.999
    assert_rq_codes_near_ties(got, want, x, cbs)


def test_beam_lowers_mse_and_beam1_is_greedy(trained):
    x, cbs = trained
    tx, tc = torch.from_numpy(x), torch.from_numpy(cbs)
    greedy = trq.rq_encode(tx, tc)
    assert torch.equal(trq.rq_encode(tx, tc, beam=1), greedy)
    mse_g = _mse(trq.rq_decode(greedy, tc), x)
    mse_b = _mse(trq.rq_decode(trq.rq_encode(tx, tc, beam=4), tc), x)
    assert mse_b < mse_g


@pytest.mark.parametrize("k", [32, 300])
def test_decode_matches_jax_exactly(k):
    rng = np.random.default_rng(52)
    cbs = rng.normal(0, 1, (3, k, 16)).astype(np.float32)
    codes = rng.integers(0, k, (500, 3)).astype(np.uint8 if k <= 256 else np.int32)
    want = np.asarray(jrq.rq_decode(codes, cbs))
    np.testing.assert_array_equal(trq.rq_decode(torch.from_numpy(codes), torch.from_numpy(cbs)).numpy(),
                                  want)


def test_solve_codebooks_matches_jax(trained):
    x, cbs = trained
    codes = np.asarray(jrq.rq_encode(x, cbs)).astype(np.int32)
    want = np.asarray(jrq._rq_solve_codebooks_jit(jnp.asarray(x), jnp.asarray(codes), 32, 512, 1e-5))
    got = trq._solve_codebooks(torch.from_numpy(x), torch.from_numpy(codes), 32, 512, 1e-5)
    rec_w = np.asarray(jrq.rq_decode(codes, want))
    rec_g = trq.rq_decode(torch.from_numpy(codes), got).numpy()
    assert abs(_mse(rec_g, x) - _mse(rec_w, x)) <= 1e-4 * _mse(rec_w, x)
    np.testing.assert_allclose(rec_g, rec_w, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("iters", [1, 2])
def test_refine_joint_matches_jax(trained, iters):
    x, cbs = trained
    want = np.asarray(jrq.rq_refine_joint(x, cbs, iters=iters, beam=4))
    got = trq.rq_refine_joint(torch.from_numpy(x), torch.from_numpy(cbs), iters=iters, beam=4)
    if iters == 1:
        g, w = got.numpy(), want
        np.testing.assert_allclose(g - g.mean(1, keepdims=True), w - w.mean(1, keepdims=True),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(g.mean(1).sum(0), w.mean(1).sum(0), rtol=1e-3, atol=1e-3)
    mse_w = _mse(np.asarray(jrq.rq_decode(jrq.rq_encode(x, want), want)), x)
    tx = torch.from_numpy(x)
    mse_g = _mse(trq.rq_decode(trq.rq_encode(tx, got), got).numpy(), x)
    assert abs(mse_g - mse_w) <= (1e-3 if iters == 1 else 1e-2) * mse_w, (mse_g, mse_w)
    mse_0 = _mse(trq.rq_decode(trq.rq_encode(tx, torch.from_numpy(cbs)), torch.from_numpy(cbs)), x)
    assert mse_g < mse_0


@pytest.mark.parametrize("shape", [(4, 32), (2, 64)], ids=lambda c: "S%d-k%d" % c)
def test_seeded_train_mse_matches_jax(shape):
    """At the shapes of ``trained``'s data and iterations (2000 x 16, six
    Lloyd iterations a stage), so that the JAX package's encode and decode
    reuse the programs the tests above compiled."""
    stages, k = shape
    x = _data(seed=53)
    jq = vq_tpu.ResidualQuantizer(x, stages, k, max_iters=6, seed=4)
    tq = vq_tpu_torch.ResidualQuantizer(x, stages, k, max_iters=6, seed=4)
    assert tq.codebooks.shape == (stages, k, 16) and tq.device == torch.device("cpu")
    mse_j = _mse(jq.decode(jq.encode(x)), x)
    mse_t = _mse(tq.decode(tq.encode(x)).numpy(), x)
    assert abs(mse_t - mse_j) <= 0.05 * mse_j, (mse_t, mse_j)


def test_joint_iters_quantizer_matches_jax():
    x = _data(seed=54, n=1500)
    jq = vq_tpu.ResidualQuantizer(x, 3, 32, max_iters=6, seed=5, joint_iters=2, beam=4)
    tq = vq_tpu_torch.ResidualQuantizer(x, 3, 32, max_iters=6, seed=5, joint_iters=2, beam=4)
    plain = vq_tpu_torch.ResidualQuantizer(x, 3, 32, max_iters=6, seed=5)
    mse_j = _mse(jq.decode(jq.encode(x)), x)
    mse_t = _mse(tq.decode(tq.encode(x)).numpy(), x)
    assert abs(mse_t - mse_j) <= 0.05 * mse_j, (mse_t, mse_j)
    assert mse_t < _mse(plain.decode(plain.encode(x)).numpy(), x)


def test_quantizer_surface_matches_jax(trained):
    x, cbs = trained
    jq, tq = vq_tpu.ResidualQuantizer(codebooks=cbs), vq_tpu_torch.ResidualQuantizer(codebooks=cbs)
    assert repr(tq) == repr(jq)
    codes = tq.encode(x[:40])
    assert codes.dtype == torch.uint8 and tuple(tq.encode(x[0]).shape) == (4,)
    np.testing.assert_array_equal(tq.decode(codes).numpy(), np.asarray(jq.decode(codes.numpy())))
    np.testing.assert_array_equal(tq.quantize(x[:40]).numpy(), np.asarray(jq.quantize(x[:40])))
    assert tq.dequantize(tq.quantize(x[:3])).dtype == torch.float32


_BAD = {
    "stages_zero": lambda M: M.models.rq.rq_train(np.ones((40, 4), np.float32), 0, 4),
    "k_above_n": lambda M: M.models.rq.rq_train(np.ones((4, 4), np.float32), 2, 8),
    "encode_dim": lambda M: M.models.rq.rq_encode(np.ones((3, 5), np.float32), np.ones((2, 4, 4), np.float32)),
    "decode_width": lambda M: M.models.rq.rq_decode(np.zeros((3, 3), np.int32), np.ones((2, 4, 4), np.float32)),
    "codebooks_2d": lambda M: M.ResidualQuantizer(codebooks=np.ones((4, 4), np.float32)),
    "no_data": lambda M: M.ResidualQuantizer(num_stages=2, num_centroids=4),
    "refine_dim": lambda M: M.models.rq.rq_refine_joint(np.ones((40, 5), np.float32),
                                                        np.ones((2, 4, 4), np.float32)),
    "index_metric": lambda M: M.RQIndex(M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32)),
                                        metric="manhattan"),
    "index_beam": lambda M: M.RQIndex(M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32)), beam=0),
    "index_quantizer": lambda M: M.RQIndex("not an rq"),
    "index_empty": lambda M: M.RQIndex(M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32))).search(
        np.ones((2, 4), np.float32)),
    "index_rerank": lambda M: _added(M).search(np.ones((2, 4), np.float32), rerank=5),
    "index_query_dim": lambda M: _added(M).search(np.ones((2, 5), np.float32)),
    "ivf_quantizer": lambda M: M.IVFRQIndex(np.ones((3, 4), np.float32), "not an rq"),
    "ivf_dim": lambda M: M.IVFRQIndex(np.ones((3, 5), np.float32),
                                      M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32))),
    "ivf_beam": lambda M: M.IVFRQIndex(np.ones((3, 4), np.float32),
                                       M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32)), beam=0),
    "ivf_metric": lambda M: M.IVFRQIndex(np.ones((3, 4), np.float32),
                                         M.ResidualQuantizer(codebooks=np.ones((2, 4, 4), np.float32)),
                                         metric="cosine"),
}


def _added(M):
    cbs = np.random.default_rng(55).random((2, 4, 4), dtype=np.float32)
    idx = M.RQIndex(M.ResidualQuantizer(codebooks=cbs))
    idx.add(np.random.default_rng(56).random((20, 4), dtype=np.float32))
    return idx


@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(case):
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](vq_tpu)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](vq_tpu_torch)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# RQIndex: a JAX index carried across with its codes.
# ---------------------------------------------------------------------------


def _rq_index_state(jidx):
    arrays = {"codebooks": np.asarray(jidx.rq.codebooks), "codes": np.asarray(jidx._codes),
              "row_sqn": np.asarray(jidx._row_sqn)}
    if jidx._corpus is not None:
        arrays["corpus"] = np.asarray(jidx._corpus)
    return "rq_index", {"metric": jidx.metric, "keep_corpus": jidx.keep_corpus,
                        "beam": jidx.beam}, arrays


@pytest.fixture(scope="module", params=["squared_euclidean", "euclidean", "cosine", "dot"])
def rq_pair(request, trained):
    x, cbs = trained
    q = _queries(x, seed=57, nq=7)
    jidx = vq_tpu.RQIndex(vq_tpu.ResidualQuantizer(codebooks=cbs), metric=request.param,
                          keep_corpus=True)
    tadd = vq_tpu_torch.RQIndex(vq_tpu_torch.ResidualQuantizer(codebooks=cbs),
                                metric=request.param, keep_corpus=True)
    for part in (x[:1200], x[1200:]):
        jidx.add(part)
        tadd.add(part)
    return jidx, from_state(*_rq_index_state(jidx)), tadd, x, q


def test_rqindex_add_matches_jax(rq_pair):
    jidx, _, tadd, x, _ = rq_pair
    assert tadd.ntotal == jidx.ntotal and tadd._codes.dtype == torch.uint8
    assert_rq_codes_near_ties(tadd._codes.numpy(), np.asarray(jidx._codes), x,
                              np.asarray(jidx.rq.codebooks))
    same = (tadd._codes.numpy() == np.asarray(jidx._codes)).all(1)
    np.testing.assert_allclose(tadd._row_sqn.numpy()[same], np.asarray(jidx._row_sqn)[same],
                               **_NORM_TOL)
    assert repr(tadd) == repr(jidx)


# (k, rerank, chunk): K5 route; rerank past 128 and fetch past 128 (the
# chunked scan over K8); a small chunk (several chunks merged); rerank on
# the K5 route.
_SEARCHES = {"k10": (10, 0, 262_144), "rerank200": (10, 200, 262_144), "k150": (150, 0, 262_144),
             "chunk700": (10, 0, 700), "rerank50": (5, 50, 262_144)}


@pytest.mark.parametrize("search", sorted(_SEARCHES))
def test_rqindex_search_matches_jax(rq_pair, search):
    jidx, tidx, _, _, q = rq_pair
    k, rerank, chunk = _SEARCHES[search]
    got = tidx.search(q, k=k, rerank=rerank, chunk=chunk)
    want = jidx.search(q, k=k, rerank=rerank, chunk=chunk)
    assert_probe_parity(got, want)
    if jidx.metric == "dot":
        assert bool((got[1][:, :-1] >= got[1][:, 1:]).all())


def test_rqindex_reconstruct_remove_merge_match_jax(rq_pair):
    jidx, tidx, _, x, q = rq_pair
    ids = np.array([0, 5, 1999, 1200])
    np.testing.assert_array_equal(tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids)))
    jq, tq = jidx.rq, tidx.rq
    ja, jb = (vq_tpu.RQIndex(jq, metric=jidx.metric, keep_corpus=True) for _ in range(2))
    ta, tb = (vq_tpu_torch.RQIndex(tq, metric=jidx.metric, keep_corpus=True) for _ in range(2))
    for a, b in ((ja, jb), (ta, tb)):
        a.add(x[:900])
        b.add(x[900:1500])
        assert a.remove_ids([0, 4, 4, 899]) == 3
        assert a.merge_from(b) == 600 and b.ntotal == 0
    assert ta.ntotal == ja.ntotal == 1497
    assert_probe_parity(ta.search(q, k=10, rerank=20), ja.search(q, k=10, rerank=20))


def test_rqindex_checkpoints_load_across_packages(rq_pair, tmp_path):
    jidx, tidx, _, _, q = rq_pair
    port_of_jax = vq_tpu_torch.RQIndex.load(jidx.save(str(tmp_path / "jax_rq")))
    assert repr(port_of_jax) == repr(jidx) and torch.equal(port_of_jax._codes, tidx._codes)
    assert_probe_parity(port_of_jax.search(q, k=10), jidx.search(q, k=10))
    jax_of_port = vq_tpu.RQIndex.load(tidx.save(str(tmp_path / "port_rq")))
    np.testing.assert_array_equal(np.asarray(jax_of_port._codes), tidx._codes.numpy())
    assert_probe_parity(tidx.search(q, k=10, rerank=30), jax_of_port.search(q, k=10, rerank=30))


def test_rq_quantizer_checkpoints_load_across_packages(trained, tmp_path):
    _, cbs = trained
    path = vq_tpu.utils.save(str(tmp_path / "jax_rq"), vq_tpu.ResidualQuantizer(codebooks=cbs))
    port = vq_tpu_torch.load(path)
    assert isinstance(port, vq_tpu_torch.ResidualQuantizer)
    np.testing.assert_array_equal(port.codebooks.numpy(), cbs)
    back = vq_tpu.utils.load(vq_tpu_torch.save(str(tmp_path / "port_rq"), port))
    np.testing.assert_array_equal(np.asarray(back.codebooks), cbs)


def test_rqindex_cpu_tensors_never_launch(rq_pair):
    from vq_tpu_torch.ops import cuda_kernels as ck

    _, tidx, _, _, q = rq_pair
    kernels = (ck.adc_lookup_fused, ck.adc_scan_topk_fused, ck.assign_fused)
    before = [fn.launches for fn in kernels]
    tidx.search(q, k=10)
    tidx.search(q, k=10, rerank=200)
    tidx.add(q)
    assert [fn.launches for fn in kernels] == before


# ---------------------------------------------------------------------------
# IVFRQIndex.
# ---------------------------------------------------------------------------


def _ivfrq_state(jidx, with_rows: bool):
    pool = jidx._pool
    flat = pool.to_flat() if with_rows and pool is not None and pool.n_rows else None
    s = jidx.rq.num_stages
    config = {"metric": jidx.metric, "by_residual": jidx.by_residual, "beam": jidx.beam,
              "max_list_size": jidx.max_list_size}
    return "ivfrq_index", config, {
        "coarse": np.asarray(jidx.coarse), "codebooks": np.asarray(jidx.rq.codebooks),
        "codes": np.asarray(flat["codes"]) if flat else np.zeros((0, s), np.uint8),
        "sqn": np.asarray(flat["sqn"]) if flat else np.zeros((0,), np.float32),
        "cross": np.asarray(flat["cross"]) if flat else np.zeros((0,), np.float32),
        "lists": np.asarray(jidx._flat_lists) if flat else np.zeros((0,), np.int32),
    }


_IVF_CONFIGS = [("l2", True), ("l2", False), ("dot", True), ("dot", False)]


@pytest.fixture(scope="module", params=_IVF_CONFIGS, ids=lambda c: "%s-residual%d" % c)
def ivf_pair(request):
    metric, by_residual = request.param
    x = _clustered(seed=58)
    jidx = vq_tpu.IVFRQIndex.train(x[:1500], 8, 3, 32, max_iters=5, metric=metric,
                                   by_residual=by_residual)
    tadd = from_state(*_ivfrq_state(jidx, with_rows=False))
    for part in (x[:1800], x[1800:]):
        jidx.add(part)
        tadd.add(part)
    return jidx, from_state(*_ivfrq_state(jidx, with_rows=True)), tadd, x, _queries(x, seed=59)


def test_ivfrq_add_matches_jax(ivf_pair):
    jidx, _, tadd, x, _ = ivf_pair
    np.testing.assert_array_equal(tadd._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    np.testing.assert_array_equal(tadd._pool._chains_h, jidx._pool._chains_h)
    np.testing.assert_array_equal(tadd._pool.slot_ids.numpy(), np.asarray(jidx._pool.slot_ids))
    got, want = tadd._pool.to_flat(), jidx._pool.to_flat()
    lists = np.asarray(jidx._flat_lists)
    enc_in = x - np.asarray(jidx.coarse)[lists] if jidx.by_residual else x
    assert_rq_codes_near_ties(got["codes"].numpy(), np.asarray(want["codes"]), enc_in,
                              np.asarray(jidx.rq.codebooks))
    same = (got["codes"].numpy() == np.asarray(want["codes"])).all(1)
    for name in ("sqn", "cross"):
        np.testing.assert_allclose(got[name].numpy()[same], np.asarray(want[name])[same], **_NORM_TOL)
    assert tadd.bucket_stats() == jidx.bucket_stats() and repr(tadd) == repr(jidx)


@pytest.mark.parametrize("nprobe", [1, 4, 8])
def test_ivfrq_search_matches_jax_xla_route(ivf_pair, nprobe):
    jidx, tidx, _, _, q = ivf_pair
    assert_probe_parity(tidx.search(q, k=10, nprobe=nprobe),
                        jidx.search(q, k=10, nprobe=nprobe, use_pallas=False))


def test_ivfrq_search_matches_jax_pallas_route(ivf_pair):
    """The JAX package's fused route: the probe-independent tables
    replicated a (query, probe, chain position) slot into the Pallas K7
    in interpret mode, the norms and cross terms added outside."""
    jidx, tidx, _, _, q = ivf_pair
    pool = jidx._pool
    want = _ivf_rq_search_jit(
        jnp.asarray(q), jidx.coarse, jidx.rq.codebooks, pool.data["codes"], pool.data["sqn"],
        pool.data["cross"], pool.slot_ids, pool.chains_search(), 4, 10, pool.cap, jidx.metric,
        jidx.by_residual, use_pallas=True, interpret=True)
    ids, d = tidx.search(q, k=10, nprobe=4)
    assert_probe_parity((ids, -d if jidx.metric == "dot" else d), want)


def test_ivfrq_reconstruct_and_checkpoints_match_jax(ivf_pair, tmp_path):
    jidx, tidx, _, _, q = ivf_pair
    ids = np.array([0, 7, 2999, 1800])
    np.testing.assert_array_equal(tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids)))
    port_of_jax = vq_tpu_torch.IVFRQIndex.load(jidx.save(str(tmp_path / "jax_ivfrq")))
    assert repr(port_of_jax) == repr(jidx)
    assert_probe_parity(port_of_jax.search(q, k=10, nprobe=3), jidx.search(q, k=10, nprobe=3))
    jax_of_port = vq_tpu.IVFRQIndex.load(tidx.save(str(tmp_path / "port_ivfrq")))
    np.testing.assert_array_equal(np.asarray(jax_of_port._pool.to_flat()["codes"]),
                                  tidx._pool.to_flat()["codes"].numpy())
    assert_probe_parity(tidx.search(q, k=10, nprobe=3), jax_of_port.search(q, k=10, nprobe=3))


def test_ivfrq_k_beyond_probed_rows_pads_like_jax(ivf_pair):
    jidx, tidx, _, _, q = ivf_pair
    big = 3 * jidx._pool.cap
    got, want = tidx.search(q[:3], k=big, nprobe=1), jidx.search(q[:3], k=big, nprobe=1)
    assert_probe_parity(got, want)
    assert (got[0].numpy() == -1).sum() == (np.asarray(want[0]) == -1).sum() > 0


def test_ivfrq_seeded_train_recall_matches_jax():
    """Seeded training draws from different random streams in the two
    packages: compared on recall@10 over 100 queries. The index and its
    adds take ``ivf_pair``'s shapes (IVF8, RQ 3 x 32, five iterations, adds
    of 1800 and 1200 rows), whose JAX programs they reuse."""
    x = _clustered(seed=60, n=3000, centres=20)
    q = x[:100] + np.random.default_rng(61).normal(0, 0.05, (100, 32)).astype(np.float32)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    jidx = vq_tpu.IVFRQIndex.train(x[:1500], 8, 3, 32, max_iters=5, seed=7)
    tidx = vq_tpu_torch.IVFRQIndex.train(x[:1500], 8, 3, 32, max_iters=5, seed=7)
    for part in (x[:1800], x[1800:]):
        jidx.add(part)
        tidx.add(part)

    def recall(ids):
        ids = np.asarray(ids)
        return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)]))

    r_j = recall(jidx.search(q, k=10, nprobe=4)[0])
    r_t = recall(tidx.search(q, k=10, nprobe=4)[0])
    assert abs(r_t - r_j) <= 0.1, (r_t, r_j)
    assert r_t >= 0.2  # 3 bytes a row of 32-d data


# ---------------------------------------------------------------------------
# The card by default.
# ---------------------------------------------------------------------------


_X = np.random.default_rng(62).random((64, 8), dtype=np.float32)
_ENTRY_POINTS = {
    "ProductQuantizer": lambda: vq_tpu_torch.ProductQuantizer(_X, 2, 4, max_iters=1),
    "pq_train": lambda: vq_tpu_torch.pq_train(_X, 2, 4, max_iters=1),
    "pq_encode": lambda: vq_tpu_torch.pq_encode(_X, np.ones((2, 4, 4), np.float32)),
    "lloyd": lambda: vq_tpu_torch.lloyd(_X, 4, max_iters=1),
    "assign": lambda: vq_tpu_torch.assign(_X, _X[:4]),
    "ResidualQuantizer": lambda: vq_tpu_torch.ResidualQuantizer(_X, 2, 4, max_iters=1),
    "rq_train": lambda: vq_tpu_torch.rq_train(_X, 2, 4, max_iters=1),
    "PerDimScalarQuantizer": lambda: vq_tpu_torch.PerDimScalarQuantizer.from_data(_X),
    "IVFFlatIndex.train": lambda: vq_tpu_torch.IVFFlatIndex.train(_X, 4, max_iters=1),
    "IVFRQIndex.train": lambda: vq_tpu_torch.IVFRQIndex.train(_X, 4, 2, 4, max_iters=1),
    "IVFPQIndex.train": lambda: vq_tpu_torch.IVFPQIndex.train(_X, 4, 2, 4, max_iters=1),
    "from_state": lambda: from_state("rq", {}, {"codebooks": np.ones((2, 4, 8), np.float32)}),
    "ChunkPool": lambda: vq_tpu_torch.ivf_pool.ChunkPool({"sqn": ((), torch.float32)}, 4),
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """With numpy input and no ``device``, an entry point goes to
    ``cuda``; on this machine, which has no card, that raises rather than
    placing the state on the CPU."""
    with default_device(None):
        with pytest.raises(terr.InvalidParameter, match="no CUDA device"):
            _ENTRY_POINTS[entry]()
    assert _ENTRY_POINTS[entry]() is not None  # the module's CPU default


def test_default_device_resolution(monkeypatch):
    """A given device wins, then a tensor's device, then the card."""
    with default_device(None):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert resolve_device() == torch.device("cuda")
        assert resolve_device(None, np.zeros(3), torch.zeros(2)) == torch.device("cpu")
        assert resolve_device("cpu", torch.zeros(2)) == torch.device("cpu")
    pq = vq_tpu_torch.ProductQuantizer(torch.from_numpy(_X), 2, 4, max_iters=1)
    assert pq.device == torch.device("cpu") and pq.codebooks.device == torch.device("cpu")
