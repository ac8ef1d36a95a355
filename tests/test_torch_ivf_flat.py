"""``vq_tpu_torch.ivf_flat`` (IVF-Flat, IVF-SQ) and its probe kernel K6
against the JAX package, on the same seeded numpy inputs (JAX on the
CPU: the Pallas matvec in interpret mode, and both JAX search routes —
the public XLA scan and the fused route with ``use_pallas=True,
interpret=True``).

The JAX index's trained arrays carry into the port through
``convert.from_state``; both packages then ``add`` the same corpus and
search the same queries. The data are well-separated clusters, so the
coarse top-``nprobe`` picks the same lists in both packages.

Tolerances:

* K6's plain version against the Pallas kernel: rtol 1e-5 / atol 1e-5
  (fp32 summation order: the Pallas kernel's dot against the port's
  ascending sum; u8 payloads get left vectors scaled by 1/255, as IVF-SQ
  scales them by its step). The chain form against per-chunk calls:
  bit-exact.
* Pool layout (chains, ``slot_ids``), lists, stored rows and SQ codes:
  exact. Norms ``sqn``: rtol 1e-6 (summation order).
* Search: values within rtol 1e-5 / atol 1e-3 (L2 distances are
  assembled as ``||q||^2 - 2 q.y + ||y||^2`` at ``||q||^2`` up to ~300,
  where two summation orders differ by ~1e-4), ids exact at every rank
  whose value lies farther than that tolerance from every other value
  of its row (``assert_probe_parity``); near ties may swap.
* ``reconstruct``: IVF-Flat exact; IVF-SQ within 1e-5 (``lo + c*step``
  is one fused multiply-add in XLA's CPU backend, two roundings here).
* Seeded training (random streams differ by design): within 0.1 of the
  JAX index's recall@10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from vq_tpu.ivf_flat import _ivf_flat_search_jit, _ivf_sq_search_jit
from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.convert import from_state, state_of
from vq_tpu_torch.ops import cuda_kernels as ck
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_TOL = {"rtol": 1e-5, "atol": 1e-3}
_KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-5}
_DT = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float16": (np.float16, torch.float16)}


def assert_probe_parity(got, want, *, rtol=_TOL["rtol"], atol=_TOL["atol"]):
    """Values close; ids equal wherever the value is apart from every
    other value of its row by more than the tolerance."""
    gids, gd = (np.asarray(a) for a in got)
    wids, wd = (np.asarray(a) for a in want)
    assert gids.shape == wids.shape and gids.dtype == np.int32
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    fin = np.where(np.isfinite(wd), wd, 1e30)
    close = np.abs(fin[:, :, None] - fin[:, None, :]) <= atol + rtol * np.abs(fin[:, None, :])
    apart = close.sum(-1) == 1
    np.testing.assert_array_equal(np.where(apart, gids, -2), np.where(apart, wids, -2))


# ---------------------------------------------------------------------------
# K6 against the Pallas matvec.
# ---------------------------------------------------------------------------


def _payload(dtype, shape, rng):
    """The same payload as a numpy/JAX array and as a torch tensor."""
    if dtype == "uint8":
        a = rng.integers(0, 256, shape).astype(np.uint8)
        return a, torch.from_numpy(a)
    a = rng.normal(0, 1, shape).astype(np.float32)
    jd, td = _DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# (payload type, cap, d): caps that are not multiples of 8 or 128, and a
# d that is not a multiple of the 16-byte load width.
_MATVEC_CASES = [(dt, cap, d) for dt in ("float32", "bfloat16", "float16", "uint8")
                 for cap, d in ((37, 33), (200, 16))]


@pytest.mark.parametrize("case", _MATVEC_CASES, ids=lambda c: "%s-cap%d-d%d" % c)
def test_ivf_matvec_matches_pallas(case):
    dtype, cap, d = case
    rng = np.random.default_rng(cap + d)
    qp, nb = 11, 6
    q = rng.normal(0, 1, (qp, d)).astype(np.float32)
    if dtype == "uint8":
        q /= 255.0
    jpay, tpay = _payload(dtype, (nb, cap, d), rng)
    probe = rng.integers(0, nb, qp).astype(np.int32)
    want = np.asarray(pk.ivf_probe_matvec_fused(q, probe, jpay, interpret=True))
    got = ck.ivf_probe_matvec_fused(torch.from_numpy(q), torch.from_numpy(probe), tpay)
    assert got.shape == (qp, cap) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_KERNEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "uint8"])
def test_ivf_matvec_chains_equal_per_chunk_calls(dtype):
    """The chain form (one left vector a pair, its chunk chain walked by
    the kernel) equals the TPU caller's form (the vector repeated once a
    chunk); -1 chunks and positions at or past ``cap`` give 0."""
    rng = np.random.default_rng(70)
    p, d, ch, n_chunks = 4, 9, 16, 10
    q = torch.from_numpy(rng.normal(0, 1, (p, d)).astype(np.float32))
    _, pool = _payload(dtype, (n_chunks, ch, d), rng)
    chains = torch.tensor([[3, 1, 7], [0, -1, 2], [9, 9, -1], [5, 4, 6]], dtype=torch.int32)
    cap = 40
    got = ck.ivf_probe_matvec_fused(q, chains, pool, cap=cap)
    rep = q[:, None].expand(p, 3, d).reshape(-1, d)
    per_chunk = ck.ivf_probe_matvec_fused(rep, chains.clamp_min(0).reshape(-1), pool).reshape(p, -1)
    live = (chains.repeat_interleave(ch, dim=1) >= 0) & (torch.arange(3 * ch) < cap)
    assert torch.equal(got, torch.where(live, per_chunk, 0.0))
    assert got.shape == (p, 3 * ch) and float(got[:, cap:].abs().sum()) == 0


def test_ivf_matvec_no_pairs_blocks_and_stray_ids():
    """P = 0 gives an empty result; many pairs run in blocks; a chunk id
    past the pool reads nothing and gives 0, as -1 does."""
    pool = torch.rand(3, 8, 5)
    empty = ck.ivf_probe_matvec_fused(torch.rand(0, 5), torch.zeros(0, 2, dtype=torch.int32), pool)
    assert empty.shape == (0, 16)
    stray = ck.ivf_probe_matvec_fused(torch.rand(2, 5), torch.tensor([[3, 1], [-1, 7]]), pool)
    assert float(stray[0, :8].abs().sum()) == 0 and float(stray[1].abs().sum()) == 0
    assert bool((stray[0, 8:] != 0).all())
    q = torch.rand(300, 5)
    chains = torch.randint(-1, 3, (300, 2), dtype=torch.int32)
    whole = ck.ivf_probe_matvec_plain(q, chains, pool)
    old = ck._PLAIN_CELLS_K6
    try:
        ck._PLAIN_CELLS_K6 = 7 * 16 * 5  # blocks of 7 pairs
        assert torch.equal(ck.ivf_probe_matvec_plain(q, chains, pool), whole)
    finally:
        ck._PLAIN_CELLS_K6 = old


# K6's work list (which (pair, chain slot) entries read each chunk, in
# ascending order) on the cases the chunk-major kernel makes new: (chains,
# chunks in the pool, rows a chunk, cap).
_WORK_LIST_CASES = {
    "one_chunk_many_pairs": (np.r_[np.full(299, 2), 4].reshape(300, 1), 6, 256, None),
    "one_chunk_one_pair": (np.array([[0, 1, 2], [3, 11, 3], [4, 5, 6]]), 20, 40, None),
    "long_chain_among_short": (np.r_[np.arange(12)[None], np.full((9, 12), -1)], 16, 64, None),
    "repeats_and_stray_ids": (np.array([[4, 4, -1, 4], [-1, 10, 2, 2 ** 30], [7, 3, 4, 1]]),
                              10, 37, None),
    "cap_mid_chunk": (np.array([[0, 1, 2, 3], [3, 2, 1, 0]]), 4, 256, 2 * 256 + 37),
    "cap_zero": (np.array([[0, 1], [1, 0]]), 2, 64, 0),
    "cap_past_first_row_tile": (np.array([[0, 1, 2], [2, 1, 0], [1, -1, 1]]), 3, 300,
                                300 + 270),
    "one_pair": (np.array([[5, 0, 7, 2, 5]]), 8, 256, None),
    "probe_1d": (np.array([3, 1, 3, 0, 7, 3]), 8, 256, None),
    "no_pairs": (np.zeros((0, 3), np.int64), 8, 256, None),
}


def _work_list_numpy(chains, n_chunks, ch, cap):
    chains = chains[:, None] if chains.ndim == 1 else chains
    nc = chains.shape[1]
    cap = nc * ch if cap is None else cap
    lists = [[] for _ in range(n_chunks)]
    for i, c in enumerate(chains.reshape(-1)):
        if 0 <= c < n_chunks and (i % nc) * ch < cap:
            lists[c].append(i)
    return np.cumsum([0] + [len(w) for w in lists]), [i for w in lists for i in w]


@pytest.mark.parametrize("case", sorted(_WORK_LIST_CASES))
def test_ivf_matvec_work_list_matches_numpy(case):
    chains, n_chunks, ch, cap = _WORK_LIST_CASES[case]
    offsets, work = ck.ivf_matvec_work_list(torch.from_numpy(chains.astype(np.int32)), n_chunks,
                                            ch, cap)
    want_off, want_work = _work_list_numpy(chains, n_chunks, ch, cap)
    assert offsets.dtype == work.dtype == torch.int32
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(work.numpy(), want_work)


@pytest.mark.parametrize("entries,n_chunks", [(1, 1), (23 * 1024, 8192), (23 * 8192, 8192),
                                              (10 ** 6, 400_000), (500, 10 ** 8)])
def test_ivf_matvec_segments_cover_every_entry(entries, n_chunks):
    """The work-list pass's segments: whole warps of at least 128 entries
    that cover every entry, with a (chunk, segment) count table within its
    budget wherever one segment a chunk fits in it."""
    seg_len, segs = ck._k6_segments(entries, n_chunks)
    assert seg_len % 32 == 0 and seg_len >= ck._K6_SEGMENT
    assert (segs - 1) * seg_len < entries <= segs * seg_len
    assert n_chunks * segs <= max(ck._K6_TABLE_CELLS, n_chunks)


_MATVEC_BAD = {
    "qvecs_1d": (torch.rand(5), torch.zeros(1, dtype=torch.int32), torch.rand(2, 4, 5)),
    "d_mismatch": (torch.rand(3, 5), torch.zeros(3, dtype=torch.int32), torch.rand(2, 4, 6)),
    "payload_2d": (torch.rand(3, 5), torch.zeros(3, dtype=torch.int32), torch.rand(8, 5)),
    "payload_type": (torch.rand(3, 5), torch.zeros(3, dtype=torch.int32),
                     torch.zeros(2, 4, 5, dtype=torch.int32)),
    "pair_count": (torch.rand(3, 5), torch.zeros(2, dtype=torch.int32), torch.rand(2, 4, 5)),
    "probe_3d": (torch.rand(3, 5), torch.zeros(3, 1, 1, dtype=torch.int32), torch.rand(2, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(_MATVEC_BAD))
def test_ivf_matvec_rejects_bad_operands(case):
    with pytest.raises(terr.InvalidParameter):
        ck.ivf_probe_matvec_fused(*_MATVEC_BAD[case])


# ---------------------------------------------------------------------------
# IVFFlatIndex / IVFSQIndex: JAX indexes carried into the port.
# ---------------------------------------------------------------------------


def _clustered(seed=71, n=3000, d=32, centres=12):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 2.0, (centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, n)] + rng.normal(0, 0.3, (n, d))).astype(np.float32)


def _queries(x, seed=72, nq=9):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, len(x), nq)] + rng.normal(0, 0.05, (nq, x.shape[1]))).astype(np.float32)


def _flat_state(jidx):
    config = {"metric": jidx.metric, "store_dtype": jidx.store_dtype,
              "max_list_size": jidx.max_list_size}
    return "ivfflat_index", config, {"coarse": np.asarray(jidx.coarse),
                                     "rows": np.zeros((0, jidx.dim), np.float32),
                                     "lists": np.zeros((0,), np.int32)}


def _sq_state(jidx):
    config = {"metric": jidx.metric, "by_residual": jidx.by_residual,
              "levels": jidx.sq.levels, "max_list_size": jidx.max_list_size}
    return "ivfsq_index", config, {
        "coarse": np.asarray(jidx.coarse), "mins": np.asarray(jidx.sq.mins),
        "maxs": np.asarray(jidx.sq.maxs), "codes": np.zeros((0, jidx.dim), np.uint8),
        "sqn": np.zeros((0,), np.float32), "lists": np.zeros((0,), np.int32)}


def _pair(kind, option, metric, max_list_size=None):
    """A trained JAX index, the port's copy of it, both holding the same
    corpus (added in two batches), and queries."""
    x = _clustered()
    if kind == "flat":
        jidx = vq_tpu.IVFFlatIndex.train(x[:1500], 8, max_iters=6, metric=metric,
                                         store_dtype=option, max_list_size=max_list_size)
        tidx = from_state(*_flat_state(jidx))
    else:
        jidx = vq_tpu.IVFSQIndex.train(x[:1500], 8, max_iters=6, metric=metric,
                                       by_residual=option, max_list_size=max_list_size)
        tidx = from_state(*_sq_state(jidx))
    for part in (x[:1800], x[1800:]):
        jidx.add(part)
        tidx.add(part)
    return jidx, tidx, x, _queries(x)


_CONFIGS = [("flat", "float32", "l2"), ("flat", "bfloat16", "l2"), ("flat", "float16", "l2"),
            ("flat", "float32", "dot"), ("flat", "bfloat16", "dot"),
            ("sq", True, "l2"), ("sq", False, "l2"), ("sq", True, "dot"), ("sq", False, "dot")]


@pytest.fixture(scope="module", params=_CONFIGS, ids=lambda c: "%s-%s-%s" % c)
def built(request):
    return _pair(*request.param)


def _payload_name(tidx):
    return "rows" if isinstance(tidx, vq_tpu_torch.IVFFlatIndex) else "codes"


def _as_np(t):
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def test_add_gives_equal_pool(built):
    jidx, tidx, _, _ = built
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    np.testing.assert_array_equal(tidx._pool._chains_h, jidx._pool._chains_h)
    np.testing.assert_array_equal(tidx._pool.slot_ids.numpy(), np.asarray(jidx._pool.slot_ids))
    name = _payload_name(tidx)
    want = np.asarray(jidx._pool.to_flat([name])[name].astype(jnp.float32 if name == "rows" else jnp.uint8))
    np.testing.assert_array_equal(_as_np(tidx._pool.to_flat([name])[name]), want)
    np.testing.assert_allclose(tidx._pool.to_flat(["sqn"])["sqn"].numpy(),
                               np.asarray(jidx._pool.to_flat(["sqn"])["sqn"]), rtol=1e-6, atol=1e-6)
    assert tidx.bucket_stats() == jidx.bucket_stats()
    assert (tidx.ntotal, tidx.nlist, tidx.dim) == (jidx.ntotal, jidx.nlist, jidx.dim)


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_search_matches_jax_xla_route(built, nprobe):
    jidx, tidx, _, q = built
    got = tidx.search(q, k=10, nprobe=nprobe)
    assert_probe_parity(got, jidx.search(q, k=10, nprobe=nprobe, use_pallas=False))


def test_search_matches_jax_pallas_route(built):
    """The JAX package's fused route: the Pallas matvec in interpret mode
    over the probed chains, the offsets added outside."""
    jidx, tidx, _, q = built
    pool, metric = jidx._pool, jidx.metric
    if isinstance(jidx, vq_tpu.IVFFlatIndex):
        want = _ivf_flat_search_jit(
            jnp.asarray(q), jidx.coarse, pool.data["rows"], pool.data["sqn"], pool.slot_ids,
            pool.chains_search(), 4, 10, pool.cap, metric, use_pallas=True, interpret=True)
    else:
        want = _ivf_sq_search_jit(
            jnp.asarray(q), jidx.coarse, jidx.sq.mins, jidx.sq.steps, pool.data["codes"],
            pool.data["sqn"], pool.slot_ids, pool.chains_search(), 4, 10, pool.cap, metric,
            jidx.by_residual, use_pallas=True, interpret=True)
    ids, d = tidx.search(q, k=10, nprobe=4)
    if metric == "dot":
        d = -d  # the jit returns the smaller-is-better form
    assert_probe_parity((ids, d), want)


def test_search_k_beyond_probed_rows_pads_like_jax(built):
    jidx, tidx, _, q = built
    big = 3 * jidx._pool.cap
    got = tidx.search(q[:3], k=big, nprobe=1)
    want = jidx.search(q[:3], k=big, nprobe=1)
    assert_probe_parity(got, want)
    pad = np.inf if jidx.metric == "l2" else -np.inf
    assert ((got[0].numpy() == -1) == (got[1].numpy() == pad)).all()
    assert (got[0].numpy() == -1).sum() == (np.asarray(want[0]) == -1).sum() > 0


def test_reconstruct_matches_jax(built):
    jidx, tidx, _, _ = built
    ids = np.array([0, 7, 2999, 1800, 1234])
    got, want = tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids))
    if isinstance(tidx, vq_tpu_torch.IVFFlatIndex):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_state_round_trip(built):
    _, tidx, _, q = built
    again = from_state(*state_of(tidx))
    name = _payload_name(tidx)
    assert torch.equal(again._pool.to_flat([name])[name], tidx._pool.to_flat([name])[name])
    assert torch.equal(again._flat_lists, tidx._flat_lists)
    ids, d = again.search(q, k=10, nprobe=3)
    want_ids, want_d = tidx.search(q, k=10, nprobe=3)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)


_CHECKPOINT_CONFIGS = [("flat", "float32", "l2"), ("flat", "bfloat16", "l2"),
                       ("flat", "float16", "dot"), ("sq", True, "l2"), ("sq", False, "dot")]


@pytest.mark.parametrize("cfg", _CHECKPOINT_CONFIGS, ids=lambda c: "%s-%s-%s" % c)
def test_checkpoints_load_across_packages(cfg, tmp_path):
    jidx, tidx, _, q = _pair(*cfg)
    cls = type(tidx)
    port_of_jax = cls.load(jidx.save(str(tmp_path / "jax_index")))
    assert port_of_jax.ntotal == jidx.ntotal and repr(port_of_jax) == repr(tidx)
    assert_probe_parity(port_of_jax.search(q, k=10, nprobe=3), jidx.search(q, k=10, nprobe=3))
    jax_of_port = type(jidx).load(tidx.save(str(tmp_path / "port_index")))
    name = _payload_name(tidx)
    want = jax_of_port._pool.to_flat([name])[name]
    np.testing.assert_array_equal(
        _as_np(tidx._pool.to_flat([name])[name]),
        np.asarray(want.astype(jnp.float32) if name == "rows" else want))
    assert_probe_parity(tidx.search(q, k=10, nprobe=3), jax_of_port.search(q, k=10, nprobe=3))


@pytest.mark.parametrize("cls_name", ["IVFFlatIndex", "IVFSQIndex"])
def test_empty_index_round_trips(cls_name, tmp_path):
    x = _clustered(n=200)
    if cls_name == "IVFFlatIndex":
        jidx = vq_tpu.IVFFlatIndex(x[:4], store_dtype="bfloat16")
    else:
        jidx = vq_tpu.IVFSQIndex(x[:4], vq_tpu.models.sq.PerDimScalarQuantizer.from_data(x))
    tcls = getattr(vq_tpu_torch, cls_name)
    loaded = tcls.load(jidx.save(str(tmp_path / "empty")))
    assert loaded.ntotal == 0 and loaded.nlist == 4 and loaded.bucket_stats() == {"ntotal": 0}
    back = type(jidx).load(loaded.save(str(tmp_path / "empty_port")))
    assert back.ntotal == 0
    other = vq_tpu_torch.IVFSQIndex if cls_name == "IVFFlatIndex" else vq_tpu_torch.IVFFlatIndex
    with pytest.raises(terr.InvalidData, match="checkpoint"):
        other.load(jidx.save(str(tmp_path / "other")))


@pytest.mark.parametrize("kind", ["flat", "sq"])
def test_max_list_size_matches_jax(kind):
    jidx, tidx, _, q = _pair(kind, "float32" if kind == "flat" else True, "l2", max_list_size=100)
    assert tidx.bucket_stats() == jidx.bucket_stats()
    assert tidx.bucket_stats()["overflow_dropped"] > 0
    assert_probe_parity(tidx.search(q, k=5, nprobe=4), jidx.search(q, k=5, nprobe=4))


@pytest.mark.parametrize("chunk_rows", [64, 100])
def test_chunk_rows_matches_jax(chunk_rows):
    x, q = _clustered(), _queries(_clustered())
    jidx = vq_tpu.IVFFlatIndex.train(x[:1500], 8, max_iters=6, chunk_rows=chunk_rows)
    tidx = vq_tpu_torch.IVFFlatIndex(np.asarray(jidx.coarse), chunk_rows=chunk_rows)
    jidx.add(x)
    tidx.add(x)
    assert tidx._pool.ch == jidx._pool.ch == chunk_rows
    np.testing.assert_array_equal(tidx._pool._chains_h, jidx._pool._chains_h)
    assert_probe_parity(tidx.search(q, k=10, nprobe=3), jidx.search(q, k=10, nprobe=3))


def test_spherical_train_gives_unit_centroids():
    x = _clustered()
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    tidx = vq_tpu_torch.IVFFlatIndex.train(x[:1500], 8, max_iters=6, spherical=True, metric="dot")
    np.testing.assert_allclose(torch.linalg.norm(tidx.coarse, dim=1).numpy(), 1.0, rtol=1e-5)
    tidx.add(x)
    ids, scores = tidx.search(x[:5], k=3, nprobe=8)
    assert ids[:, 0].tolist() == list(range(5))  # each unit row is its own best inner product
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())


@pytest.mark.parametrize("kind", ["flat", "sq"])
def test_half_precision_add_matches_jax(kind):
    x = _clustered()
    if kind == "flat":
        jidx = vq_tpu.IVFFlatIndex.train(x[:1500], 8, max_iters=6)
        tidx = from_state(*_flat_state(jidx))
    else:
        jidx = vq_tpu.IVFSQIndex.train(x[:1500], 8, max_iters=6)
        tidx = from_state(*_sq_state(jidx))
    jidx.add(jnp.asarray(x[:700], jnp.bfloat16))
    tidx.add(torch.from_numpy(x[:700]).to(torch.bfloat16))
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    name = _payload_name(tidx)
    np.testing.assert_array_equal(_as_np(tidx._pool.to_flat([name])[name]),
                                  np.asarray(jidx._pool.to_flat([name])[name]))


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1] for a, b in zip(ids, truth)]))


@pytest.mark.parametrize("kind", ["flat", "sq"])
def test_seeded_train_recall_matches_jax(kind):
    """Seeded training draws from different random streams in the two
    packages, so the trained indexes are compared on recall@10 over 100
    queries."""
    x = _clustered(seed=73, n=3000, centres=20)
    q = x[:100] + np.random.default_rng(74).normal(0, 0.05, (100, 32)).astype(np.float32)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    cls_j = vq_tpu.IVFFlatIndex if kind == "flat" else vq_tpu.IVFSQIndex
    cls_t = vq_tpu_torch.IVFFlatIndex if kind == "flat" else vq_tpu_torch.IVFSQIndex
    jidx = cls_j.train(x[:1500], 16, max_iters=8, seed=7)
    tidx = cls_t.train(x[:1500], 16, max_iters=8, seed=7)
    jidx.add(x)
    tidx.add(x)
    assert tidx.nlist == 16 and tidx.ntotal == 3000
    r_j = _recall(jidx.search(q, k=10, nprobe=4)[0], truth)
    r_t = _recall(tidx.search(q, k=10, nprobe=4)[0], truth)
    assert abs(r_t - r_j) <= 0.1, (r_t, r_j)
    assert r_t >= 0.5


def _empty_pair(kind):
    rng = np.random.default_rng(75)
    coarse = rng.random((5, 6), dtype=np.float32)
    if kind == "flat":
        return vq_tpu.IVFFlatIndex(coarse), vq_tpu_torch.IVFFlatIndex(coarse)
    lo, hi = np.zeros(6, np.float32), np.ones(6, np.float32)
    return (vq_tpu.IVFSQIndex(coarse, vq_tpu.models.sq.PerDimScalarQuantizer(lo, hi)),
            vq_tpu_torch.IVFSQIndex(coarse, vq_tpu_torch.PerDimScalarQuantizer(lo, hi)))


_BAD = {
    "search_empty": lambda i, x: i.search(x[:2, :6]),
    "reconstruct_empty": lambda i, x: i.reconstruct([0]),
    "add_dim": lambda i, x: i.add(x[:3, :5]),
    "search_dim": lambda i, x: (i.add(x[:20, :6]), i.search(x[:2, :7])),
}


@pytest.mark.parametrize("kind", ["flat", "sq"])
@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(case, kind):
    x = np.random.default_rng(76).random((40, 8), dtype=np.float32)
    jidx, tidx = _empty_pair(kind)
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](jidx, x)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](tidx, x)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_construction_errors_match_jax():
    rng = np.random.default_rng(77)
    coarse = rng.random((5, 6), dtype=np.float32)
    lo, hi = np.zeros(6, np.float32), np.ones(6, np.float32)
    jsq = vq_tpu.models.sq.PerDimScalarQuantizer(lo, hi)
    tsq = vq_tpu_torch.PerDimScalarQuantizer(lo, hi)
    jsq7 = vq_tpu.models.sq.PerDimScalarQuantizer(np.zeros(7, np.float32), np.ones(7, np.float32))
    tsq7 = vq_tpu_torch.PerDimScalarQuantizer(np.zeros(7, np.float32), np.ones(7, np.float32))
    cases = [
        lambda m: m.IVFFlatIndex(coarse, metric="cosine"),
        lambda m: m.IVFFlatIndex(coarse, store_dtype="int8"),
        lambda m: m.IVFFlatIndex(np.zeros((0, 6), np.float32)),
        lambda m: m.IVFSQIndex(coarse, jsq if m is vq_tpu else tsq, metric="l1"),
        lambda m: m.IVFSQIndex(coarse, "not an sq"),
        lambda m: m.IVFSQIndex(coarse, jsq7 if m is vq_tpu else tsq7),
    ]
    for make in cases:
        with pytest.raises(jerr.VqError) as want:
            make(vq_tpu)
        with pytest.raises(terr.VqError) as got:
            make(vq_tpu_torch)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def test_cpu_tensors_never_launch(built):
    _, tidx, _, q = built
    before = ck.ivf_probe_matvec_fused.launches, ck.assign_fused.launches
    tidx.search(q, k=5, nprobe=2)
    from_state(*state_of(tidx)).add(q)
    assert (ck.ivf_probe_matvec_fused.launches, ck.assign_fused.launches) == before
