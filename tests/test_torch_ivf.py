"""``vq_tpu_torch.ivf.IVFPQIndex`` and its probe kernel K7 against the JAX
package, on the same seeded numpy inputs (JAX on the CPU: the Pallas
probe in interpret mode, ``IVFPQIndex.search`` on its XLA path).

The JAX index's trained arrays carry into the port through
``convert.from_state``; both packages then ``add`` the same corpus and
search the same queries. The data are well-separated clusters, so the
coarse top-``nprobe`` (``||c||^2 - 2 q.c`` from two different matmuls)
picks the same lists in both packages.

Tolerances: K7 bit-identical (one summation order: acc = 0, then
subspaces 0..m-1 in fp32); pool layout, lists and codes exact; search ids
exact at every rank whose distance is unique in its row
(``assert_search_parity``), ADC distances within rtol 1e-5 / atol 1e-4
(fp32 rounding of the residual tables, |values| < 100), reranked exact
distances within rtol 1e-5 / atol 1e-5; seeded training (random streams
differ by design) within 0.1 of the JAX index's recall@10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from test_torch_pq import assert_search_parity
from vq_tpu.ivf import IVFPQIndex as JIndex
from vq_tpu.models.pq import ProductQuantizer as JPQ
from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.convert import from_state
from vq_tpu_torch.ivf import IVFPQIndex as TIndex
from vq_tpu_torch.ops import cuda_kernels as ck

_ADC_TOL = {"rtol": 1e-5, "atol": 1e-4}
_EXACT_TOL = {"rtol": 1e-5, "atol": 1e-5}


# ---------------------------------------------------------------------------
# K7 against the Pallas probe.
# ---------------------------------------------------------------------------


# (code type, kk, cap): both TPU bodies (gather for u8 / kk <= 256,
# one-hot for i32 / kk > 256) and caps that are not multiples of 128.
_PROBE_CASES = [("u8", 16, 200), ("u8", 256, 37), ("i32", 512, 300), ("i32", 100, 129)]


@pytest.mark.parametrize("case", _PROBE_CASES, ids=lambda c: "%s-kk%d-cap%d" % c)
def test_ivf_probe_matches_pallas(case):
    ctype, kk, cap = case
    rng = np.random.default_rng(60 + kk)
    qp, m, nb = 9, 5, 6
    tables = rng.normal(0, 1, (qp, m, kk)).astype(np.float32)
    codes = rng.integers(0, kk, (nb, cap, m)).astype(np.uint8 if ctype == "u8" else np.int32)
    codes[:, 0, :] = kk - 1  # the last code in every list's first slot
    probe = rng.integers(0, nb, qp).astype(np.int32)
    want = np.asarray(pk.ivf_probe_adc_fused(tables, probe, jnp.asarray(codes), interpret=True))
    got = ck.ivf_probe_adc_fused(torch.from_numpy(tables), torch.from_numpy(probe),
                                 torch.from_numpy(codes))
    assert got.shape == (qp, cap)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ivf_probe_chains_equal_per_chunk_calls():
    """The chain form (one table a pair, its chunk chain walked by the
    kernel) equals the TPU caller's form (the table repeated once a
    chunk); -1 chunks and positions at or past ``cap`` give 0."""
    rng = np.random.default_rng(64)
    p, m, kk, ch, n_chunks = 4, 3, 64, 16, 10
    tables = torch.from_numpy(rng.random((p, m, kk), dtype=np.float32))
    pool = torch.from_numpy(rng.integers(0, kk, (n_chunks, ch, m)).astype(np.uint8))
    chains = torch.tensor([[3, 1, 7], [0, -1, 2], [9, 9, -1], [5, 4, 6]], dtype=torch.int32)
    cap = 40
    got = ck.ivf_probe_adc_fused(tables, chains, pool, cap=cap)
    rep = tables[:, None].expand(p, 3, m, kk).reshape(-1, m, kk)
    per_chunk = ck.ivf_probe_adc_fused(rep, chains.clamp_min(0).reshape(-1), pool).reshape(p, -1)
    pos = torch.arange(3 * ch)
    live = (chains.repeat_interleave(ch, dim=1) >= 0) & (pos < cap)
    assert torch.equal(got, torch.where(live, per_chunk, 0.0))
    assert got.shape == (p, 3 * ch) and float(got[:, cap:].abs().sum()) == 0


def test_ivf_probe_rejects_bad_operands():
    tables = torch.rand(3, 4, 8)
    with pytest.raises(ValueError):
        ck.ivf_probe_adc_fused(tables, torch.zeros(3, dtype=torch.int32),
                               torch.zeros(2, 5, 3, dtype=torch.uint8))  # m mismatch
    with pytest.raises(ValueError):
        ck.ivf_probe_adc_fused(tables, torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, 5, 4, dtype=torch.uint8))  # pair count


# ---------------------------------------------------------------------------
# IVFPQIndex: JAX index carried into the port.
# ---------------------------------------------------------------------------


def _clustered(seed=9, n=4000, d=32, centres=24):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 2.0, (centres, d)).astype(np.float32)
    x = (c[rng.integers(0, centres, n)] + rng.normal(0, 0.3, (n, d))).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def built():
    x = _clustered()
    jidx = JIndex.train(x[:1500], nlist=16, num_subspaces=4, num_centroids=32,
                        max_iters=8, keep_corpus=True)
    arrays = {"coarse": np.asarray(jidx.coarse), "codebooks": np.asarray(jidx.pq.codebooks),
              "flat_codes": np.zeros((0, 4), np.uint8), "flat_lists": np.zeros((0,), np.int32)}
    config = {"by_residual": True, "keep_corpus": True, "max_list_size": None, "metric": "l2"}
    tidx = from_state("ivfpq_index", config, arrays)
    for part in (x[:2500], x[2500:]):  # two adds: the pool appends in place
        jidx.add(part)
        tidx.add(part)
    queries = x[np.random.default_rng(61).integers(0, len(x), 12)] + 0.05
    return jidx, tidx, x, queries.astype(np.float32)


def test_add_gives_equal_lists_and_codes(built):
    jidx, tidx, _, _ = built
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    np.testing.assert_array_equal(tidx._pool._chains_h, jidx._pool._chains_h)
    np.testing.assert_array_equal(tidx._pool.slot_ids.numpy(), np.asarray(jidx._pool.slot_ids))
    np.testing.assert_array_equal(
        tidx._pool.to_flat()["codes"].numpy(), np.asarray(jidx._pool.to_flat()["codes"])
    )
    assert tidx.bucket_stats() == jidx.bucket_stats()


@pytest.mark.parametrize("rerank", [0, 50])
@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_search_matches_jax(built, nprobe, rerank):
    jidx, tidx, _, q = built
    want = jidx.search(q, k=10, nprobe=nprobe, rerank=rerank)
    got = tidx.search(q, k=10, nprobe=nprobe, rerank=rerank)
    assert got[0].dtype == torch.int32
    assert_search_parity(got, want, **(_EXACT_TOL if rerank else _ADC_TOL))


def test_search_k_beyond_probed_rows_pads_like_jax(built):
    jidx, tidx, _, q = built
    big = 3 * jidx._pool.cap
    want = jidx.search(q[:3], k=big, nprobe=1)
    got = tidx.search(q[:3], k=big, nprobe=1)
    assert_search_parity(got, want, **_ADC_TOL)
    assert (got[0].numpy() == -1).sum() == (np.asarray(want[0]) == -1).sum() > 0


def test_reconstruct_matches_jax(built):
    jidx, tidx, _, _ = built
    ids = np.array([0, 7, 3999, 2500, 1234])
    np.testing.assert_array_equal(tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids)))


def test_half_precision_add_matches_jax(built):
    jidx, tidx, x, _ = built
    j2 = JIndex(jidx.coarse, jidx.pq)
    t2 = TIndex(tidx.coarse, tidx.pq)
    j2.add(jnp.asarray(x[:500], jnp.bfloat16))
    t2.add(torch.from_numpy(x[:500]).to(torch.bfloat16))
    np.testing.assert_array_equal(t2._flat_lists.numpy(), np.asarray(j2._flat_lists))
    np.testing.assert_array_equal(
        t2._pool.to_flat()["codes"].numpy(), np.asarray(j2._pool.to_flat()["codes"])
    )


def test_max_list_size_matches_jax(built):
    jidx, tidx, x, q = built
    j2 = JIndex(jidx.coarse, jidx.pq, max_list_size=64)
    t2 = TIndex(tidx.coarse, tidx.pq, max_list_size=64)
    j2.add(x)
    t2.add(x)
    assert t2.bucket_stats() == j2.bucket_stats()
    assert t2.bucket_stats()["overflow_dropped"] > 0
    assert_search_parity(t2.search(q, k=5, nprobe=4), j2.search(q, k=5, nprobe=4), **_ADC_TOL)


def test_jax_checkpoint_loads_in_port(built, tmp_path):
    jidx, _, _, q = built
    loaded = TIndex.load(jidx.save(str(tmp_path / "jax_ivf")))
    assert loaded.ntotal == jidx.ntotal and loaded.keep_corpus
    assert_search_parity(loaded.search(q, k=10, nprobe=4, rerank=30),
                         jidx.search(q, k=10, nprobe=4, rerank=30), **_EXACT_TOL)


def test_port_checkpoint_loads_in_jax(built, tmp_path):
    jidx, tidx, _, q = built
    loaded = JIndex.load(tidx.save(str(tmp_path / "port_ivf")))
    np.testing.assert_array_equal(np.asarray(loaded._flat_lists), tidx._flat_lists.numpy())
    np.testing.assert_array_equal(
        np.asarray(loaded._pool.to_flat()["codes"]), tidx._pool.to_flat()["codes"].numpy()
    )
    assert_search_parity(tidx.search(q, k=10, nprobe=4), loaded.search(q, k=10, nprobe=4),
                         **_ADC_TOL)


def test_empty_index_round_trips(tmp_path):
    jpq = JPQ(codebooks=np.random.default_rng(62).random((2, 4, 3), dtype=np.float32),
              distance="squared_euclidean")
    coarse = np.random.default_rng(63).random((5, 6), dtype=np.float32)
    loaded = TIndex.load(JIndex(coarse, jpq).save(str(tmp_path / "empty")))
    assert loaded.ntotal == 0 and loaded.nlist == 5
    back = JIndex.load(loaded.save(str(tmp_path / "empty_port")))
    assert back.ntotal == 0


def _empty_pair():
    rng = np.random.default_rng(65)
    cb = rng.random((2, 4, 3), dtype=np.float32)
    coarse = rng.random((5, 6), dtype=np.float32)
    return (JIndex(coarse, JPQ(codebooks=cb, distance="squared_euclidean")),
            TIndex(coarse, vq_tpu_torch.ProductQuantizer(codebooks=cb, distance="squared_euclidean")))


_BAD = {
    "search_empty": lambda i, x: i.search(x[:2, :6]),
    "reconstruct_empty": lambda i, x: i.reconstruct([0]),
    "add_dim": lambda i, x: i.add(x[:3, :5]),
    "search_dim": lambda i, x: (i.add(x[:20, :6]), i.search(x[:2, :7])),
    "rerank_without_corpus": lambda i, x: (i.add(x[:20, :6]), i.search(x[:2, :6], rerank=5)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(case):
    x = np.random.default_rng(66).random((40, 8), dtype=np.float32)
    jidx, tidx = _empty_pair()
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](jidx, x)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](tidx, x)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_construction_errors_match_jax():
    rng = np.random.default_rng(67)
    cb = rng.random((2, 4, 3), dtype=np.float32)
    jpq = JPQ(codebooks=cb, distance="squared_euclidean")
    tpq = vq_tpu_torch.ProductQuantizer(codebooks=cb, distance="squared_euclidean")
    for coarse, kw in ((rng.random((5, 7), dtype=np.float32), {}),
                       (rng.random((5, 6), dtype=np.float32), {"metric": "cosine"})):
        with pytest.raises(jerr.VqError) as want:
            JIndex(coarse, jpq, **kw)
        with pytest.raises(terr.VqError) as got:
            TIndex(coarse, tpq, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(terr.InvalidParameter, match="not ported"):
        TIndex(rng.random((5, 6), dtype=np.float32), tpq, metric="dot")


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1] for a, b in zip(ids, truth)]))


def test_seeded_train_recall_matches_jax():
    """Seeded training draws from different random streams in the two
    packages, so the trained indexes are compared on recall@10 over 100
    queries (across seeds the two differ by at most 0.04 here)."""
    x = _clustered(seed=68, n=3000)
    q = x[:100] + np.random.default_rng(69).normal(0, 0.05, (100, 32)).astype(np.float32)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    truth = np.argsort(d, axis=1)[:, :10]
    jidx = JIndex.train(x[:1500], nlist=16, num_subspaces=4, num_centroids=32,
                        max_iters=8, seed=7, keep_corpus=True)
    tidx = TIndex.train(x[:1500], nlist=16, num_subspaces=4, num_centroids=32,
                        max_iters=8, seed=7, keep_corpus=True)
    jidx.add(x)
    tidx.add(x)
    assert tidx.nlist == 16 and tidx.ntotal == 3000
    for kw in ({"nprobe": 4}, {"nprobe": 4, "rerank": 50}):
        r_j = _recall(jidx.search(q, k=10, **kw)[0], truth)
        r_t = _recall(tidx.search(q, k=10, **kw)[0], truth)
        assert abs(r_t - r_j) <= 0.1, (kw, r_t, r_j)


def test_cpu_tensors_never_launch(built):
    _, tidx, _, q = built
    before = ck.ivf_probe_adc_fused.launches, ck.assign_fused.launches
    tidx.search(q, k=5, nprobe=2)
    assert (ck.ivf_probe_adc_fused.launches, ck.assign_fused.launches) == before
