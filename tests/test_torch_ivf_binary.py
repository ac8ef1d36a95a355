"""``vq_tpu_torch.IVFBinaryIndex`` against ``vq_tpu.IVFBinaryIndex`` on
the same seeded numpy inputs (JAX on the CPU), mirroring
``tests/test_ivf_binary.py`` but for its generic ``load_index`` and
``index_factory`` cases, which belong to the port's factory module.

Both packages build from the same coarse centroids (rows of the corpus,
no seeded training) and add the same rows, so the lists agree exactly.

Tolerances: Hamming values are integer counts, so ids and values equal
bit for bit at every rank, ties included: the port's one stable top-k
over the probe-rank-major slots keeps the order of the JAX package's
running ``lax.top_k`` merge over probe ranks. Packed words, lists and
the pool layout: exact. Reranked values (exact squared L2 in f32): rtol
1e-5 / atol 1e-4, ids equal at every rank apart from every other value
of its row by more than that. ``range_search`` (a Hamming radius):
counts, ids and values exact. Checkpoints load across the packages both
ways. R4: a ``keep_corpus`` checkpoint whose packed rows come without
their corpus makes the JAX loader fail with ``KeyError('corpus')``; the
port raises ``InvalidData`` (both asserted).
"""

import json
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
from test_torch_ivf_maint import assert_same_layout
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.models.bq import hamming_distance, pack_bits


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_RERANK_TOL = {"rtol": 1e-5, "atol": 1e-4}


@pytest.fixture(scope="module")
def corpus():
    """``tests/test_ivf_binary.py``'s corpus: 12 clusters in 40-d (two
    words a row, 24 padding bits)."""
    rng = np.random.default_rng(29)
    centers = rng.normal(0, 2.0, (12, 40)).astype(np.float32)
    which = rng.integers(0, 12, 1500)
    return (centers[which] + rng.normal(0, 0.3, (1500, 40))).astype(np.float32)


def _coarse(corpus, nlist, seed=3):
    return corpus[np.random.default_rng(seed).choice(len(corpus), nlist, replace=False)]


def _pair(corpus, rows, nlist=12, **kw):
    coarse = _coarse(corpus, nlist)
    jidx, tidx = vq_tpu.IVFBinaryIndex(coarse, **kw), vq_tpu_torch.IVFBinaryIndex(coarse, **kw)
    jidx.add(rows)
    tidx.add(rows)
    return jidx, tidx


@pytest.fixture(scope="module")
def pair(corpus):
    return _pair(corpus, corpus)


@pytest.fixture(scope="module")
def q8(corpus):
    """One query batch for every JAX search (each new query count or
    (k, nprobe) compiles the JAX program anew)."""
    return corpus[:8] + 0.05


@pytest.fixture(scope="module")
def kept(corpus):
    return _pair(corpus, corpus, keep_corpus=True)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert _np(g).dtype == _np(w).dtype
        np.testing.assert_array_equal(_np(g), _np(w))


def test_add_gives_equal_pool(pair):
    jidx, tidx = pair
    assert_same_layout(jidx, tidx)
    assert tidx._pool.data["codes"].dtype == torch.uint32 and repr(tidx) == repr(jidx)


@pytest.mark.parametrize("case", [(1, 5), (4, 5), (12, 5), (4, 600)], ids=lambda c: "nprobe%d-k%d" % c)
def test_search_matches_jax_bit_for_bit(q8, pair, case):
    """Ties included: Hamming counts tie often, and both merges keep the
    lowest probe rank, then the lowest slot. k = 600 passes the four
    probed lists' rows and pads with -1 / inf."""
    nprobe, k = case
    jidx, tidx = pair
    got, want = tidx.search(q8, k=k, nprobe=nprobe), jidx.search(q8, k=k, nprobe=nprobe)
    assert_same(got, want)
    d = got[1].numpy()
    assert (d[:, 1:] == d[:, :-1]).any()  # ties were there to order
    if k == 600:
        assert bool((got[0] == -1).any()) and ((got[0] == -1) == torch.isinf(got[1])).all()


def test_full_probe_matches_flat_binary(corpus, pair):
    """nprobe = nlist visits every list: the flat Hamming ranking, ids
    differing only among equal distances."""
    _, tidx = pair
    q = corpus[:6] + 0.05
    flat = vq_tpu_torch.BinaryIndex(corpus.shape[1])
    flat.add(corpus)
    ids_f, d_f = flat.search(q, k=5)
    ids_i, d_i = tidx.search(q, k=5, nprobe=tidx.nlist)
    np.testing.assert_array_equal(np.sort(d_i.numpy(), 1), np.sort(d_f.numpy(), 1))
    assert ((ids_i == ids_f) | (d_i == d_f)).all()


def test_probed_distances_are_exact_hamming(corpus, pair):
    _, tidx = pair
    q = corpus[:4] + 0.02
    ids, d = tidx.search(q, k=3, nprobe=4)
    allp = tidx._pool.gather_rows("codes", np.arange(tidx.ntotal))
    ham = hamming_distance(pack_bits(torch.from_numpy(q) >= 0.0), allp)
    live = ids >= 0
    assert torch.equal(d[live], ham.gather(1, ids.clamp_min(0).long())[live].float())


def test_monotone_in_nprobe(corpus, pair):
    _, tidx = pair
    q = corpus[:8]
    d1, d4, dn = (tidx.search(q, k=1, nprobe=p)[1] for p in (1, 4, tidx.nlist))
    assert bool((d4 <= d1).all() and (dn <= d4).all())


def test_small_pool_pads_with_minus_one(corpus):
    tidx = vq_tpu_torch.IVFBinaryIndex(_coarse(corpus, 8))
    tidx.add(corpus[:40])
    ids, d = tidx.search(corpus[:3], k=30, nprobe=1)
    assert ids.shape == (3, 30) and bool((ids == -1).any()) and bool(torch.isinf(d).any())


def test_scan_blocks_probe_ranks(corpus, pair, monkeypatch):
    """The XOR block spans a few probe ranks at a time, never all of
    them; any block size gives the same distances."""
    from vq_tpu_torch.models import bq

    _, tidx = pair
    q = corpus[:7] + 0.1
    want = tidx.search(q, k=9, nprobe=12)
    monkeypatch.setitem(bq._HAMMING_CELLS, "cpu", 7 * 256 * 2 * 5)  # 5 probe ranks a block
    assert_same(tidx.search(q, k=9, nprobe=12), want)


def test_rerank_matches_jax_and_is_exact_l2(corpus, q8, kept):
    jidx, tidx = kept
    q = q8
    got = tidx.search(q, k=3, nprobe=12, rerank=200)
    assert_probe_parity(got, jidx.search(q, k=3, nprobe=12, rerank=200), **_RERANK_TOL)
    ids, d = got
    full = ((corpus[None] - q[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(d[:, 0].numpy(), full[np.arange(8), ids[:, 0].numpy()], rtol=1e-4)
    np.testing.assert_array_equal(ids[:, 0].numpy(), full.argmin(1))
    fn, arrays = tidx._search_core(3, nprobe=12, rerank=200)
    assert_same(fn(torch.from_numpy(q), *arrays), got)


def test_search_core_and_reconstruct_forms(corpus, q8, pair, kept):
    _, tidx = pair
    q = torch.from_numpy(q8)
    fn, arrays = tidx._search_core(5, nprobe=4)
    assert_same(fn(q, *arrays), tidx.search(q, k=5, nprobe=4))
    got = tidx.search_and_reconstruct(q, k=5, nprobe=4)
    assert_same(got, pair[0].search_and_reconstruct(q8, k=5, nprobe=4))
    rec = tidx.reconstruct([0, 3])
    assert rec.shape == (2, corpus.shape[1]) and set(rec.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(kept[1].reconstruct([0, 3]).numpy(), corpus[[0, 3]])


def test_rerank_without_corpus_raises(corpus, pair):
    for idx, err in ((pair[0], jerr.InvalidData), (pair[1], terr.InvalidData)):
        with pytest.raises(err, match="keep_corpus"):
            idx.search(corpus[:2], k=3, rerank=50)


def test_range_search_matches_jax_and_brute_hamming(q8, pair):
    jidx, tidx = pair
    got = tidx.range_search(q8, 4.0, nprobe=tidx.nlist, max_results=2048)
    assert_same(got, jidx.range_search(q8, 4.0, nprobe=jidx.nlist, max_results=2048))
    ham = hamming_distance(pack_bits(torch.from_numpy(q8) >= 0.0),
                           tidx._pool.gather_rows("codes", np.arange(tidx.ntotal)))
    ids, _, counts = got
    assert torch.equal(counts, (ham <= 4).sum(1).to(torch.int32))
    for r in range(q8.shape[0]):
        assert set(ids[r][ids[r] >= 0].tolist()) == set(torch.where(ham[r] <= 4)[0].tolist())


def test_range_search_partial_probe_and_truncation(q8, pair):
    jidx, tidx = pair
    c_full = tidx.range_search(q8, 6.0, nprobe=tidx.nlist)[2]
    part = tidx.range_search(q8, 6.0, nprobe=2, max_results=16)
    assert_same(part, jidx.range_search(q8, 6.0, nprobe=2, max_results=16))
    assert bool((part[2] <= c_full).all()) and bool((part[2] > 16).any())


def test_remove_ids_matches_jax(corpus, q8):
    jidx, tidx = _pair(corpus, corpus)
    assert tidx.remove_ids([0, 5, 1499]) == jidx.remove_ids([0, 5, 1499]) == 3
    assert tidx.ntotal == 1497
    assert_same_layout(jidx, tidx)
    got = tidx.search(q8, k=5, nprobe=12)
    assert_same(got, jidx.search(q8, k=5, nprobe=12))
    assert int(got[0].max()) < 1497


def test_merge_from_matches_jax(corpus, q8):
    ja, ta = _pair(corpus, corpus[:750], keep_corpus=True)
    jb, tb = _pair(corpus, corpus[750:], keep_corpus=True)
    assert ta.merge_from(tb) == ja.merge_from(jb) == 750 and tb.ntotal == 0
    assert_same_layout(ja, ta)
    assert_same(ta.search(q8, k=5, nprobe=4), ja.search(q8, k=5, nprobe=4))
    whole = vq_tpu_torch.IVFBinaryIndex(_coarse(corpus, 12), keep_corpus=True)
    whole.add(corpus[:750])
    whole.add(corpus[750:])
    for name in ("codes", "corpus"):
        assert torch.equal(ta._pool.to_flat([name])[name], whole._pool.to_flat([name])[name])


def test_rebalance_requires_corpus(pair):
    for idx, err in ((pair[0], jerr.InvalidData), (pair[1], terr.InvalidData)):
        with pytest.raises(err, match="keep_corpus"):
            idx.rebalance(target_max=10)


def test_rebalance_with_corpus_matches_jax(corpus, q8):
    """``tests/test_ivf_binary.py``'s skewed case, with the split's lloyd
    stubbed in both packages (first k rows) so the two can be held
    exactly; packed bits move without a re-encode."""
    skew = corpus[np.random.default_rng(7).integers(0, 40, 800)]  # piled onto few lists
    rows = np.concatenate([corpus[:200], skew])
    jidx, tidx = _pair(corpus, rows, nlist=8, keep_corpus=True)
    before = tidx.bucket_stats()["max"]
    with pytest.MonkeyPatch.context() as mp:
        for mod, to in ((vq_tpu.ivf_flat, jnp.asarray), (vq_tpu_torch.ivf_flat, torch.as_tensor)):
            mp.setattr(mod, "lloyd", lambda x, k, to=to, **_: types.SimpleNamespace(
                centroids=to(x)[:k]))
        info = tidx.rebalance(target_max=max(64, before // 3), rounds=1)
        assert info == jidx.rebalance(target_max=max(64, before // 3), rounds=1)
    assert info["split"] >= 1 and tidx.bucket_stats()["max"] < before
    np.testing.assert_array_equal(tidx.coarse.numpy(), np.asarray(jidx.coarse))
    assert_same_layout(jidx, tidx)
    np.testing.assert_array_equal(tidx._pool.to_flat(["corpus"])["corpus"].numpy(), rows)
    got = tidx.search(q8, k=5, nprobe=tidx.nlist)
    assert_same(got, jidx.search(q8, k=5, nprobe=jidx.nlist))
    assert bool((got[0][:, 0] >= 0).all())


def test_seeded_train_and_rebalance(corpus):
    """The port's own seeded path (k-means++ Lloyd: K2, then K1)."""
    tidx = vq_tpu_torch.IVFBinaryIndex.train(corpus, 12, seed=3, keep_corpus=True)
    assert tidx.nlist == 12 and tidx.dim == 40 and tidx.code_words == 2
    tidx.add(corpus)
    info = tidx.rebalance(target_max=100)
    assert tidx.ntotal == 1500 and tidx.bucket_stats()["max"] <= 100 and info["split"] >= 1
    ids, _ = tidx.search(corpus[:4], k=1, nprobe=tidx.nlist, rerank=50)
    assert ids[:, 0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("keep", [False, True], ids=["codes", "kept_corpus"])
def test_checkpoints_load_across_packages(q8, pair, kept, keep, tmp_path):
    jidx, tidx = kept if keep else pair
    port_of_jax = vq_tpu_torch.IVFBinaryIndex.load(jidx.save(str(tmp_path / "jax")))
    assert repr(port_of_jax) == repr(tidx)
    assert_same_layout(jidx, port_of_jax)
    assert_same(port_of_jax.search(q8, k=5, nprobe=4), jidx.search(q8, k=5, nprobe=4))
    jax_of_port = vq_tpu.IVFBinaryIndex.load(tidx.save(str(tmp_path / "port")))
    assert_same_layout(jax_of_port, tidx)
    assert_same(tidx.search(q8, k=5, nprobe=4), jax_of_port.search(q8, k=5, nprobe=4))
    back = vq_tpu_torch.load(tidx.save(str(tmp_path / "again")))
    assert isinstance(back, vq_tpu_torch.IVFBinaryIndex) and back.ntotal == tidx.ntotal


def test_empty_index_round_trips(corpus, tmp_path):
    jidx = vq_tpu.IVFBinaryIndex(_coarse(corpus, 4), threshold=0.25)
    loaded = vq_tpu_torch.IVFBinaryIndex.load(jidx.save(str(tmp_path / "empty")))
    assert loaded.ntotal == 0 and loaded.nlist == 4 and loaded.bq.threshold == 0.25
    assert vq_tpu.IVFBinaryIndex.load(loaded.save(str(tmp_path / "back"))).ntotal == 0


def test_r4_kept_corpus_checkpoint_without_its_corpus(corpus, pair, tmp_path):
    """R4 split: the JAX loader fails with ``KeyError('corpus')``; the
    port refuses the checkpoint with ``InvalidData``."""
    path = pair[0].save(str(tmp_path / "codes_only"))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["__vq_header__"]).decode())
    header["config"]["keep_corpus"] = True
    arrays["__vq_header__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(KeyError, match="corpus"):
        vq_tpu.IVFBinaryIndex.load(path)
    with pytest.raises(terr.InvalidData, match="corpus"):
        vq_tpu_torch.IVFBinaryIndex.load(path)


def test_errors_match_jax(corpus):
    coarse = _coarse(corpus, 4)
    cases = [
        lambda m: m.IVFBinaryIndex(coarse).search(corpus[:2]),
        lambda m: m.IVFBinaryIndex(coarse).reconstruct([0]),
        lambda m: m.IVFBinaryIndex(coarse).add(corpus[:3, :39]),
        lambda m: m.IVFBinaryIndex(coarse).rebalance(),
        lambda m: m.IVFBinaryIndex(coarse, keep_corpus=True).rebalance(),
        lambda m: m.IVFBinaryIndex(coarse, threshold=float("nan")),
    ]
    for call in cases:
        with pytest.raises(jerr.VqError) as want:
            call(vq_tpu)
        with pytest.raises(terr.VqError) as got:
            call(vq_tpu_torch)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
