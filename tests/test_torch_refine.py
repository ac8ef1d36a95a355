"""``vq_tpu_torch.RefineIndex`` against ``vq_tpu.RefineIndex`` on the same
seeded numpy inputs (JAX on the CPU; the port's K1 / K3 / K4 / K5 / K7
plain versions), mirroring ``tests/test_refine.py`` without its factory
class, which needs ``index_factory``.

Parity runs from the same trained base: the JAX package's empty base
index, saved and loaded by both packages, wrapped by each package's
``RefineIndex`` and filled with the same rows (a residual refiner's PQ
carried from the JAX package's ``train_pq``).

Tolerances:

* stored codes: flat rows and SQ8 codes exact; residual PQ codes equal
  at >= 99.9% of the entries (each residual is ``x - reconstruct(x)``,
  two packages' f32 decodes, so a code may flip at a float near tie);
* searches: values rtol 1e-5 / atol 1e-4 (the exact scores sum d terms
  in each package's own order), ids equal at every rank whose value is
  farther than that from every other value of its row
  (``assert_probe_parity``); with the residual refiner, values
  rtol 1e-4 / atol 1e-3;
* checkpoints written by either package searched by the other: the same
  tolerances.

R9: ``"euclidean"`` ranks by ``sqrt(d²)``, ties by candidate position,
as the reference does, so the port's ids are the reference's bit for
bit; ranking by ``d²`` would differ where two squared distances one
ulp apart share a root (``test_euclidean_ranks_by_the_root_R9``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.refine as jref
import vq_tpu_torch
import vq_tpu_torch.refine as tref
from test_torch_ivf_flat import assert_probe_parity
from vq_tpu_torch import (
    BatchPipeline,
    BinaryIndex,
    IVFPQIndex,
    PQIndex,
    ProductQuantizer,
    RefineIndex,
    RQIndex,
    ResidualQuantizer,
    SQIndex,
    load_index,
)
from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

D, K = 24, 10
_TOL = {"rtol": 1e-5, "atol": 1e-4}
_RES_TOL = {"rtol": 1e-4, "atol": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 3.0, (12, D)).astype(np.float32)
    which = rng.integers(0, 12, 2400)
    x = (centers[which] + rng.normal(0, 0.3, (2400, D))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 16)] + rng.normal(0, 0.3, (16, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def cbs(data):
    """PQ 4x16 codebooks trained by the port (4 iterations, seed 1)."""
    return vq_tpu_torch.pq_train(data[0], 4, 16, max_iters=4, seed=1).numpy()


@pytest.fixture(scope="module")
def empty_bases(data, tmp_path_factory):
    """Empty trained JAX bases saved once: ``{name: path}``."""
    x, _ = data
    d = tmp_path_factory.mktemp("refine_bases")
    jcbs = np.asarray(vq_tpu.ProductQuantizer(x, 4, 16, max_iters=4, seed=1).codebooks)
    return {
        "ivfpq": vq_tpu.IVFPQIndex.train(x, 8, 4, 16, max_iters=4, seed=2).save(str(d / "ivfpq")),
        "ivfpq_dot": vq_tpu.IVFPQIndex.train(x, 8, 4, 16, max_iters=4, seed=8,
                                             metric="dot").save(str(d / "dot")),
        "pq_euclidean": vq_tpu.PQIndex(vq_tpu.ProductQuantizer(
            codebooks=jcbs, distance="euclidean")).save(str(d / "pqe")),
    }


def _gt(x, q, k=K):
    return np.argsort(((x[None, :, :] - q[:, None, :]) ** 2).sum(-1), axis=1)[:, :k]


def _recall(ids, gt):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[i]) & set(gt[i])) / gt.shape[1] for i in range(len(gt))])


def _pq_base(cbs):
    return PQIndex(ProductQuantizer(codebooks=cbs))


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------


_REFINERS = [("flat", {}), ("flat", {"store_dtype": "bfloat16"}),
             ("flat", {"store_dtype": "float16"}), ("sq8", {}), ("pq", {})]


def _both(empty_bases, name, x, refiner, kw):
    """The JAX and the port's RefineIndex over the same empty base, both
    filled with ``x``."""
    jbase, tbase = vq_tpu.load_index(empty_bases[name]), load_index(empty_bases[name])
    if refiner == "pq":
        j = vq_tpu.RefineIndex.train_pq(jbase, x, 4, 16, max_iters=3, seed=10)
        t = RefineIndex(tbase, ProductQuantizer(codebooks=np.asarray(j.refine_pq.codebooks)))
    else:
        j, t = vq_tpu.RefineIndex(jbase, refiner, **kw), RefineIndex(tbase, refiner, **kw)
    j.add(x)
    t.add(x)
    return j, t


@pytest.mark.parametrize("refiner,kw", _REFINERS,
                         ids=["flat", "flat_bf16", "flat_f16", "sq8", "residual_pq"])
def test_ivfpq_base_matches_jax(data, empty_bases, refiner, kw):
    x, q = data
    j, t = _both(empty_bases, "ivfpq", x, refiner, kw)
    assert t.kind == j.kind and t.metric == j.metric == "squared_euclidean"
    jc, tc = np.asarray(j._codes.astype(jnp.float32) if refiner == "flat" else j._codes), t._codes
    if refiner == "pq":
        assert (tc.numpy() == jc).mean() >= 0.999
    else:
        np.testing.assert_array_equal(tc.to(torch.float32).numpy() if refiner == "flat"
                                      else tc.numpy(), jc)
    if refiner == "sq8":
        np.testing.assert_array_equal(t.sq.mins.numpy(), np.asarray(j.sq.mins))
    got, want = t.search(q, K, k_factor=4, nprobe=4), j.search(q, K, k_factor=4, nprobe=4)
    assert_probe_parity(got, want, **(_RES_TOL if refiner == "pq" else _TOL))
    rec = t.reconstruct(np.arange(50))
    np.testing.assert_allclose(rec.numpy(), np.asarray(j.reconstruct(np.arange(50))), rtol=1e-5,
                               atol=1e-4)


def test_dot_base_matches_jax(data, empty_bases):
    x, q = data
    j, t = _both(empty_bases, "ivfpq_dot", x, "flat", {})
    assert t.metric == "dot"
    got, want = t.search(q, K, k_factor=8, nprobe=8), j.search(q, K, k_factor=8, nprobe=8)
    assert_probe_parity(got, want, rtol=1e-5, atol=1e-3)  # scores up to ~300
    assert (np.diff(got[1].numpy(), axis=1) <= 1e-5).all()  # descending


def test_euclidean_base_matches_jax(data, empty_bases):
    x, q = data
    j, t = _both(empty_bases, "pq_euclidean", x, "flat", {})
    assert t.metric == j.metric == "euclidean"
    assert_probe_parity(t.search(q, K, k_factor=4), j.search(q, K, k_factor=4), **_TOL)


def test_euclidean_ranks_by_the_root_R9():
    """R9: rows 0 and 1 lie at squared distances 4.0407996 and 4.0408001
    from the query (float32 neighbours) whose roots are both 2.010174. The
    base offers row 1 first; the reference ranks by the root, so the tie
    falls to candidate order and row 1 wins. The port does the same, bit
    for bit, where ranking by d² would give row 0."""
    rows = np.array([[2.010174, 0.0], [2.010174, 6.9e-4]], np.float32)
    q = np.zeros((1, 2), np.float32)
    d2 = ((rows - q) ** 2).sum(-1, dtype=np.float32)
    assert d2[0] < d2[1] and np.sqrt(d2[0]) == np.sqrt(d2[1])
    order = np.array([[1, 0]], np.int32)

    def jbase(qq, *a):
        return jnp.asarray(order), jnp.zeros((1, 2))

    def tbase(qq, *a):
        return torch.from_numpy(order), torch.zeros(1, 2)

    want = jref._build_refine_fn(jbase, 0, lambda c: c.astype(jnp.float32), None, "euclidean", 1)(
        jnp.asarray(q), jnp.asarray(rows))
    got = tref._build_refine_fn(tbase, 0, lambda c: c.to(torch.float32), None, "euclidean", 1)(
        torch.from_numpy(q), torch.from_numpy(rows))
    assert int(want[0][0, 0]) == int(got[0][0, 0]) == 1  # the root's tie, by position
    assert float(want[1][0, 0]) == float(got[1][0, 0]) == float(np.sqrt(d2[1]))
    by_d2 = tref._build_refine_fn(tbase, 0, lambda c: c.to(torch.float32), None,
                                  "squared_euclidean", 1)(torch.from_numpy(q), torch.from_numpy(rows))
    assert int(by_d2[0][0, 0]) == 0  # ranking by d² would split from the reference


@pytest.mark.parametrize("refiner,kw", _REFINERS,
                         ids=["flat", "flat_bf16", "flat_f16", "sq8", "residual_pq"])
def test_checkpoints_load_both_ways(data, empty_bases, tmp_path, refiner, kw):
    x, q = data
    j, t = _both(empty_bases, "ivfpq", x[:1200], refiner, kw)
    from_jax = load_index(j.save(str(tmp_path / "j")))
    assert isinstance(from_jax, RefineIndex) and from_jax.kind == j.kind
    tol = _RES_TOL if refiner == "pq" else _TOL
    assert_probe_parity(from_jax.search(q, K, k_factor=4, nprobe=4),
                        j.search(q, K, k_factor=4, nprobe=4), **tol)
    p = t.save(str(tmp_path / "t"))
    assert (tmp_path / "t.base.npz").exists()
    from_port = vq_tpu.load_index(p)
    assert isinstance(from_port, vq_tpu.RefineIndex) and from_port.store_dtype == t.store_dtype
    assert_probe_parity(t.search(q, K, k_factor=4, nprobe=4),
                        from_port.search(q, K, k_factor=4, nprobe=4), **tol)
    again = RefineIndex.load(p)
    got, want = again.search(q, K, k_factor=4, nprobe=4), t.search(q, K, k_factor=4, nprobe=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_out_of_sync_checkpoint_rejected(data, empty_bases, tmp_path):
    x, _ = data
    j, _ = _both(empty_bases, "ivfpq", x[:100], "flat", {})
    p = j.save(str(tmp_path / "r"))
    vq_tpu.load_index(empty_bases["ivfpq"]).save(str(tmp_path / "r.base"))  # an empty base
    with pytest.raises(InvalidData):
        load_index(p)


# ---------------------------------------------------------------------------
# The JAX package's surface, on the port.
# ---------------------------------------------------------------------------


class TestFlatRefiner:
    def test_matches_keep_corpus_rerank_exactly(self, data, cbs):
        x, q = data
        ref = RefineIndex(_pq_base(cbs), "flat")
        ref.add(x)
        kept = PQIndex(ProductQuantizer(codebooks=cbs), keep_corpus=True)
        kept.add(x)
        i_r, d_r = ref.search(q, K, k_factor=4)
        i_k, d_k = kept.search(q, K, rerank=4 * K)
        np.testing.assert_array_equal(i_r.numpy(), i_k.numpy())
        np.testing.assert_allclose(d_r.numpy(), d_k.numpy(), atol=1e-4)

    def test_bf16_near_exact(self, data, cbs):
        x, q = data
        base = _pq_base(cbs)
        ref = RefineIndex(base, "flat", store_dtype="bfloat16")
        ref.add(x)
        gt = _gt(x, q)
        assert _recall(ref.search(q, K, k_factor=8)[0], gt) > _recall(base.search(q, K)[0], gt)
        assert ref.code_bytes_per_vector == 2 * D and ref._codes.dtype == torch.bfloat16

    def test_binary_base(self, data):
        x, q = data
        ref = RefineIndex(BinaryIndex(D), "flat")
        ref.add(x)
        ids, d = ref.search(q, K, k_factor=8)
        assert _recall(ids, _gt(x, q)) > 0.5
        assert np.all(np.diff(d.numpy(), axis=1) >= -1e-6)

    def test_bad_store_dtype(self, cbs):
        with pytest.raises(InvalidParameter):
            RefineIndex(_pq_base(cbs), "flat", store_dtype="int8")
        with pytest.raises(InvalidParameter):
            RefineIndex(_pq_base(cbs), "nope")
        with pytest.raises(InvalidParameter):
            RefineIndex(_pq_base(cbs), "flat", metric="hamming")
        with pytest.raises(InvalidParameter):
            RefineIndex(object(), "flat")


class TestSQ8Refiner:
    def test_improves_base_recall(self, data, cbs):
        x, q = data
        base = _pq_base(cbs)
        ref = RefineIndex(base, "sq8")
        ref.add(x)
        gt = _gt(x, q)
        assert _recall(ref.search(q, K, k_factor=8)[0], gt) > _recall(base.search(q, K)[0], gt)
        assert ref.code_bytes_per_vector == D

    def test_explicit_train_data(self, data, cbs):
        x, q = data
        ref = RefineIndex(_pq_base(cbs), "sq8", sq_train_data=x[:500])
        assert ref.sq is not None
        ref.add(x)
        assert tuple(ref.search(q, K, k_factor=4)[0].shape) == (len(q), K)


class TestResidualPQRefiner:
    def test_ivfpqr_improves_recall_and_recon(self, data):
        x, q = data
        base = IVFPQIndex.train(x, 8, 4, 16, max_iters=4, seed=2)
        ref = RefineIndex.train_pq(base, x, 8, 16, max_iters=4, seed=3)
        ref.add(x)
        gt = _gt(x, q)
        i_b, _ = base.search(q, K, nprobe=4)
        i_r, _ = ref.search(q, K, k_factor=8, nprobe=4)
        assert _recall(i_r, gt) >= _recall(i_b, gt)
        ids = np.arange(200)
        eb = float(((base.reconstruct(ids).numpy() - x[:200]) ** 2).sum())
        er = float(((ref.reconstruct(ids).numpy() - x[:200]) ** 2).sum())
        assert er < eb
        assert ref.code_bytes_per_vector == 8

    def test_codec_approx_matches_jax(self, data, empty_bases):
        """The residual training set: the IVF-PQ base's coding of rows it
        does not hold (K1, then K4), equal to the JAX package's."""
        x, _ = data
        jbase, tbase = vq_tpu.load_index(empty_bases["ivfpq"]), load_index(empty_bases["ivfpq"])
        want = np.asarray(jref._codec_approx(jbase, jnp.asarray(x[:300])))
        np.testing.assert_allclose(tref._codec_approx(tbase, torch.from_numpy(x[:300])).numpy(),
                                   want, rtol=1e-5, atol=1e-5)

    def test_pq_base_residual_refine(self, data, cbs):
        x, q = data
        base = _pq_base(cbs)
        ref = RefineIndex.train_pq(base, x, 4, 16, max_iters=4, seed=4)
        ref.add(x)
        gt = _gt(x, q)
        assert _recall(ref.search(q, K, k_factor=8)[0], gt) >= _recall(base.search(q, K)[0], gt)

    def test_rq_and_sq_bases_supported(self, data):
        x, q = data
        ref = RefineIndex.train_pq(RQIndex(ResidualQuantizer(x, 2, 16, max_iters=3, seed=5)),
                                   x, 4, 16, max_iters=3, seed=6)
        ref.add(x)
        assert tuple(ref.search(q, K, k_factor=4)[0].shape) == (len(q), K)
        sq_base = SQIndex(vq_tpu_torch.PerDimScalarQuantizer.from_data(x))
        ref2 = RefineIndex.train_pq(sq_base, x, 4, 16, max_iters=3, seed=7)
        ref2.add(x)
        assert tuple(ref2.search(q, K, k_factor=4)[0].shape) == (len(q), K)

    def test_residual_needs_reconstruct_core(self, data, cbs):
        with pytest.raises(InvalidParameter):
            RefineIndex(BinaryIndex(D), ProductQuantizer(codebooks=cbs))
        with pytest.raises(InvalidParameter):
            RefineIndex.train_pq(BinaryIndex(D), data[0], 4, 16)


class TestDotMetric:
    def test_descending_scores_and_exact_rerank(self, data):
        x, q = data
        base = IVFPQIndex.train(x, 8, 4, 16, max_iters=4, seed=8, metric="dot")
        ref = RefineIndex(base, "flat")
        ref.add(x)
        ids, d = ref.search(q, K, k_factor=8, nprobe=8)
        d = d.numpy()
        assert np.all(np.diff(d, axis=1) <= 1e-5)
        top = ids[:, 0].numpy()
        np.testing.assert_allclose(d[:, 0], np.sum(x[top] * q, axis=-1), rtol=1e-5)


class TestContract:
    def test_prefilled_base_rejected(self, data, cbs):
        base = _pq_base(cbs)
        base.add(data[0])
        with pytest.raises(InvalidData):
            RefineIndex(base, "flat")

    def test_out_of_sync_codes(self, data, cbs):
        x, q = data
        base = _pq_base(cbs)
        ref = RefineIndex(base, "flat")
        ref.add(x[:100])
        base.add(x[100:200])  # bypass the wrapper
        with pytest.raises(InvalidData):
            ref.search(q, K)

    def test_empty_raises(self, data, cbs):
        ref = RefineIndex(_pq_base(cbs), "flat")
        with pytest.raises(EmptyInput):
            ref.search(data[1], K)
        with pytest.raises(EmptyInput):
            ref.reconstruct([0])
        with pytest.raises(EmptyInput):
            ref.remove_ids([0])

    def test_dim_mismatch(self, data):
        x, q = data
        ref = RefineIndex(BinaryIndex(D), "flat")
        ref.add(x)
        with pytest.raises(DimensionMismatch):
            ref.search(q[:, :-1], K)
        with pytest.raises(DimensionMismatch):
            ref.add(x[:, :-1])

    def test_bad_k_factor(self, data):
        x, q = data
        ref = RefineIndex(BinaryIndex(D), "flat")
        ref.add(x)
        with pytest.raises(InvalidParameter):
            ref.search(q, K, k_factor=0.5)

    def test_pool_smaller_than_k_pads(self, data):
        x, q = data
        ref = RefineIndex(BinaryIndex(D), "flat")
        ref.add(x[:4])
        ids, d = ref.search(q, 50)
        assert tuple(ids.shape) == (len(q), 50)
        assert int((ids == -1).sum()) > 0 and bool(torch.isinf(d).any())

    def test_remove_ids_keeps_alignment(self, data, cbs):
        x, q = data
        ref = RefineIndex(_pq_base(cbs), "flat")
        ref.add(x[:200])
        assert ref.remove_ids([0, 5, 7]) == 3 and ref.ntotal == 197
        np.testing.assert_allclose(ref.reconstruct([0]).numpy(), x[1:2], atol=1e-6)
        assert tuple(ref.search(q, K, k_factor=4)[0].shape) == (len(q), K)

    def test_search_and_reconstruct(self, data, cbs):
        x, q = data
        ref = RefineIndex(_pq_base(cbs), "flat")
        ref.add(x[:200])
        ids, vals, rec = ref.search_and_reconstruct(q[:3], k=4)
        np.testing.assert_array_equal(rec.numpy(), x[ids.numpy()])

    def test_merge_from(self, data, cbs):
        x, _ = data
        a, b = RefineIndex(_pq_base(cbs), "flat"), RefineIndex(_pq_base(cbs), "flat")
        a.add(x[:300])
        b.add(x[300:500])
        assert a.merge_from(b) == 200 and a.ntotal == 500 and b.ntotal == 0
        np.testing.assert_allclose(a.reconstruct([300]).numpy(), x[300:301], atol=1e-6)

    def test_merge_unfitted_sq8_adopts_quantizer(self, data, cbs):
        x, q = data
        a, b = RefineIndex(_pq_base(cbs), "sq8"), RefineIndex(_pq_base(cbs), "sq8")
        b.add(x[:300])
        a.merge_from(b)
        assert a.sq is not None
        assert tuple(a.search(q, K, k_factor=4)[0].shape) == (len(q), K)
        np.testing.assert_allclose(a.reconstruct([0]).numpy(),
                                   a.sq.dequantize(a.sq.quantize(x[:1])).numpy(), atol=1e-6)

    def test_merge_kind_mismatch(self, data, cbs):
        x, _ = data
        a, b = RefineIndex(_pq_base(cbs), "flat"), RefineIndex(_pq_base(cbs), "sq8")
        a.add(x[:50])
        b.add(x[:50])
        with pytest.raises(InvalidData):
            a.merge_from(b)

    def test_repr(self, cbs):
        assert repr(RefineIndex(_pq_base(cbs), "sq8")).startswith("RefineIndex(kind='sq8'")


class TestServing:
    def test_pipeline_parity(self, data):
        x, q = data
        base = IVFPQIndex.train(x, 8, 4, 16, max_iters=4, seed=11)
        ref = RefineIndex(base, "sq8")
        ref.add(x)
        pipe = BatchPipeline(ref, k=K, k_factor=4, nprobe=4)
        qs = np.stack([q, q + 0.01, q - 0.01])
        ids_p, vals_p = pipe.search(qs)
        for t in range(3):
            ids_s, vals_s = ref.search(qs[t], K, k_factor=4, nprobe=4)
            assert torch.equal(ids_p[t], ids_s) and torch.equal(vals_p[t], vals_s)
