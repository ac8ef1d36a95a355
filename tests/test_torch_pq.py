"""``vq_tpu_torch.models.pq`` against ``vq_tpu.models.pq`` on the same numpy
inputs (JAX on the CPU backend, the port on its plain CPU paths).

Tiers, as in ``__graft_entry__._assert_search_parity``: codes exact;
search ids exact at every rank whose distance is unique in its row;
distances within 1e-5 relative (fp32 summation order of the ADC table
products). Warm-started training agrees to 1e-4; seeded training, whose
random streams differ by design, agrees on reconstruction MSE within 5%.
"""

import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu.models.pq as jpq
import vq_tpu_torch.errors as terr
import vq_tpu_torch.models.pq as tpq
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one thread for a module's tests: beside JAX's CPU thread
    pool and the other test workers, its intra-op pool oversubscribes the
    cores and runs these small problems many times slower. The other port
    test modules import it, which makes it theirs too."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def assert_search_parity(got, want, *, rtol=1e-5, atol=1e-6):
    """Tie-aware search parity of ``(ids, dists)`` pairs."""
    gids, gd = (np.asarray(a) for a in got)
    wids, wd = (np.asarray(a) for a in want)
    assert gids.shape == wids.shape
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    unique = (wd[:, :, None] == wd[:, None, :]).sum(-1) == 1
    np.testing.assert_array_equal(
        np.where(unique, gids, -1), np.where(unique, wids, -1)
    )


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    m, k, s = 4, 32, 8
    cb = rng.standard_normal((m, k, s)).astype(np.float32)
    x = rng.standard_normal((2000, m * s)).astype(np.float32)
    q = rng.standard_normal((7, m * s)).astype(np.float32)
    return cb, x, q


def _clusters(seed=12, n=1200, m=4, k=8, s=4):
    """Well-separated clusters around known centres, so no cluster empties
    and a warm start converges to the same fixed point in both packages."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((m, k, s)).astype(np.float32) * 10
    lab = rng.integers(0, k, (n, m))
    x = centres[np.arange(m)[None, :], lab] + rng.normal(0, 0.3, (n, m, s))
    lab[:k] = np.arange(k)[:, None]  # every cluster holds a row
    x[:k] = centres.transpose(1, 0, 2)
    init = centres + rng.normal(0, 0.5, centres.shape)
    return x.reshape(n, m * s).astype(np.float32), init.astype(np.float32)


def test_pq_train_warm_start_matches_jax():
    x, init = _clusters()
    want = jpq.pq_train(x, 4, 8, max_iters=8, use_pallas=False, init_codebooks=init)
    got = tpq.pq_train(x, 4, 8, max_iters=8, init_codebooks=init)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k", [(4, 16), (8, 8)])
def test_pq_train_seeded_mse_matches_jax(m, k):
    rng = np.random.default_rng(13)
    x = rng.random((1500, 32), dtype=np.float32)
    jq = jpq.ProductQuantizer(x, m, k, max_iters=10, seed=3)
    tq = tpq.ProductQuantizer(x, m, k, max_iters=10, seed=3)
    mse_j = float(np.mean((np.asarray(jq.decode(jq.encode(x))) - x) ** 2))
    mse_t = float(np.mean((tq.decode(tq.encode(x)).numpy() - x) ** 2))
    assert abs(mse_t - mse_j) <= 0.05 * mse_j, (mse_t, mse_j)


@pytest.mark.parametrize("metric", ["euclidean", "squared_euclidean", "manhattan", "cosine"])
def test_pq_encode_decode_match_jax(setup, metric):
    cb, x, _ = setup
    want = np.asarray(jpq.pq_encode(x, cb, metric))
    got = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), metric)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpq.pq_decode(got, torch.from_numpy(cb)).numpy(),
        np.asarray(jpq.pq_decode(want, cb)),
    )


def test_pq_encode_half_input_matches_f32(setup):
    cb, x, _ = setup
    pq = tpq.ProductQuantizer(codebooks=cb)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(pq.encode(xb), pq.encode(xb.to(torch.float32)))


@pytest.mark.parametrize("metric", ["euclidean", "squared_euclidean", "manhattan", "cosine"])
def test_adc_tables_match_jax(setup, metric):
    cb, _, q = setup
    want = np.asarray(jpq.ProductQuantizer(codebooks=cb, distance=metric).adc_tables(q))
    got = tpq.ProductQuantizer(codebooks=cb, distance=metric).adc_tables(q)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# route: (metric, k, rerank, chunk, pack_bits). The port's fused route is
# K5's plain version on the CPU; the JAX package runs dense/chunked here.
_ROUTES = {
    "fused": ("euclidean", 10, 0, 262_144, 8),
    "fused_sq": ("squared_euclidean", 10, 0, 262_144, 8),
    "fused_l1": ("manhattan", 10, 0, 262_144, 8),
    "fused_rerank": ("euclidean", 5, 40, 262_144, 8),
    "fused_packed": ("euclidean", 10, 0, 262_144, 4),
    "chunked": ("cosine", 10, 0, 500, 8),
    "chunked_rerank": ("cosine", 5, 40, 700, 8),
    "dense": ("cosine", 10, 0, 262_144, 8),
    "dense_rerank": ("cosine", 5, 40, 262_144, 8),
    "dense_fetch_gt_128": ("euclidean", 150, 0, 262_144, 8),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_adc_search_matches_jax(setup, route):
    from vq_tpu.ops.packing import pack_codes

    metric, k, rerank, chunk, pack_bits = _ROUTES[route]
    cb, x, q = setup
    if pack_bits < 8:
        cb = cb[:, :16]
    jq = jpq.ProductQuantizer(codebooks=cb, distance=metric)
    tq = tpq.ProductQuantizer(codebooks=cb, distance=metric)
    codes = np.asarray(jq.encode(x))
    if pack_bits < 8:
        codes = np.asarray(pack_codes(codes, pack_bits))
    kw = dict(k=k, rerank=rerank, chunk=chunk, pack_bits=pack_bits)
    want = jq.adc_search(q, codes, corpus=x if rerank else None, **kw)
    got = tq.adc_search(q, codes, corpus=x if rerank else None, **kw)
    assert_search_parity(got, want)


_BAD = {
    "dim_not_divisible": lambda P: P.pq_train(np.ones((40, 10), np.float32), 3, 4),
    "m_above_dim": lambda P: P.pq_train(np.ones((40, 2), np.float32), 4, 4),
    "m_zero": lambda P: P.pq_train(np.ones((40, 8), np.float32), 0, 4),
    "k_above_n": lambda P: P.pq_train(np.ones((4, 8), np.float32), 2, 8),
    "empty": lambda P: P.pq_train(np.zeros((0, 8), np.float32), 2, 4),
    "ragged": lambda P: P.pq_train([[1.0, 2.0], [3.0]], 1, 1),
    "three_d": lambda P: P.pq_train(np.ones((2, 4, 4), np.float32), 2, 1),
    "encode_dim": lambda P: P.pq_encode(np.ones((3, 6), np.float32), np.ones((2, 4, 4), np.float32)),
    "decode_width": lambda P: P.pq_decode(np.zeros((3, 3), np.int32), np.ones((2, 4, 4), np.float32)),
    "bad_metric": lambda P: P.ProductQuantizer(codebooks=np.ones((2, 4, 4), np.float32), distance="hamming"),
    "bad_codebooks": lambda P: P.ProductQuantizer(codebooks=np.ones((4, 4), np.float32)),
    "no_data": lambda P: P.ProductQuantizer(num_subspaces=2, num_centroids=4),
    "query_dim": lambda P: P.ProductQuantizer(codebooks=np.ones((2, 4, 4), np.float32)).adc_tables(np.ones((2, 5), np.float32)),
    "bad_precision": lambda P: P.pq_encode(np.ones((3, 8), np.float32), np.ones((2, 4, 4), np.float32), precision="fp8"),
}
_ERRORS = ("DimensionMismatch", "EmptyInput", "InvalidParameter", "InvalidData")


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_inputs_raise_like_jax(case):
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](jpq)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](tpq)
    assert type(got.value).__name__ == type(want.value).__name__
    assert type(got.value).__name__ in _ERRORS
    assert str(got.value) == str(want.value)


def test_unported_precision_raises():
    """Every precision name of the JAX package is ported; the kernel
    wrapper takes only the kernels' own names and refuses the rest."""
    x, cb = torch.ones((3, 8)), torch.ones((2, 4, 4))
    assert tpq.pq_encode(x, cb, precision="high").shape == (3, 2)
    with pytest.raises(terr.InvalidParameter, match="must be one of"):
        ck.pq_encode_fused(x, cb, precision="high")


def test_lloyd_batched_warm_start_matches_jax():
    from vq_tpu.ops.kmeans import lloyd_batched as j_lloyd_batched
    from vq_tpu_torch.ops.kmeans import lloyd_batched

    x, init = _clusters(seed=14)
    data = np.ascontiguousarray(x.reshape(-1, 4, 4).transpose(1, 0, 2))  # [m, n, s]
    want_cb, want_it, want_conv = j_lloyd_batched(data, 8, max_iters=8, init_centroids=init)
    got_cb, got_it, got_conv = lloyd_batched(data, 8, max_iters=8, init_centroids=init)
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv))


@pytest.mark.parametrize("metric", ["euclidean", "squared_euclidean", "manhattan", "cosine"])
def test_pairwise_matches_jax(setup, metric):
    from vq_tpu.ops.distance import pairwise as j_pairwise
    from vq_tpu_torch.ops.distance import pairwise

    _, x, q = setup
    want = np.asarray(j_pairwise(q, x[:300], metric))
    got = pairwise(torch.from_numpy(q), torch.from_numpy(x[:300]), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("nbits,m", [(1, 13), (2, 7), (4, 5), (8, 3)])
def test_packing_bit_identical_to_jax(nbits, m):
    from vq_tpu.ops.packing import pack_codes as j_pack, unpack_codes as j_unpack
    from vq_tpu_torch.ops.packing import pack_codes, unpack_codes

    codes = np.random.default_rng(15).integers(0, 1 << nbits, (50, m)).astype(np.int32)
    want = np.asarray(j_pack(codes, nbits))
    got = pack_codes(torch.from_numpy(codes), nbits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        unpack_codes(got, nbits, m).numpy(), np.asarray(j_unpack(want, nbits, m))
    )
