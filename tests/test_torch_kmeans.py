"""``vq_tpu_torch.ops.kmeans`` and its kernels K1 (assign) and K2 (Lloyd
accumulate) against the JAX package, on the same seeded numpy inputs.

On the CPU the port's kernel wrappers run their plain versions, the
arithmetic the CUDA kernels are held to on the card
(``test_torch_cuda.py``); here they are held to the Pallas kernels in
interpret mode, and ``lloyd`` to the JAX ``lloyd`` (``use_pallas=False``).

Tolerances:

* codes exact, except where the two candidates' scores, recomputed in
  float64, lie within 1e-5 of the score scale ``||x||^2 + ||c||^2``
  (fp32 summation order of a d-term dot; no such near tie occurs on
  these inputs, the allowance only keeps the check honest);
* distances at rtol 1e-5 / atol 1e-5 * scale (the same order);
* K2 counts exact, sums at rtol 1e-5 / atol 1e-4, inertia at rtol 1e-5
  (the Pallas kernel's own summation order); the plain K2 against a
  float32 loop of its segmented order, bit for bit;
* warm-started ``lloyd``: assignments, iteration counts and the
  converged flag exact, centroids within 1e-5 (absolute and relative),
  inertia within 1e-7 * sum ||x||^2 (each distance carries the fp32
  rounding of ||x||^2, far larger than the distance itself);
* seeded ``lloyd``, whose random streams differ by design (torch cannot
  replay threefry): inertia within 5%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu.ops.kmeans as jkm
import vq_tpu_torch.errors as terr
import vq_tpu_torch.ops.kmeans as tkm
from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.ops import cuda_kernels as ck
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_codes_match(got, want, x, c, rtol=1e-5):
    """Codes equal except at float64-verified near ties."""
    got, want = np.asarray(got), np.asarray(want)
    rows = np.nonzero(got != want)[0]
    if rows.size == 0:
        return
    xd = np.asarray(x, np.float64)[rows]
    cd = np.asarray(c, np.float64)

    def score(idx):
        cj = cd[idx]
        return (cj * cj).sum(-1) - 2.0 * (xd * cj).sum(-1)

    scale = (xd * xd).sum(-1) + (cd[want[rows]] ** 2).sum(-1)
    gap = np.abs(score(got[rows]) - score(want[rows]))
    assert np.all(gap <= rtol * np.maximum(scale, 1.0)), (rows, gap)


# (n, k, d): k below one TPU lane tile, at a full 256, and past two
# 512-wide k tiles at the IVF width d = 128.
_ASSIGN_SHAPES = [(333, 7, 16), (500, 256, 32), (257, 1000, 128)]


@pytest.mark.parametrize("shape", _ASSIGN_SHAPES, ids=lambda s: "n%d-k%d-d%d" % s)
def test_assign_matches_pallas(shape):
    n, k, d = shape
    rng = np.random.default_rng(30 + k)
    x = rng.random((n, d), dtype=np.float32)
    c = rng.random((k, d), dtype=np.float32)
    want_codes, want_d = pk.assign_fused(x, c, block_rows=256, interpret=True)
    got_codes, got_d = ck.assign_fused(_t(x), _t(c))
    assert got_codes.dtype == torch.int32 and got_d.dtype == torch.float32
    assert_codes_match(got_codes.numpy(), want_codes, x, c)
    scale = float((x * x).sum(-1).max() + (c * c).sum(-1).max())
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5 * scale)


def test_assign_bf16_matches_pallas():
    rng = np.random.default_rng(34)
    x = rng.random((300, 32), dtype=np.float32)
    c = rng.random((100, 32), dtype=np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want_codes, want_d = pk.assign_fused(xb, c, block_rows=256, interpret=True)
    got_codes, got_d = ck.assign_fused(_t(x).to(torch.bfloat16), _t(c))
    x_up = np.asarray(xb.astype(jnp.float32))
    assert_codes_match(got_codes.numpy(), want_codes, x_up, c)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


def test_assign_across_centroid_chunks_keeps_lowest_index():
    """The TPU's k-chunked assign merges chunk minima on unclamped scores;
    the port scans all k at once. Planted duplicate centroids 10 and 650
    tie across the chunk-0 / chunk-2 boundary: the lowest index wins."""
    rng = np.random.default_rng(35)
    x = rng.random((333, 24), dtype=np.float32)
    c = rng.random((700, 24), dtype=np.float32)
    c[650] = c[10]
    x[:5] = c[10]  # rows sitting on the duplicated centroid
    want_codes, want_d = pk._assign_fused_chunked_jit(
        jnp.asarray(x), jnp.asarray(c), 256, 128, True
    )
    got_codes, got_d = ck.assign_fused(_t(x), _t(c))
    assert_codes_match(got_codes.numpy(), want_codes, x, c)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)
    assert 650 not in got_codes.numpy()
    assert (got_codes.numpy()[:5] == 10).all()


def test_assign_nan_and_ties_follow_int2():
    """NaN centroids never win, duplicates go to the lowest index, and a
    NaN row (every score NaN) takes index 0 with a NaN distance: the
    Pallas int2 path (the XLA fallback lets NaN win, ROADMAP R1)."""
    rng = np.random.default_rng(36)
    c = rng.random((9, 4), dtype=np.float32)
    c[5] = c[2]
    c[0, 1] = np.nan
    x = np.concatenate([np.nan_to_num(c, nan=0.5), rng.random((7, 4), dtype=np.float32)])
    x[-1, 2] = np.nan
    want_codes, want_d = pk.assign_fused(x, c, block_rows=8, interpret=True)
    got_codes, got_d = ck.assign_fused(_t(x), _t(c))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-6)
    assert got_codes.numpy()[-1] == 0 and np.isnan(got_d.numpy()[-1])
    assert not np.isin(got_codes.numpy()[:-1], [0, 5]).any()


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_assign_large_k_matches_xla(dtype):
    """k = 65536, past every TPU VMEM budget: one launch on the card, and
    the same codes as the JAX XLA assign here (f16 data is upcast)."""
    rng = np.random.default_rng(37)
    x = rng.random((48, 16), dtype=np.float32).astype(dtype)
    c = rng.random((65536, 16), dtype=np.float32)
    want_codes, want_d = jkm.assign(x, c, use_pallas=False)
    got_codes, got_d = tkm.assign(x, c)
    assert_codes_match(got_codes.numpy(), want_codes, x.astype(np.float32), c)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [700, 131, 1025])
def test_lloyd_accumulate_matches_pallas(n):
    rng = np.random.default_rng(38)
    x = rng.random((n, 32), dtype=np.float32)
    c = rng.random((40, 32), dtype=np.float32)
    sums_w, counts_w, inertia_w = pk.lloyd_accumulate_fused(x, c, block_rows=256, interpret=True)
    sums, counts, inertia = ck.lloyd_accumulate_fused(_t(x), _t(c))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_w))
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_w), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(inertia_w), rtol=1e-5)
    assert float(counts.sum()) == n


@pytest.mark.parametrize("n", [700, 131, 1025])
def test_weighted_lloyd_accumulate_matches_jax(n):
    """K2 with sample weights (plain version here) against the JAX
    package's weighted accumulate (``_assign_accumulate``, a fixed-order
    XLA scan): Σ w·x, Σ w and Σ w·d to fp32 summation order."""
    rng = np.random.default_rng(50)
    x = rng.random((n, 32), dtype=np.float32)
    c = rng.random((40, 32), dtype=np.float32)
    w = rng.uniform(0.1, 3.0, n).astype(np.float32)
    sums_w, counts_w, inertia_w = jkm._assign_accumulate(x, c, 256, jnp.asarray(w))
    sums, counts, inertia = ck.lloyd_accumulate_fused(_t(x), _t(c), _t(w))
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_w), rtol=1e-5)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_w), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(inertia), float(inertia_w), rtol=1e-5)


_S = ck._SEGMENT_ROWS
# Planted cluster sizes (rows interleaved): exactly S rows (one segment),
# S + 1 (a second segment of one row), more than 3S (four segments), an
# empty cluster, and all of them together.
_SEGMENT_LAYOUTS = {
    "exactly_S": (_S, 3),
    "S_plus_1": (_S + 1, 2),
    "over_3S": (3 * _S + 7, _S - 1),
    "empty": (9, 0, 4),
    "mixed": (_S, _S + 1, 3 * _S + 7, 0, 1, 2 * _S),
}


def _segmented_sums(x, w, codes, dists, k):
    """K2's order as a row-by-row float32 loop: each cluster's rows in
    ascending order, cut into segments of S; a segment's partial from
    +0.0, the cluster's sum its partials added to +0.0 in order; the
    inertia as 1024 strided partial sums folded in halves."""
    sums = np.zeros((k, x.shape[1]), np.float32)
    counts = np.zeros(k, np.float32)
    for j in range(k):
        members = np.nonzero(codes == j)[0]
        for s0 in range(0, members.size, _S):
            part = np.zeros(x.shape[1], np.float32)
            wpart = np.float32(0.0)
            for r in members[s0:s0 + _S]:
                part = part + (x[r] if w is None else w[r] * x[r])
                wpart = np.float32(wpart + (w[r] if w is not None else 1.0))
            sums[j] = sums[j] + part
            counts[j] = np.float32(counts[j] + wpart)
    part = np.zeros(1024, np.float32)
    terms = dists if w is None else w * dists
    for r in range(x.shape[0]):
        part[r % 1024] = part[r % 1024] + terms[r]
    while part.shape[0] > 1:
        part = part[:part.shape[0] // 2] + part[part.shape[0] // 2:]
    return sums, counts, part[0]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("layout", sorted(_SEGMENT_LAYOUTS))
def test_plain_sums_in_segmented_order(layout, weighted):
    """The plain K2 is the kernel's arithmetic, weighted or not: checked bit
    for bit against a row-by-row float32 loop of the segmented order, on
    clusters planted at the sizes where segments begin and end."""
    sizes = _SEGMENT_LAYOUTS[layout]
    k, d = len(sizes), 5
    rng = np.random.default_rng(51)
    c = (rng.standard_normal((k, d)) * 20).astype(np.float32)
    lab = rng.permutation(np.repeat(np.arange(k), sizes))
    x = (c[lab] + rng.standard_normal((lab.size, d))).astype(np.float32)
    w = rng.uniform(0.0, 2.0, lab.size).astype(np.float32) if weighted else None
    codes, dists = ck.assign_plain(_t(x), _t(c))
    codes, dists = codes.numpy(), dists.numpy()
    np.testing.assert_array_equal(np.bincount(codes, minlength=k), sizes)
    sums, counts, inertia = _segmented_sums(x, w, codes, dists, k)
    got = ck.lloyd_accumulate_fused(_t(x), _t(c), None if w is None else _t(w))
    np.testing.assert_array_equal(got[0].numpy(), sums)
    np.testing.assert_array_equal(got[1].numpy(), counts)
    assert float(got[2]) == float(inertia)
    assert all(torch.equal(a, b) for a, b in zip(got, ck.lloyd_accumulate_plain(
        _t(x), _t(c), None if w is None else _t(w))))


def test_weighted_lloyd_accumulate_bad_weights():
    with pytest.raises(terr.InvalidParameter):
        ck.lloyd_accumulate_fused(torch.rand(10, 3), torch.rand(2, 3), torch.ones(9))


def test_lloyd_accumulate_empty_input():
    c = torch.rand(5, 3)
    sums, counts, inertia = ck.lloyd_accumulate_fused(torch.zeros(0, 3), c)
    assert float(sums.abs().sum()) == 0 and float(counts.sum()) == 0 and float(inertia) == 0


def _clusters(seed, n=1200, k=8, d=6, spread=0.3):
    """Well-separated clusters around known centres, every cluster holding
    rows, and a warm start near the centres: no cluster empties, so both
    packages walk the same Lloyd iterates."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)).astype(np.float32) * 10
    lab = rng.integers(0, k, n)
    lab[:k] = np.arange(k)
    x = centres[lab] + rng.normal(0, spread, (n, d))
    init = centres + rng.normal(0, 0.5, centres.shape)
    return x.astype(np.float32), init.astype(np.float32)


@pytest.mark.parametrize("option", ["plain", "spherical", "weighted", "weighted_spherical"])
def test_lloyd_warm_start_matches_jax(option):
    x, init = _clusters(40)
    kw = {}
    if "spherical" in option:
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        init = init / np.linalg.norm(init, axis=1, keepdims=True)
        kw["spherical"] = True
    if "weighted" in option:
        kw["weights"] = np.random.default_rng(41).uniform(0.5, 2.0, x.shape[0]).astype(np.float32)
    want = jkm.lloyd(x, 8, max_iters=10, init_centroids=init, use_pallas=False, **kw)
    got = tkm.lloyd(x, 8, max_iters=10, init_centroids=init, **kw)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), rtol=1e-5, atol=1e-5)
    # Each distance is ||x||^2 + (||c||^2 - 2 x.c): its fp32 error scales
    # with ||x||^2, not with the distance, so the inertia's bound does too.
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=0,
                               atol=1e-7 * float((x * x).sum()))
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("init", ["sample", "kmeans++"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_lloyd_seeded_inertia_matches_jax(init, weighted):
    """Uniform data: its local minima lie within ~2% of each other in
    inertia, so two random streams must land within 5%."""
    x = np.random.default_rng(42).random((1500, 8), dtype=np.float32)
    kw = {}
    if weighted:
        kw["weights"] = np.random.default_rng(43).uniform(0.5, 2.0, x.shape[0]).astype(np.float32)
    want = jkm.lloyd(x, 16, max_iters=20, seed=3, init=init, use_pallas=False, **kw)
    got = tkm.lloyd(x, 16, max_iters=20, seed=3, init=init, **kw)
    assert got.centroids.shape == (16, 8) and got.assignments.shape == (1500,)
    assert abs(float(got.inertia) - float(want.inertia)) <= 0.05 * float(want.inertia)


def test_lloyd_seeded_is_deterministic():
    x, _ = _clusters(44)
    a = tkm.lloyd(x, 8, seed=5, init="kmeans++")
    b = tkm.lloyd(x, 8, seed=5, init="kmeans++")
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.assignments, b.assignments)


def test_lloyd_max_iters_zero_matches_jax():
    x, init = _clusters(45)
    want = jkm.lloyd(x, 8, max_iters=0, init_centroids=init, use_pallas=False)
    got = tkm.lloyd(x, 8, max_iters=0, init_centroids=init)
    np.testing.assert_array_equal(got.centroids.numpy(), init)
    assert int(got.iterations) == int(want.iterations) == 0
    assert bool(got.converged) == bool(want.converged) is False


def test_kmeans_plusplus_draws_data_rows():
    rng = np.random.default_rng(46)
    x = rng.random((400, 5), dtype=np.float32)
    w = rng.random(400, dtype=np.float32)
    w[::2] = 0.0  # zero-weight rows can never be drawn
    seeds = tkm.kmeans_plusplus_init_device(x, 20, seed=1, weights=w).numpy()
    rows = [np.nonzero((x == s).all(1))[0] for s in seeds]
    assert all(r.size == 1 for r in rows)
    assert len({int(r[0]) for r in rows}) == 20
    assert all(int(r[0]) % 2 == 1 for r in rows)
    want = np.asarray(jkm.kmeans_plusplus_init_device(x, 20, seed=1, weights=w))
    assert want.shape == seeds.shape


def test_kmeans_plusplus_subsample_and_generator():
    x = np.random.default_rng(47).random((3000, 4), dtype=np.float32)
    g = torch.Generator().manual_seed(9)
    a = tkm.kmeans_plusplus_init_device(x, 16, generator=g, sample=500)
    b = tkm.kmeans_plusplus_init_device(x, 16, generator=torch.Generator().manual_seed(9), sample=500)
    assert a.shape == (16, 4) and torch.equal(a, b)


_W = np.ones(30, np.float32)
_BAD = {
    "k_zero": dict(k=0),
    "k_above_n": dict(k=31),
    "negative_iters": dict(max_iters=-1),
    "bad_init": dict(init="random"),
    "init_shape": dict(init_centroids=np.zeros((3, 2), np.float32)),
    "weights_len": dict(weights=_W[:10]),
    "weights_negative": dict(weights=np.where(np.arange(30) == 3, -1.0, 1.0).astype(np.float32)),
    "weights_nan": dict(weights=np.where(np.arange(30) == 3, np.nan, 1.0).astype(np.float32)),
    "weights_zero_mass": dict(weights=np.zeros(30, np.float32)),
    "weights_too_few": dict(weights=np.where(np.arange(30) < 2, 1.0, 0.0).astype(np.float32)),
    "empty": dict(data=np.zeros((0, 3), np.float32)),
    "three_d": dict(data=np.ones((2, 3, 3), np.float32)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_lloyd_bad_inputs_raise_like_jax(case):
    kw = dict(data=np.random.default_rng(48).random((30, 3), dtype=np.float32), k=4)
    kw.update(_BAD[case])
    data, k = kw.pop("data"), kw.pop("k")
    with pytest.raises(jerr.VqError) as want:
        jkm.lloyd(data, k, use_pallas=False, **kw)
    with pytest.raises(terr.VqError) as got:
        tkm.lloyd(data, k, **kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_cpu_tensors_never_launch():
    before = (ck.assign_fused.launches, ck.lloyd_accumulate_fused.launches)
    x, c = torch.rand(40, 6), torch.rand(5, 6)
    ck.assign_fused(x, c)
    ck.lloyd_accumulate_fused(x, c)
    tkm.lloyd(x, 5, max_iters=2)
    assert before == (ck.assign_fused.launches, ck.lloyd_accumulate_fused.launches)
