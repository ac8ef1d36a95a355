"""The port's kernels K3, K4, K5 and K8 against the JAX package's Pallas
kernels.

On the CPU each wrapper of ``vq_tpu_torch.ops.cuda_kernels`` runs its
plain PyTorch version, which is the arithmetic the CUDA kernel is held to
on the card; here it is held to the Pallas kernel run in interpret mode,
on the same numpy inputs. Tolerances: codes, counts, ADC values and ids
exact (K8's sums too, bit for bit, on finite tables); K3 sums at rtol 1e-5 / atol 1e-4 and inertia at rtol 1e-5 (fp32
summation order). The plain K3 is also held bit for bit to a row-by-row
float32 loop of its own segmented order. ``test_torch_cuda.py`` holds
each CUDA kernel to its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def enc_data():
    rng = np.random.default_rng(7)
    x = rng.random((777, 64), dtype=np.float32)  # unaligned n
    cb = rng.random((8, 200, 8), dtype=np.float32)  # k not a multiple of 128
    return x, cb


def test_pq_encode_matches_pallas(enc_data):
    x, cb = enc_data
    want = np.asarray(pk.pq_encode_fused(x, cb, block_rows=256, interpret=True))
    got = ck.pq_encode_fused(_t(x), _t(cb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pq_encode_bf16_matches_pallas(enc_data):
    x, cb = enc_data
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pk.pq_encode_fused(xb, cb, block_rows=256, interpret=True))
    got = ck.pq_encode_fused(_t(x).to(torch.bfloat16), _t(cb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pq_encode_nan_and_ties_match_pallas():
    """NaN centroids never win, duplicate centroids resolve to the lowest
    index: the Pallas int2 path, not the XLA fallback (which lets NaN
    win)."""
    rng = np.random.default_rng(8)
    cb = rng.random((2, 6, 4), dtype=np.float32)
    cb[:, 3] = cb[:, 1]  # exact duplicate: ties go to index 1
    cb[0, 0] = np.nan
    cb[1, 2, 1] = np.nan
    x = np.concatenate([cb[0, :, :], cb[1, :, :]], axis=1)  # rows = centroids
    x = np.nan_to_num(x, nan=0.5)
    want = np.asarray(pk.pq_encode_fused(x, cb, block_rows=8, interpret=True))
    got = ck.pq_encode_fused(_t(x), _t(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == 3).any()


def test_int2_rule_matches_pallas():
    scores = np.array(
        [
            [np.nan, 1.0, 1.0, 2.0],  # NaN never wins; tie -> lowest
            [0.0, -0.0, 3.0, -0.0],  # -0.0 equals +0.0
            [-0.0, 0.0, np.nan, 5.0],
            [np.nan, np.nan, np.nan, np.nan],
            [np.inf, 7.0, -np.inf, -np.inf],
            [-1e-30, -1e-30, -2.0, -2.0],
        ],
        np.float32,
    )
    col = jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32), scores.shape)
    want_min, want_idx = pk._int_argmin(jnp.asarray(scores), col, "int2")
    got_min, got_idx = ck.int_argmin(_t(scores))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(
        got_min.numpy().view(np.int32), np.asarray(want_min).view(np.int32)
    )


@pytest.mark.parametrize("n", [700, 131])
def test_pq_lloyd_accumulate_matches_pallas(n):
    rng = np.random.default_rng(9)
    m, s, k = 4, 8, 40
    x = rng.random((n, m * s), dtype=np.float32)
    cb = rng.random((m, k, s), dtype=np.float32)
    sums_w, counts_w, inertia_w = pk.pq_lloyd_accumulate_fused(
        x, cb, block_rows=256, interpret=True
    )
    sums, counts, inertia = ck.pq_lloyd_accumulate_fused(_t(x), _t(cb))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_w))
    np.testing.assert_allclose(
        sums.numpy(), np.asarray(sums_w), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(float(inertia), float(inertia_w), rtol=1e-5)
    assert float(counts.sum()) == n * m


_S = ck._SEGMENT_ROWS


def _k3_reference(x, codes, smin, k):
    """K3's order as a row-by-row float32 loop over the [n*m, s] view of
    ``x``, entry r*m + i labelled i*k + code: each label's entries in
    ascending order cut into segments of S, a segment's partial from +0.0,
    the label's sum its partials added to +0.0 in order; the inertia terms
    smin + xx (xx from +0.0 in ascending e; NaN kept, the rest clamped at
    0) by blocks of B terms, thread t of T adding terms t, t + T, ... of
    its block, the T folded in halves, the block partials as 1024 strided
    sums folded in halves (B, T: the kernel's block of terms and threads)."""
    n, m = codes.shape
    s = x.shape[1] // m
    xe = x.reshape(n * m, s)
    lab = (codes + np.arange(m) * k).reshape(-1)
    sums = np.zeros((m * k, s), np.float32)
    for j in range(m * k):
        members = np.nonzero(lab == j)[0]
        for s0 in range(0, members.size, _S):
            part = np.zeros(s, np.float32)
            for r in members[s0:s0 + _S]:
                part = part + xe[r]
            sums[j] = sums[j] + part
    terms = np.zeros(n * m, np.float32)
    for q in range(n * m):
        xx = np.float32(0.0)
        for e in range(s):
            xx = np.float32(xx + np.float32(xe[q, e] * xe[q, e]))
        t = np.float32(smin.reshape(-1)[q] + xx)
        terms[q] = t if np.isnan(t) else max(t, np.float32(0.0))

    def fold(part):
        while part.shape[0] > 1:
            part = part[:part.shape[0] // 2] + part[part.shape[0] // 2:]
        return part[0]

    block, threads = ck._K3_BLOCK_TERMS, ck._K3_TERM_THREADS
    partials = []
    for b0 in range(0, n * m, block):
        acc = np.zeros(threads, np.float32)
        for q in range(b0, min(b0 + block, n * m)):
            acc[(q - b0) % threads] = acc[(q - b0) % threads] + terms[q]
        partials.append(fold(acc))
    acc = np.zeros(1024, np.float32)
    for b, p in enumerate(partials):
        acc[b % 1024] = acc[b % 1024] + p
    return sums.reshape(m, k, s), np.bincount(lab, minlength=m * k).reshape(m, k), fold(acc)


@pytest.mark.parametrize("s", [8, 5])
def test_plain_pq_lloyd_in_segmented_order(s):
    """The plain K3 is the kernel's arithmetic: bit for bit against a
    row-by-row float32 loop of its order, with codewords planted in each
    subspace at exactly S entries, S + 1, more than 3S, none, and a large
    one (n*m past four blocks of the inertia's terms); s = 5 is the shape
    the kernel reads 4 bytes at a time."""
    m, sizes = 3, (_S, _S + 1, 3 * _S + 7, 0, 1400)
    k = len(sizes)
    rng = np.random.default_rng(52)
    cb = (rng.standard_normal((m, k, s)) * 20).astype(np.float32)
    planted = np.stack([rng.permutation(np.repeat(np.arange(k), sizes)) for _ in range(m)], 1)
    n = planted.shape[0]
    x = (cb[np.arange(m), planted] + rng.standard_normal((n, m, s))).astype(np.float32)
    x = x.reshape(n, m * s)
    codes, smin = ck._pq_scan_plain(_t(x), _t(cb))
    np.testing.assert_array_equal(codes.numpy(), planted)
    sums, counts, inertia = _k3_reference(x, codes.numpy(), smin.numpy(), k)
    assert n * m > 4 * ck._K3_BLOCK_TERMS
    got = ck.pq_lloyd_accumulate_fused(_t(x), _t(cb))
    np.testing.assert_array_equal(got[0].numpy(), sums)
    np.testing.assert_array_equal(got[1].numpy(), counts.astype(np.float32))
    assert float(got[2]) == float(inertia)


def test_segment_rows_fit_int32():
    """The sums stage keeps row ids in int32: K3's n*m entries past that
    are refused before anything is allocated."""
    with pytest.raises(ValueError):
        ck._segment_scratch(2**31, 8 * 256, 16, "cpu", False)


def _adc_inputs(mode, pack_bits, seed=10):
    rng = np.random.default_rng(seed)
    q, m, n = 3, 5, 1500
    k = {8: 200, 4: 16, 2: 4, 1: 2}[pack_bits]
    tables = rng.random((q, m, k), dtype=np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    codes[900] = codes[100]  # exact ties: the lowest id must come first
    codes[1499] = codes[100]
    if pack_bits < 8:
        from vq_tpu.ops.packing import pack_codes

        codes = np.asarray(pack_codes(codes, pack_bits))
    qn2 = rng.random(q, dtype=np.float32) * 4
    off = rng.random(n, dtype=np.float32)
    kw = {} if mode != "l2" else {"qn2": qn2, "offsets": off}
    return tables, np.ascontiguousarray(codes.T), kw


@pytest.mark.parametrize("pack_bits", [8, 4, 2, 1])
@pytest.mark.parametrize("mode", ["sum", "l2", "dot"])
def test_adc_scan_topk_matches_pallas(mode, pack_bits):
    tables, codes_t, kw = _adc_inputs(mode, pack_bits)
    want_v, want_i = pk.adc_scan_topk_fused(
        tables, codes_t, 10, block_cols=1024, mode=mode,
        pack_bits=pack_bits, interpret=True, **kw,
    )
    got_v, got_i = ck.adc_scan_topk_fused(
        _t(tables), _t(codes_t), 10, mode=mode, pack_bits=pack_bits,
        tile=1024, **{a: _t(b) for a, b in kw.items()},
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _merge_inputs(case, mode, rng):
    """K5 operands: tie-heavy (3 codes a subspace, integer tables, so most
    scores of a tile tie), n < fetch, or query 0's scores all +inf."""
    q, m, k, n = 3, 4, 3, 3000
    tables = rng.integers(0, 3, (q, m, k)).astype(np.float32)
    if case == "n_below_fetch":
        n = 5
    if case == "all_inf" and mode != "l2":
        tables[0] = np.inf if mode == "sum" else -np.inf
    codes = rng.integers(0, k, (m, n)).astype(np.uint8)
    qn2 = rng.random(q, dtype=np.float32) * 4
    if case == "all_inf":
        qn2[0] = np.inf
    kw = {"qn2": _t(qn2), "offsets": _t(rng.random(n, dtype=np.float32))} if mode == "l2" else {}
    return _t(tables), _t(codes), kw


@pytest.mark.parametrize("case", ["ties", "n_below_fetch", "all_inf"])
@pytest.mark.parametrize("mode", ["sum", "l2", "dot"])
@pytest.mark.parametrize("fetch", [1, 10, 128])
def test_merge_candidates_matches_full_merge(case, mode, fetch):
    """The PQ / RQ merge sorts only each tile's first ``fetch`` lanes; it
    equals one stable sort over all T*128 lanes of K5's output."""
    from vq_tpu_torch.models.pq import _merge_candidates

    rng = np.random.default_rng(fetch + len(case) + len(mode))
    tables, codes_t, kw = _merge_inputs(case, mode, rng)
    vals, ids = ck.adc_scan_topk_fused(tables, codes_t, fetch, mode=mode, tile=128, **kw)
    dist, pos = torch.sort(vals, dim=1, stable=True)
    dist, pos = dist[:, :fetch], pos[:, :fetch]
    idx = torch.gather(ids, 1, pos)
    want_i = torch.where(torch.isinf(dist), -1, idx)
    euclidean = mode == "l2"
    got_i, got_d = _merge_candidates(vals, ids, fetch, euclidean)
    want_d = torch.sqrt(dist.clamp_min(0.0)) if euclidean else dist
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    if case == "all_inf":
        assert bool((got_i[0] == -1).all()) and bool(torch.isinf(got_d[0]).all())


def test_adc_scan_topk_rejects_bad_contract():
    tables, codes_t, _ = _adc_inputs("sum", 8)
    for kwargs in ({"fetch": 0}, {"fetch": 129}):
        with pytest.raises(ValueError):
            ck.adc_scan_topk_fused(_t(tables), _t(codes_t), **kwargs)
    with pytest.raises(ValueError):
        ck.adc_scan_topk_fused(_t(tables), _t(codes_t), 10, mode="l2")
    with pytest.raises(ValueError):
        ck.adc_scan_topk_fused(_t(tables), _t(codes_t[:3]), 10)


def test_cpu_tensors_never_launch():
    before = (
        ck.pq_encode_fused.launches,
        ck.pq_lloyd_accumulate_fused.launches,
        ck.adc_scan_topk_fused.launches,
    )
    x = torch.rand(50, 8)
    cb = torch.rand(2, 5, 4)
    ck.pq_encode_fused(x, cb)
    ck.pq_lloyd_accumulate_fused(x, cb)
    ck.adc_scan_topk_fused(torch.rand(2, 2, 5), torch.zeros(2, 50, dtype=torch.uint8), 4)
    ck.adc_lookup_fused(torch.rand(2, 2, 5), torch.zeros(50, 2, dtype=torch.uint8))
    for precision in ck.ENCODE_PRECISIONS:
        ck.pq_encode_fused(x, cb, precision=precision)
    assert before == (
        ck.pq_encode_fused.launches,
        ck.pq_lloyd_accumulate_fused.launches,
        ck.adc_scan_topk_fused.launches,
    )
    assert ck.adc_lookup_fused.launches == 0


# K8 (dense ADC table sum): (code type, k, codes outside [0, k) mixed in).
_LOOKUP_CASES = [("u8", 200, False), ("u8", 37, False), ("u8", 100, True),
                 ("i32", 256, False), ("i32", 1000, False), ("i32", 100, True)]


@pytest.mark.parametrize("case", _LOOKUP_CASES, ids=lambda c: "%s-k%d-oob%d" % c)
def test_adc_lookup_matches_pallas(case):
    """K8's plain version against the Pallas one-hot kernel, bit for bit:
    each sum from +0.0 in subspace order, a code outside [0, k) adds 0."""
    ctype, k, oob = case
    rng = np.random.default_rng(k + 3 * oob)
    q, m, n = 5, 6, 1333  # n not a multiple of the Pallas tile
    tables = rng.normal(0, 2, (q, m, k)).astype(np.float32)
    lo, hi = (-3, k + 3) if oob and ctype == "i32" else (0, 256 if oob else k)
    codes = rng.integers(lo, hi, (n, m)).astype(np.uint8 if ctype == "u8" else np.int32)
    want = np.asarray(pk.adc_lookup_fused(tables, codes, block_cols=512, interpret=True))
    got = ck.adc_lookup_fused(_t(tables), _t(codes))
    assert got.shape == (q, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if oob:
        assert ((codes < 0) | (codes >= k)).any()


# (code type, Q, m, k, n) at the edges of K8's tiling on the card: Q = 1
# (cosine's reconstruction norms) and a ragged last quad of queries, n
# below one thread's 4 rows, m = 1 and m past 32, u8 codes >= k.
_LOOKUP_SHAPES = [("u8", 1, 8, 256, 1001), ("u8-oob", 127, 3, 37, 3), ("i32", 6, 1, 256, 700),
                  ("u8", 5, 40, 16, 515)]


@pytest.mark.parametrize("shape", _LOOKUP_SHAPES, ids=lambda c: "%s-Q%d-m%d-k%d-n%d" % c)
def test_adc_lookup_shapes_match_pallas(shape):
    """K8's plain version against the Pallas kernel at the shapes the
    card's tiling has to survive, bit for bit."""
    ctype, q, m, k, n = shape
    rng = np.random.default_rng(q + m + n)
    tables = rng.normal(0, 2, (q, m, k)).astype(np.float32)
    hi = 256 if ctype == "u8-oob" else k
    codes = rng.integers(0, hi, (n, m)).astype(np.int32 if ctype == "i32" else np.uint8)
    want = np.asarray(pk.adc_lookup_fused(tables, codes, block_cols=512, interpret=True))
    got = ck.adc_lookup_fused(_t(tables), _t(codes))
    assert got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), want)
    if ctype == "u8-oob":
        assert (codes >= k).any()


def test_adc_lookup_equals_the_pq_adc_sum():
    """``models.pq._adc_lookup`` is K8, and K8 equals the sum of gathers
    in subspace order (the order every ADC path shares)."""
    from vq_tpu_torch.models.pq import _adc_lookup

    rng = np.random.default_rng(31)
    tables = _t(rng.random((3, 4, 16), dtype=np.float32))
    codes = _t(rng.integers(0, 16, (50, 4)).astype(np.int64))
    want = torch.zeros(3, 50)
    for i in range(4):
        want = want + tables[:, i, :][:, codes[:, i]]
    assert torch.equal(_adc_lookup(tables, codes), want)
    assert torch.equal(ck.adc_lookup_fused(tables, codes.to(torch.uint8)), want)


@pytest.mark.parametrize("bad", ["tables_2d", "codes_width", "codes_1d"])
def test_adc_lookup_rejects_bad_operands(bad):
    tables, codes = torch.rand(2, 3, 8), torch.zeros(10, 3, dtype=torch.uint8)
    if bad == "tables_2d":
        tables = tables[0]
    elif bad == "codes_width":
        codes = codes[:, :2]
    else:
        codes = codes[:, 0]
    with pytest.raises(ValueError):
        ck.adc_lookup_fused(tables, codes)


# (m, k, s) around the resident scan's limits: the main configuration,
# odd k and s, wide subspaces where only a 2-stage ring fits, and
# codebooks past shared memory.
_PLAN_GRID = [(m, k, s) for m in (1, 8) for k in (1, 127, 256, 257, 1000, 4096, 65536)
              for s in (1, 5, 16, 64, 128, 200, 960)]


def test_pq_scan_plan_fits_shared_memory():
    """K3's and K4's scan plan: never past the opt-in limit, at least one
    centroid in shared memory, the streamed mode exactly where a resident
    codebook with a 2-stage ring does not fit, 3 stages wherever they fit,
    and blocks of whole 128-row tiles that cover n."""
    modes = set()
    for m, k, s in _PLAN_GRID:
        for n in (1, 129, 1_000_000):
            plan = ck.pq_scan_plan(n, m, k, s)
            kp, s4 = -(-k // 128) * 128, -(-s // 4) * 4
            resident = {st: 4 * (kp * s4 + kp + st * 128 * s4) for st in (2, 3)}
            assert 0 < plan.smem <= ck.SMEM_OPTIN, (m, k, s, plan)
            assert plan.centroids >= 1
            assert plan.resident == (resident[2] <= ck.SMEM_OPTIN), (m, k, s, plan)
            if plan.resident:
                assert plan.centroids >= k
                assert plan.stages == (3 if resident[3] <= ck.SMEM_OPTIN else 2)
                assert plan.smem == resident[plan.stages]
            assert plan.rows_per_block % 128 == 0
            blocks = -(-n // plan.rows_per_block)
            assert blocks * plan.rows_per_block >= n > (blocks - 1) * plan.rows_per_block
            modes.add((plan.resident, plan.stages))
    assert modes == {(True, 3), (True, 2), (False, 3)}


def test_pq_scan_plan_main_shape():
    """8x256x16 at 1M rows: the codebook resident (17 KB) beside three 8 KB
    x tiles, 33 blocks a subspace (264 in all)."""
    plan = ck.pq_scan_plan(1_000_000, 8, 256, 16)
    assert plan == ck.ScanPlan(True, 3, 4 * (256 * 16 + 256 + 3 * 128 * 16), 256, 237 * 128)
    assert -(-1_000_000 // plan.rows_per_block) * 8 == 264


def test_pq_scan_ab_loads_another_checkout():
    """The A/B script's loader: another checkout's wrappers as a module of
    their own (here this checkout's), whose plain versions on CPU tensors
    give this module's results."""
    from pathlib import Path

    from vq_tpu_torch.benchmarks import pq_scan_ab

    other = pq_scan_ab.other_kernels(Path(__file__).resolve().parent.parent)
    assert other is not ck and other.__name__ == "_other_cuda_kernels"
    x, cb = torch.rand(300, 12), torch.rand(3, 20, 4)
    assert torch.equal(other.pq_encode_fused(x, cb), ck.pq_encode_fused(x, cb))
    got, want = other.pq_lloyd_accumulate_fused(x, cb), ck.pq_lloyd_accumulate_fused(x, cb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
