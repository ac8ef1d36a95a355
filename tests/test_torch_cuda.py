"""Each CUDA kernel of ``vq_tpu_torch`` against its plain PyTorch version,
on the card. Every test is marked ``cuda`` and skips where there is no
GPU. The file imports no JAX, so it also runs where only PyTorch is
installed; ``tests/conftest.py`` needs JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 codes and distances, K4 codes, K5
values and ids, K6, K7 and K8 values, and IVF-Flat / IVF-SQ / RQ /
IVF-RQ searches exact (the kernels repeat the plain versions' fp32
arithmetic); K4-bf16 and K4-bf16x3 codes (bf16 products on the tensor
cores, which sum a tile's 16 products in their own order) by
``cuda_kernels.encode_parity``: >= 0.9999 of the codes equal, every
other one a float64 near tie on the precision's own operands, and bit
for bit where every partial sum is exact (small integers), at exact
ties (duplicated centroids), on NaN centroids and rows and on zero
scores;
K2 and K3 exact, K2 weighted or not (kernels and plain versions sum in
one segmented order), and bit-identical from one run to the next (where
a row holds NaN or +-inf, K3's sums and inertia equal with NaN equal to
NaN, whatever its payload). The
benchmark twins' kernels: B1 "highest", B2,
B3 and B4 exact; B1 "default" (bf16 tensor cores, their own summation
order) at >= 0.9999 of the codes, every other one a float64 near tie.
Score-aware PQ and OPQ: ``mips_search`` (K5 "dot", or K8 a chunk) and
the dot IVF-PQ search (K7 over negated dot tables) exact against the
plain route; the anisotropic refine the same bits twice on the card,
and within 1e-4 (codebooks) / 1e-5 relative (loss) of the CPU's, whose
fp32 products sum in another order; the card's anisotropic and OPQ
codes equal the CPU's on >= 99.9% of the rows, every other row a
float64 near tie of its loss (anisotropic) or score (OPQ, 1e-5).
IVF maintenance: the chunk pool's mutations and a stubbed rebalance
(K1, and K4 for IVF-PQ) give the CPU's centroids, lists and layout
exactly, f32 norms within rtol 1e-6 (the card's reductions sum in their
own order), searches at separated ranks within 1e-2; ``range_search``
through K6 / K7 bit for bit against the plain route after a remove and
a merge; ``IVFBinaryIndex`` Hamming searches and ranges equal to the
CPU's, ties included, reranked values within 1e-3.
The layer around the indexes: warm-started ``Kmeans`` centroids within
1e-4 of the CPU's, labels equal; PCA mean within 1e-5, eigenvalues within
1e-4 of the largest, components within 1e-4 up to sign, ``apply`` /
``reverse`` from one state within 1e-5, ITQ's rotation from one start
within 1e-4; ``RefineIndex`` codes exact (residual PQ on >= 99.9% of
the rows) and searches at separated ranks within 1e-3 (1e-2 residual);
``BatchPipeline`` bit for bit one search a batch, and stale after a
rebalance; checkpoints of the new kinds searched the same bits.
"""

import numpy as np
import pytest
import torch

from vq_tpu_torch.benchmarks import adc_vmem_bench as av
from vq_tpu_torch.benchmarks import mpacked_encode as mp
from vq_tpu_torch.ops import cuda_kernels as ck
from vq_tpu_torch.models import bq as tbq
from vq_tpu_torch.models import tsvq as tt
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.ops.packing import pack_codes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (m, k, s): the main configuration; s > 16; k = 1000 (eight passes over
# a resident codebook, and past the bf16 encodes' 48 KB chunks); s not a
# multiple of 4 (4-byte copies, zeros past s) with k odd and three
# 128-centroid passes; a codebook past shared memory (the streamed scan).
_PQ_SHAPES = [(8, 256, 16), (4, 300, 24), (2, 1000, 12), (3, 257, 5), (1, 4096, 64)]
# The eval harness's default PQ (16 x 256 on dim 384: 24-wide subspaces).
_EVAL_PQ = (16, 256, 24)
# K4-bf16 / K4-bf16x3 also past 64 e (x reloaded in chunks of 4 k-steps).
_LOWP_SHAPES = _PQ_SHAPES + [(2, 100, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _PQ_SHAPES + [_EVAL_PQ])
def test_pq_encode_matches_plain(card, shape, dtype):
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(5000, m * s, generator=g, device=card).to(dtype)
    cb = torch.randn(m, k, s, generator=g, device=card)
    got = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.pq_encode_plain(x, cb))


@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _LOWP_SHAPES)
def test_pq_encode_lowp_matches_plain(card, shape, dtype, precision):
    """K4-bf16 and K4-bf16x3 on the tensor cores: the products of bf16
    values are exact, but a tile's 16 are summed in the tensor core's
    order, so codes are held by the near-tie rule (encode_parity)."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(5001, m * s, generator=g, device=card).to(dtype)
    cb = torch.randn(m, k, s, generator=g, device=card)
    before = ck.pq_encode_fused.launches_by[precision]
    got = ck.pq_encode_fused(x, cb, precision=precision)
    torch.cuda.synchronize()
    assert ck.pq_encode_fused.launches_by[precision] == before + 1
    par = ck.encode_parity(x, cb, got, precision)
    assert par.ok, par


def _exact_case(kind, shape, dtype, g, card, n=3001):
    """Operands on which K4-bf16 / K4-bf16x3 must equal the plain version
    bit for bit: small integers (exact in bf16, every partial sum exact in
    f32 in any order), with NaN centroids and rows ("nan"), with -0.0
    entries and zero centroids of both signs ("zeros"); or Gaussian
    centroids duplicated at 2, 9, 130 and k - 1 and every row near
    centroid 2 ("dups": exact ties, the lowest index wins)."""
    m, k, s = shape
    if kind == "dups":
        cb = torch.randn(m, k, s, generator=g, device=card)
        for j in (9, 130, k - 1):
            if j < k:
                cb[:, j] = cb[:, 2]
        x = cb[:, 2].reshape(1, m * s) + 1e-3 * torch.randn(n, m * s, generator=g, device=card)
        return x.to(dtype), cb
    x = torch.randint(-4, 5, (n, m * s), generator=g, device=card).float()
    cb = torch.randint(-4, 5, (m, k, s), generator=g, device=card).float()
    if kind == "nan":
        cb[:, 0] = float("nan")
        cb[:, 5, s - 1] = float("nan")
        x[7] = float("nan")
        x[11, 0] = float("nan")
    elif kind == "zeros":
        cb[:, 0] = -0.0
        cb[:, 1] = 0.0
        cb[cb == 0] = -0.0
        x[x == 0] = -0.0
        x[: n // 2] = (cb[:, 3].reshape(1, m * s) / 2).round()  # scores of exactly 0 nearby
    return x.to(dtype), cb


@pytest.mark.parametrize("kind", ["integers", "dups", "nan", "zeros"])
@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _LOWP_SHAPES)
def test_pq_encode_lowp_exact_cases(card, shape, dtype, precision, kind):
    g = torch.Generator(device=card).manual_seed(16)
    x, cb = _exact_case(kind, shape, dtype, g, card)
    got = ck.pq_encode_fused(x, cb, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.pq_encode_plain(x, cb, precision))
    if kind == "dups":
        assert bool((got == 2).all())
    if kind == "nan":
        assert bool((got[7] == 0).all()) and not bool((got == 0).any(1)[:7].any())


@pytest.mark.parametrize("bad", ["nan", "negative-nan", "inf"])
@pytest.mark.parametrize("precision", ["highest", "bf16_fast", "bf16x3"])
def test_pq_encode_nan_centroid_same_codes_on_the_card(card, precision, bad):
    """A NaN (either sign) or +inf entry in centroid 3 (its score NaN or
    inf - inf): kernel and plain version give the same codes on the card,
    and neither picks centroid 3. The card's arithmetic makes only
    positive NaNs, so the device orderable_key (csrc/common.cuh), which
    keys a negative NaN below -inf, never meets one."""
    g = torch.Generator(device=card).manual_seed(17)
    x = torch.rand(4000, 3 * 16, generator=g, device=card) + 0.1
    cb = torch.randn(3, 10, 16, generator=g, device=card)
    value = {"nan": 0x7FC00000, "negative-nan": -0x400000, "inf": 0x7F800000}[bad]
    cb[:, 3, 5] = torch.tensor(value, dtype=torch.int32, device=card).view(torch.float32)
    got = ck.pq_encode_fused(x, cb, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.pq_encode_plain(x, cb, precision))
    assert not bool((got == 3).any())
    inf = torch.tensor([float("inf")], device=card)
    neg = torch.tensor([-0x400000], dtype=torch.int32, device=card).view(torch.float32)
    made = torch.cat([inf - inf, inf * 0.0, neg * 2.0, neg - 1.0, cb[:, 3, 5] - inf,
                      ck._bf16(neg), ck._bf16(cb[:, 3, 5]), (cb * cb).sum(-1)[:, 3]])
    nans = made[torch.isnan(made)]
    assert nans.numel() >= 5
    assert not bool(torch.signbit(nans).any()), nans.view(torch.int32)


# (code type, Q, m, k, n): u8 at k = 256 (no range check) with a ragged
# last quad (Q = 20) and n past a block's rows and not a multiple of 4;
# 128 KB a quad (one a block, k + 1 entries); tables past the opt-in
# window (read through L2), i32 and u8; m past 32 and m = 12 (16-byte and
# 4-byte code words in chunks of 8 then 4); i32 codes outside [0, k),
# INT_MIN and INT_MAX among them, and u8 codes >= k = 37 (the zero entry);
# Q = 1 (cosine's reconstruction norms), Q = 5 and Q = 127 (ragged quads);
# n = 1 and n = 3; m = 1; the [128, RQ chunk + 3] shape.
_LOOKUP_SHAPES = [("u8", 20, 8, 256, 70_001), ("i32", 7, 8, 1000, 5000),
                  ("i32", 3, 4, 4096, 3001), ("u8", 5, 40, 16, 2000), ("i32-oob", 9, 6, 100, 4099),
                  ("u8", 1, 8, 256, 100_003), ("u8", 5, 8, 256, 3), ("u8", 127, 8, 256, 1),
                  ("u8", 128, 8, 256, 262_147), ("u8-oob", 6, 8, 37, 5001), ("u8", 9, 1, 256, 999),
                  ("i32", 4, 12, 64, 10_241), ("u8", 3, 12, 300, 4097), ("i32-oob", 2, 3, 5000, 777),
                  ("u8", 6, 2, 9000, 1030), ("i32-oob", 127, 8, 256, 2050)]


def _lookup_operands(card, ctype, q, m, k, n, seed=12):
    g = torch.Generator(device=card).manual_seed(seed)
    tables = torch.randn(q, m, k, generator=g, device=card)
    if ctype.startswith("u8"):
        hi = 256 if ctype == "u8-oob" else min(k, 256)
        codes = torch.randint(0, hi, (n, m), generator=g, device=card).to(torch.uint8)
        if ctype == "u8-oob":
            assert bool((codes >= k).any())
    else:
        lo, hi = (-5, k + 5) if ctype == "i32-oob" else (0, k)
        codes = torch.randint(lo, hi, (n, m), generator=g, device=card, dtype=torch.int32)
        if ctype == "i32-oob":
            codes.view(-1)[::97] = -2 ** 31
            codes.view(-1)[1::89] = 2 ** 31 - 1
    return tables, codes


@pytest.mark.parametrize("shape", _LOOKUP_SHAPES, ids=lambda c: "%s-Q%d-m%d-k%d-n%d" % c)
def test_adc_lookup_matches_plain(card, shape):
    """K8 bit for bit against its plain version, and the same sums from
    the codes as u8, i32 and i64 (the range check compiled out, the zero
    entry, the clamp of the wrapper's cast)."""
    ctype, q, m, k, n = shape
    tables, codes = _lookup_operands(card, *shape)
    got = ck.adc_lookup_fused(tables, codes)
    torch.cuda.synchronize()
    assert got.shape == (q, n)
    assert torch.equal(got, ck.adc_lookup_plain(tables, codes))
    assert torch.equal(ck.adc_lookup_fused(tables, codes.to(torch.int64)), got)
    if codes.dtype == torch.uint8:
        assert torch.equal(ck.adc_lookup_fused(tables, codes.to(torch.int32)), got)


@pytest.mark.parametrize("shape", [("u8", 7, 8, 256, 5003), ("u8-oob", 5, 4, 37, 998),
                                   ("i32-oob", 3, 3, 5000, 1001)],
                         ids=lambda c: "%s-Q%d-m%d-k%d-n%d" % c)
def test_adc_lookup_inf_nan_negative_zero(card, shape):
    """Tables holding +-inf, NaN and -0.0: bit for bit against the plain
    version (the card's NaN is the one positive canonical NaN), and no
    sum is -0.0 (each starts from +0.0)."""
    tables, codes = _lookup_operands(card, *shape, seed=18)
    flat = tables.view(-1)
    flat[::7] = -0.0
    flat[1::11] = float("inf")
    flat[2::13] = float("-inf")
    flat[3::101] = float("nan")
    tables[:, :, 0] = -0.0
    codes[: codes.shape[0] // 2] = 0  # rows that pick -0.0 in every subspace
    got = ck.adc_lookup_fused(tables, codes)
    torch.cuda.synchronize()
    want = ck.adc_lookup_plain(tables, codes)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isnan(got).any()) and bool(torch.isinf(got).any())
    assert not bool(torch.signbit(got[got == 0]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _PQ_SHAPES)
@pytest.mark.parametrize("n", [1, 77, 129])
def test_pq_encode_row_edges(card, n, shape, dtype):
    """One row, a part tile, and one row past a 128-row tile."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(13)
    x = torch.randn(n, m * s, generator=g, device=card).to(dtype)
    cb = torch.randn(m, k, s, generator=g, device=card)
    assert torch.equal(ck.pq_encode_fused(x, cb), ck.pq_encode_plain(x, cb))


@pytest.mark.parametrize("shape", [(8, 256, 16), (3, 257, 5), (1, 4096, 64)])
def test_pq_encode_tie_across_passes(card, shape):
    """Centroid 130 (second 128-centroid pass) equals centroid 2 and every
    row is centroid 2: the lower index must win in every subspace."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(14)
    cb = torch.randn(m, k, s, generator=g, device=card)
    cb[:, 130] = cb[:, 2]
    x = cb[:, 2].reshape(1, m * s).repeat(300, 1)
    got = ck.pq_encode_fused(x, cb)
    assert torch.equal(got, ck.pq_encode_plain(x, cb))
    assert bool((got == 2).all())


@pytest.mark.parametrize("nan_bits", [0x7FC00000, -0x400000], ids=["nan", "negative-nan"])
@pytest.mark.parametrize("shape", [(8, 256, 16), (3, 257, 5), (1, 4096, 64)])
def test_pq_encode_nan_then_inf(card, shape, nan_bits):
    """A NaN centroid at j = 0 (either sign) and +inf scores after it
    (||c||^2 overflows): int2 takes index 1, where a float < from +inf
    keeps 0."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(15)
    cb = torch.full((m, k, s), 1e20, device=card)
    cb[:, 0] = torch.tensor(nan_bits, dtype=torch.int32, device=card).view(torch.float32)
    x = torch.randn(200, m * s, generator=g, device=card)
    got = ck.pq_encode_fused(x, cb)
    assert torch.equal(got, ck.pq_encode_plain(x, cb))
    assert bool((got == 1).all())


@pytest.mark.parametrize("shape", [(8, 256, 16), (3, 257, 5), (1, 4096, 64)])
def test_pq_encode_nan_and_inf_rows(card, shape):
    """Rows with a NaN (every score NaN: code 0), +-inf and -0.0 entries,
    through the encode and K3's minimum scores (its inertia)."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(16)
    x = torch.randn(300, m * s, generator=g, device=card)
    cb = torch.randn(m, k, s, generator=g, device=card)
    x[3, 0], x[40, -1], x[41, 1 % (m * s)] = float("nan"), float("inf"), -float("inf")
    x[200:] = -0.0
    got = ck.pq_encode_fused(x, cb)
    assert torch.equal(got, ck.pq_encode_plain(x, cb))
    assert int(got[3, 0]) == 0
    got = ck.pq_lloyd_accumulate_fused(x, cb)
    want = ck.pq_lloyd_accumulate_plain(x, cb)
    assert torch.equal(got[1], want[1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[2])) and bool(torch.isnan(want[2]))


def test_pq_encode_nan_and_ties(card):
    cb = torch.rand(2, 6, 4, device=card)
    cb[:, 3] = cb[:, 1]
    cb[0, 0] = float("nan")
    x = torch.cat([cb[0], cb[1]], dim=1).nan_to_num(0.5)
    got = ck.pq_encode_fused(x, cb)
    assert torch.equal(got, ck.pq_encode_plain(x, cb))
    assert not bool((got == 3).any())


@pytest.mark.parametrize("shape", _PQ_SHAPES + [_EVAL_PQ])
@pytest.mark.parametrize("n", [20_000, 77])
def test_pq_lloyd_matches_plain(card, shape, n):
    """K3 bit for bit: sums, counts and inertia, and the scan's minimum
    scores (what the inertia terms start from) against the plain smin."""
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(n, m * s, generator=g, device=card)
    cb = torch.randn(m, k, s, generator=g, device=card)
    sums, counts, inertia = ck.pq_lloyd_accumulate_fused(x, cb)
    torch.cuda.synchronize()
    ps, pc, pi = ck.pq_lloyd_accumulate_plain(x, cb)
    assert torch.equal(counts, pc) and int(counts.sum()) == n * m
    assert torch.equal(sums, ps) and torch.equal(inertia, pi)
    again = ck.pq_lloyd_accumulate_fused(x, cb)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again))
    minval = ck._pq_lloyd_card(x, cb)[3]
    assert torch.equal(minval.view(torch.int32), ck._pq_scan_plain(x, cb)[1].view(torch.int32))


@pytest.mark.parametrize("case", ["dominant", "unaligned"])
@pytest.mark.parametrize("shape", [(8, 256, 16), (3, 257, 5), (4, 100, 8), (2, 64, 4)])
def test_pq_lloyd_edges(card, shape, case):
    """K3 bit for bit where one codeword holds more than half of every
    subspace's rows (a cluster of hundreds of segments), and on an x 4
    bytes off 16-byte alignment (the 4-byte loads at s % 4 == 0); s = 8
    and 4 put 2 lanes and 1 lane on a segment."""
    m, k, s = shape
    n = 20_000
    g = torch.Generator(device=card).manual_seed(17)
    x = torch.randn(n, m * s, generator=g, device=card)
    cb = torch.randn(m, k, s, generator=g, device=card)
    if case == "dominant":
        cb = cb * 10
        cb[:, 7] = 0.0  # nearest to most rows of N(0, I)
    else:
        x = torch.empty(n * m * s + 1, device=card)[1:].view(n, m * s).copy_(x)
        assert x.data_ptr() % 16 != 0
    got = ck.pq_lloyd_accumulate_fused(x, cb)
    torch.cuda.synchronize()
    want = ck.pq_lloyd_accumulate_plain(x, cb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ck.pq_lloyd_accumulate_fused(x, cb)))
    if case == "dominant":
        assert bool((got[1][:, 7] > n // 2).all())


def _adc_inputs(mode, pack_bits, device, n=5000, *, q=3, m=5, k=None, codes="random",
                special=False):
    """K5 operands. codes: "random" in [0, k), "wide" in [0, 256) (past k
    and, where k <= 128, past kpad), "tied" one code row for every column
    (every score of a query ties). special: NaN, +inf, -inf and -0.0
    entries in query 0's first subspace, and query q-1's table all -0.0
    (dot mode scores -0.0)."""
    rng = np.random.default_rng(10)
    k = k or {8: 200, 4: 16, 2: 4, 1: 2}[pack_bits]
    tables = torch.from_numpy(rng.random((q, m, k), dtype=np.float32))
    c = torch.from_numpy(rng.integers(0, 256 if codes == "wide" else k, (n, m)).astype(np.uint8))
    if codes == "tied":
        c[:] = c[0].clone()
    c[900 % n] = c[100 % n]  # exact ties: the lowest id must come first
    c[n - 1] = c[100 % n]
    if special:
        odd = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])[:k]
        tables[0, 0, :len(odd)] = odd
        tables[-1] = -0.0
    codes_t = pack_codes(c, pack_bits).T.contiguous()
    kw = {}
    if mode == "l2":
        kw = {"qn2": torch.from_numpy(rng.random(q, dtype=np.float32) * 4),
              "offsets": torch.from_numpy(rng.random(n, dtype=np.float32))}
    return tables.to(device), codes_t.to(device), {a: b.to(device) for a, b in kw.items()}


def _bits(v):
    """Values as their bits, NaN canonical (its payload is not K5's contract)."""
    return torch.where(torch.isnan(v), float("nan"), v).view(torch.int32)


def _check_topk(tables, codes_t, fetch, **kw):
    """K5 bit for bit against its plain version, and on a second launch."""
    before = ck.adc_scan_topk_fused.launches
    got = ck.adc_scan_topk_fused(tables, codes_t, fetch, **kw)
    again = ck.adc_scan_topk_fused(tables, codes_t, fetch, **kw)
    torch.cuda.synchronize()
    assert ck.adc_scan_topk_fused.launches == before + 2
    want = ck.adc_scan_topk_plain(tables, codes_t, fetch, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], again[1]) and torch.equal(_bits(got[0]), _bits(again[0]))


# fetch: each width of the kept list (32, 64 and 128 words) at and around
# its edges.
_FETCHES = [1, 10, 31, 32, 33, 100, 127, 128]


@pytest.mark.parametrize("pack_bits", [8, 4, 2, 1])
@pytest.mark.parametrize("mode", ["sum", "l2", "dot"])
@pytest.mark.parametrize("fetch", _FETCHES)
def test_adc_scan_topk_matches_plain(card, mode, pack_bits, fetch):
    tables, codes_t, kw = _adc_inputs(mode, pack_bits, card)
    _check_topk(tables, codes_t, fetch, mode=mode, pack_bits=pack_bits, **kw)


@pytest.mark.parametrize("fetch", [10, 100])
@pytest.mark.parametrize("n", [3000, 7])
@pytest.mark.parametrize("tile", [128, 512, 2048])
def test_adc_scan_topk_tiles(card, tile, n, fetch):
    """n not a multiple of the tile, and n below fetch."""
    tables, codes_t, _ = _adc_inputs("sum", 8, card, n=n)
    _check_topk(tables, codes_t, fetch, tile=tile)


# (name, _adc_inputs arguments): every score of a query tied (the lowest
# columns win); NaN, +-inf and -0.0 scores; codes >= k = 200 (zero-padded
# entries) and >= kpad = 128 (k = 100: masked to code & 127); Q = 1 and
# 129; m = 64 at k = 256, whose 64 KB table is read through L1 rather than
# shared memory.
_ADC_EDGES = [("tied", dict(codes="tied")), ("special", dict(special=True)),
              ("codes-past-k", dict(codes="wide")), ("codes-past-kpad", dict(codes="wide", k=100)),
              ("Q1", dict(q=1)), ("Q129", dict(q=129)), ("m64-k256", dict(m=64, k=256))]


@pytest.mark.parametrize("fetch", [1, 33, 128])
@pytest.mark.parametrize("mode", ["sum", "l2", "dot"])
@pytest.mark.parametrize("edge", _ADC_EDGES, ids=lambda e: e[0])
def test_adc_scan_topk_edges(card, edge, mode, fetch):
    tables, codes_t, kw = _adc_inputs(mode, 8, card, n=4099, **edge[1])
    _check_topk(tables, codes_t, fetch, mode=mode, **kw)


# (n, k, d): the IVF coarse width, a ragged k and d, a k past every TPU
# VMEM budget (65536 at d = 128, one launch), and a single centroid. The
# kernel's edges: n and k not multiples of its 128-row / 128-centroid
# tiles throughout; d % 4 != 0 (4-byte copies and a zero-padded last
# float4); d = 1; the widest d whose x rows stay resident in shared
# memory (244) and the next (245, d % 4 != 0), and GIST's d = 960, both
# staged in 64-wide e slices beside the centroids.
_ASSIGN_SHAPES = [(5000, 1024, 128), (777, 300, 24), (300, 65536, 128), (65, 1, 7),
                  (1031, 129, 131), (2000, 37, 1), (515, 70, 244), (515, 70, 245),
                  (4099, 1000, 960)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _ASSIGN_SHAPES, ids=lambda s: "n%d-k%d-d%d" % s)
def test_assign_matches_plain(card, shape, dtype):
    n, k, d = shape
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(n, d, generator=g, device=card).to(dtype)
    c = torch.randn(k, d, generator=g, device=card)
    codes, dists = ck.assign_fused(x, c)
    torch.cuda.synchronize()
    want_codes, want_dists = ck.assign_plain(x, c)
    assert torch.equal(codes, want_codes)
    assert torch.equal(dists, want_dists)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_assign_unaligned_operands(card, dtype):
    """x and the centroids one element past a 16-byte boundary (d % 4 ==
    0): the kernel takes its element-wise copies and still matches."""
    n, k, d = 1500, 200, 128
    g = torch.Generator(device=card).manual_seed(13)
    x = torch.randn(n * d + 1, generator=g, device=card).to(dtype)[1:].view(n, d)
    c = torch.randn(k * d + 1, generator=g, device=card)[1:].view(k, d)
    codes, dists = ck.assign_fused(x, c)
    torch.cuda.synchronize()
    want_codes, want_dists = ck.assign_plain(x, c)
    assert torch.equal(codes, want_codes)
    assert torch.equal(dists, want_dists)


def test_assign_nan_and_ties(card):
    c = torch.rand(9, 4, device=card)
    c[5] = c[2]
    c[0, 1] = float("nan")
    x = torch.cat([c.nan_to_num(0.5), torch.rand(7, 4, device=card)])
    x[-1, 2] = float("nan")
    codes, dists = ck.assign_fused(x, c)
    want_codes, want_dists = ck.assign_plain(x, c)
    assert torch.equal(codes, want_codes)
    assert torch.equal(dists.isnan(), want_dists.isnan())
    assert int(codes[-1]) == 0 and not bool(torch.isin(codes[:-1], torch.tensor([0, 5], device=card)).any())


@pytest.mark.parametrize("shape", [(20_000, 1024, 128), (1025, 40, 32), (3000, 65536, 16), (77, 3, 5)],
                         ids=lambda s: "n%d-k%d-d%d" % s)
def test_lloyd_accumulate_matches_plain(card, shape):
    n, k, d = shape
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(n, d, generator=g, device=card)
    c = torch.randn(k, d, generator=g, device=card)
    sums, counts, inertia = ck.lloyd_accumulate_fused(x, c)
    torch.cuda.synchronize()
    ps, pc, pi = ck.lloyd_accumulate_plain(x, c)
    assert torch.equal(counts, pc) and int(counts.sum()) == n
    assert torch.equal(sums, ps) and torch.equal(inertia, pi)
    again = ck.lloyd_accumulate_fused(x, c)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again))


# K2 where its segments begin and end (S = ck._SEGMENT_ROWS rows): every
# row in one cluster; fewer rows than S; d = 5 (4-byte loads); d = 1, 4
# and 8 (1, 1 and 2 lanes a segment, 32 and 16 segments a warp); GIST's
# d = 960 (eight 128-column groups, the last half full); k = 65536 with
# most clusters empty; one cluster of ~199k rows beside a few small ones;
# x 4 bytes off 16-byte alignment (4-byte loads at d = 128).
_K2_EDGES = {
    "k1": (5000, 1, 128),
    "n_below_S": (20, 3, 128),
    "d5": (3001, 7, 5),
    "d1": (3001, 7, 1),
    "d4": (3001, 7, 4),
    "d8": (3001, 9, 8),
    "d960": (4000, 50, 960),
    "k65536_mostly_empty": (3000, 65536, 16),
    "dominant_200k": (200_000, 256, 128),
    "unaligned": (5000, 64, 128),
}


def _k2_case(card, name):
    n, k, d = _K2_EDGES[name]
    g = torch.Generator(device=card).manual_seed(15)
    x = torch.randn(n, d, generator=g, device=card)
    c = torch.randn(k, d, generator=g, device=card)
    if name == "dominant_200k":
        c = c * 10
        c[7] = 0.0  # nearest to every row of N(0, I) ...
        x[:1000] = c[torch.arange(1000, device=card) % k] + 0.1 * x[:1000]  # ... but these
    if name == "unaligned":
        x = torch.empty(n * d + 1, device=card)[1:].view(n, d).copy_(x)
        assert x.data_ptr() % 16 != 0
    return x, c


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", sorted(_K2_EDGES))
def test_lloyd_accumulate_segment_edges(card, name, weighted):
    x, c = _k2_case(card, name)
    g = torch.Generator(device=card).manual_seed(16)
    w = torch.rand(x.shape[0], generator=g, device=card) * 2 if weighted else None
    got = ck.lloyd_accumulate_fused(x, c, w)
    torch.cuda.synchronize()
    want = ck.lloyd_accumulate_plain(x, c, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ck.lloyd_accumulate_fused(x, c, w)))
    sizes = torch.bincount(ck.assign_plain(x, c)[0].long(), minlength=c.shape[0])
    if name == "dominant_200k":
        assert int(sizes.max()) > 190_000 and int((sizes > 0).sum()) > 100
    if not weighted:
        assert torch.equal(got[1], sizes.float())


def test_lloyd_accumulate_d960_bit_identical(card):
    """GIST's width, where K1 slices x through its ring: two runs agree bit
    for bit."""
    n, k, d = 30_000, 1000, 960
    g = torch.Generator(device=card).manual_seed(14)
    x = torch.randn(n, d, generator=g, device=card)
    c = torch.randn(k, d, generator=g, device=card)
    first = ck.lloyd_accumulate_fused(x, c)
    again = ck.lloyd_accumulate_fused(x, c)
    torch.cuda.synchronize()
    assert int(first[1].sum()) == n
    assert all(torch.equal(a, b) for a, b in zip(first, again))


# (code type, m, kk, rows a chunk): the IVF-PQ shape (u8, 8 x 256), i32
# codes past 256, and a table too large for shared memory in one piece
# (16 x 4096 x 4 B = 256 KB, streamed in subspace groups).
_PROBE_SHAPES = [(torch.uint8, 8, 256, 256), (torch.int32, 4, 1000, 100),
                 (torch.int32, 16, 4096, 64), (torch.uint8, 3, 16, 37)]


@pytest.mark.parametrize("shape", _PROBE_SHAPES, ids=lambda s: "%s-m%d-kk%d-ch%d" % (str(s[0])[6:], *s[1:]))
def test_ivf_probe_matches_plain(card, shape):
    dtype, m, kk, ch = shape
    g = torch.Generator(device=card).manual_seed(5)
    pairs, n_chunks, nc = 50, 40, 7
    tables = torch.randn(pairs, m, kk, generator=g, device=card)
    pool = torch.randint(0, kk, (n_chunks, ch, m), generator=g, device=card).to(dtype)
    chains = torch.randint(-1, n_chunks, (pairs, nc), generator=g, device=card, dtype=torch.int32)
    cap = nc * ch - 5
    got = ck.ivf_probe_adc_fused(tables, chains, pool, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.ivf_probe_adc_plain(tables, chains, pool, cap=cap))
    probe = chains[:, 0].clamp_min(0)  # the TPU contract: one chunk a table
    assert torch.equal(ck.ivf_probe_adc_fused(tables, probe, pool),
                       ck.ivf_probe_adc_plain(tables, probe, pool))
    chains[:, 1] = n_chunks + 1000  # past the pool: reads nothing, gives 0
    got = ck.ivf_probe_adc_fused(tables, chains, pool, cap=cap)
    assert torch.equal(got, ck.ivf_probe_adc_plain(tables, chains, pool, cap=cap))
    assert not bool(got[:, ch:2 * ch].any())


# List-major K7 (csrc/ivf_probe.cu): pairs grouped by their chain's first
# chunk into quads. (code type, m, kk, rows a chunk, chain slots, pool
# chunks, pairs a list, how): "lists" gives each list its own chain of
# chunks no other list holds (1 to nc of them, the rest -1) and repeats
# it for each of its pairs, shuffled; "differ_later" then changes a later slot of
# some pairs' chains (same first chunk, so the same quad); "stray" adds
# lists with no chunk, ids past the pool and a -1 first slot before live
# ones. Quads of 1 to 4 pairs, 5 and 70 pairs a list (two and eighteen
# quads); single-pair lists, as at nprobe 8; 40-slot chains past several
# tiles of the kernel; u8 codes at kk > 256 (no range check); tables of
# 1 MB a quad (streamed in groups of 3 subspaces) and of 256 KB a
# subspace (read from device memory).
_PROBE_LISTS = {
    "pairs_per_list_1_3_4_5_70": (torch.uint8, 8, 256, 256, 6, 40, [1, 3, 4, 5, 70], "lists"),
    "same_first_chunk_differ_later": (torch.uint8, 8, 256, 64, 5, 30, [4, 6, 9, 2], "differ_later"),
    "single_pair_lists": (torch.uint8, 8, 256, 256, 4, 1200, [1] * 300, "lists"),
    "long_chains": (torch.uint8, 8, 256, 64, 40, 200, [2, 9, 1, 5, 3], "lists"),
    "u8_kk300_m12": (torch.uint8, 12, 300, 100, 3, 20, [3, 1, 7], "lists"),
    "u8_kk16_stray": (torch.uint8, 5, 16, 37, 4, 25, [3, 1, 5, 2], "stray"),
    "i32_tables_past_227kb": (torch.int32, 16, 4096, 32, 3, 16, [1, 2, 3, 4, 6], "lists"),
    "i32_subspace_past_227kb": (torch.int32, 3, 16000, 16, 3, 10, [1, 2, 5], "differ_later"),
}


def _probe_lists(card, case, seed=23):
    """(tables, chains, pool, cap) of a _PROBE_LISTS case."""
    dtype, m, kk, ch, nc, n_chunks, sizes, how = _PROBE_LISTS[case]
    g = torch.Generator(device=card).manual_seed(seed)
    lists = torch.randperm(n_chunks, generator=g, device=card)[:len(sizes) * nc].int()
    lists = lists.reshape(len(sizes), nc)
    length = torch.randint(1, nc + 1, (len(sizes), 1), generator=g, device=card)
    lists[torch.arange(nc, device=card) >= length] = -1
    owner = torch.repeat_interleave(torch.arange(len(sizes), device=card),
                                    torch.tensor(sizes, device=card))
    chains = lists[owner[torch.randperm(owner.numel(), generator=g, device=card)]]
    if how == "differ_later":
        chains[::3, -1] = (chains[::3, -1] + 1) % n_chunks
    elif how == "stray":
        chains[::4] = -1  # pairs of an empty list
        chains[1::5, 1] = n_chunks + 7  # an id past the pool
        chains[2::7, 0] = -1  # dead first slot, live ones after it
    pairs = chains.shape[0]
    hi = 256 if dtype == torch.uint8 else kk + 2
    lo = 0 if dtype == torch.uint8 else -2
    pool = torch.randint(lo, hi, (n_chunks, ch, m), generator=g, device=card).to(dtype)
    tables = torch.randn(pairs, m, kk, generator=g, device=card)
    return tables, chains, pool, nc * ch - ch // 2 - 1


@pytest.mark.parametrize("case", sorted(_PROBE_LISTS))
def test_ivf_probe_lists_match_plain(card, case):
    """K7 list-major, bit for bit against its plain version and on a
    second run, one launch a call."""
    tables, chains, pool, cap = _probe_lists(card, case)
    before = ck.ivf_probe_adc_fused.launches
    got = ck.ivf_probe_adc_fused(tables, chains, pool, cap=cap)
    torch.cuda.synchronize()
    assert ck.ivf_probe_adc_fused.launches == before + 1
    assert torch.equal(got, ck.ivf_probe_adc_plain(tables, chains, pool, cap=cap))
    assert torch.equal(ck.ivf_probe_adc_fused(tables, chains, pool, cap=cap), got)


@pytest.mark.parametrize("case", sorted(_PROBE_LISTS))
def test_ivf_probe_quads_match_plain(card, case):
    """K7's grouping on the card: the pairs by bin and the quads, as the
    plain version lists them, the same on a second run."""
    _, chains, pool, _ = _probe_lists(card, case)
    want = ck.ivf_probe_quads_plain(chains, pool.shape[0])
    for _ in range(2):
        got = ck.ivf_probe_quads(chains, pool.shape[0])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (d, rows a chunk): the serving width; a d that is not a multiple of
# the 16-byte load width (element loads); d = 1536; a d whose f32 row is
# past the 48 KB shared-memory window (streamed in 32-wide groups).
_MATVEC_SHAPES = [(128, 256), (33, 37), (1536, 64), (12_800, 8)]
_PAYLOADS = [torch.float32, torch.bfloat16, torch.float16, torch.uint8]


def _matvec_inputs(card, dtype, d, ch, pairs=40, n_chunks=30, nc=5):
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(pairs, d, generator=g, device=card)
    if dtype == torch.uint8:
        pool = torch.randint(0, 256, (n_chunks, ch, d), generator=g, device=card).to(dtype)
    else:
        pool = torch.randn(n_chunks, ch, d, generator=g, device=card).to(dtype)
    chains = torch.randint(-1, n_chunks, (pairs, nc), generator=g, device=card, dtype=torch.int32)
    return q, chains, pool


@pytest.mark.parametrize("dtype", _PAYLOADS, ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("shape", _MATVEC_SHAPES, ids=lambda s: "d%d-ch%d" % s)
def test_ivf_matvec_matches_plain(card, shape, dtype):
    d, ch = shape
    q, chains, pool = _matvec_inputs(card, dtype, d, ch)
    cap = chains.shape[1] * ch - 3
    got = ck.ivf_probe_matvec_fused(q, chains, pool, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.ivf_probe_matvec_plain(q, chains, pool, cap=cap))
    probe = chains[:, 0].clamp_min(0)  # the TPU contract: one chunk a vector
    assert torch.equal(ck.ivf_probe_matvec_fused(q, probe, pool),
                       ck.ivf_probe_matvec_plain(q, probe, pool))


def test_ivf_matvec_edges(card):
    """No pairs; a pool view that is not 16-byte aligned (element loads);
    a cap of 0; chunk ids past the pool give 0."""
    q, chains, pool = _matvec_inputs(card, torch.float32, 128, 64)
    assert ck.ivf_probe_matvec_fused(q[:0], chains[:0], pool).shape == (0, chains.shape[1] * 64)
    flat = torch.randn(30 * 64 * 128 + 1, device=card)
    odd = flat[1:].view(30, 64, 128)  # offset by 4 bytes
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(ck.ivf_probe_matvec_fused(q, chains, odd),
                       ck.ivf_probe_matvec_plain(q, chains, odd))
    assert not bool(ck.ivf_probe_matvec_fused(q, chains, pool, cap=0).any())
    stray = chains.clone()
    stray[:, 0] = pool.shape[0] + 1000
    got = ck.ivf_probe_matvec_fused(q, stray, pool)
    assert torch.equal(got, ck.ivf_probe_matvec_plain(q, stray, pool))
    assert not bool(got[:, :64].any())


# The chunk-major K6 on the shapes its work list makes new: (pairs, chain
# length, rows a chunk, chunks in the pool, cap or None, how the chains
# are drawn).
_MATVEC_PLANS = {
    "one_chunk_many_pairs": (300, 1, 256, 6, None, "hot"),
    "one_chunk_one_pair": (5, 3, 40, 20, None, "single"),
    "long_chain_among_short": (40, 12, 64, 60, None, "skew"),
    "repeats_and_stray_ids": (30, 6, 37, 10, None, "stray"),
    "cap_mid_chunk": (25, 4, 256, 12, 2 * 256 + 37, "random"),
    "cap_zero": (25, 4, 64, 12, 0, "random"),
    "one_pair": (1, 5, 256, 8, None, "random"),
    "probe_1d": (50, 0, 256, 8, None, "random"),
    # chunks of more than one 256-row tile: cap in slot 1's second tile
    # (ch not a multiple of 4), and 70 pairs on one 512-row chunk
    "rows_past_one_tile": (30, 4, 300, 12, 300 + 270, "random"),
    "two_row_tiles_hot": (70, 3, 512, 6, None, "hot"),
}


def _plan_chains(card, how, pairs, nc, n_chunks, g):
    """Chunk chains ``[pairs, nc]`` (a ``[pairs]`` probe when nc is 0)."""
    if nc == 0:
        return torch.randint(0, n_chunks, (pairs,), generator=g, device=card, dtype=torch.int32)
    chains = torch.randint(0, n_chunks, (pairs, nc), generator=g, device=card, dtype=torch.int32)
    if how == "hot":  # every pair probes chunk 2; one pair also probes chunk 4
        chains[:] = 2
        chains[7, 0] = 4
    elif how == "single":  # chunk 11 is probed by one pair, once
        chains[chains == 11] = 12
        chains[3, 1] = 11
    elif how == "skew":  # one pair walks 12 chunks, the rest one or two
        chains[1:, 2:] = -1
        chains[1:20, 1] = -1
    elif how == "stray":  # a chunk twice in one chain, -1, and ids past the pool
        chains[0, :3] = torch.tensor([4, 4, 4], dtype=torch.int32)
        chains[1::3, 2] = -1
        chains[2::4, 4] = n_chunks + 3
        chains[5, 5] = 2 ** 30
    return chains


def _plan_case(card, case, dtype, d):
    pairs, nc, ch, n_chunks, cap, how = _MATVEC_PLANS[case]
    g = torch.Generator(device=card).manual_seed(17)
    q = torch.randn(pairs, d, generator=g, device=card)
    if dtype == torch.uint8:
        pool = torch.randint(0, 256, (n_chunks, ch, d), generator=g, device=card).to(dtype)
    else:
        pool = torch.randn(n_chunks, ch, d, generator=g, device=card).to(dtype)
    return q, _plan_chains(card, how, pairs, nc, n_chunks, g), pool, cap


@pytest.mark.parametrize("d", [1, 7, 128, 200, 960])
@pytest.mark.parametrize("dtype", _PAYLOADS, ids=lambda t: str(t)[6:])
def test_ivf_matvec_chunk_major_matches_plain(card, dtype, d):
    """Every case of the work list, at every payload type and a d of one,
    one past the 16-byte reads, the serving width, a width that u8 cannot
    read 16 bytes at a time and GIST's."""
    for case in _MATVEC_PLANS:
        q, chains, pool, cap = _plan_case(card, case, dtype, d)
        before = ck.ivf_probe_matvec_fused.launches
        got = ck.ivf_probe_matvec_fused(q, chains, pool, cap=cap)
        torch.cuda.synchronize()
        assert ck.ivf_probe_matvec_fused.launches == before + 1
        assert torch.equal(got, ck.ivf_probe_matvec_plain(q, chains, pool, cap=cap)), case


@pytest.mark.parametrize("case", sorted(_MATVEC_PLANS))
def test_ivf_matvec_work_list_matches_plain(card, case):
    """The kernel's work list: each chunk's live entries, ascending, as
    the plain version lists them; the same on a second run."""
    q, chains, pool, cap = _plan_case(card, case, torch.float32, 4)
    n_chunks, ch = pool.shape[:2]
    got = ck.ivf_matvec_work_list(chains, n_chunks, ch, cap)
    want = ck.ivf_matvec_work_list_plain(chains, n_chunks, ch, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = ck.ivf_matvec_work_list(chains, n_chunks, ch, cap)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_ivf_matvec_search_operands_twice(card):
    """A many-segment work list (the serving shape's pair count, 23-chunk
    chains over a 1500-chunk pool) equals the plain version, and the
    kernel gives the same bits on a second run."""
    g = torch.Generator(device=card).manual_seed(19)
    pairs, nc, ch, n_chunks, d = 4096, 23, 256, 1500, 16
    lists = torch.randint(0, 300, (pairs,), generator=g, device=card)
    base = torch.randint(0, n_chunks, (300, nc), generator=g, device=card, dtype=torch.int32)
    base[torch.arange(nc, device=card) >= torch.randint(1, nc + 1, (300, 1), generator=g,
                                                          device=card)] = -1
    chains = base[lists]
    q = torch.randn(pairs, d, generator=g, device=card)
    pool = torch.randn(n_chunks, ch, d, generator=g, device=card)
    got = ck.ivf_matvec_work_list(chains, n_chunks, ch, nc * ch - 100)
    want = ck.ivf_matvec_work_list_plain(chains, n_chunks, ch, nc * ch - 100)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a = ck.ivf_probe_matvec_fused(q, chains, pool, cap=nc * ch - 100)
    b = ck.ivf_probe_matvec_fused(q, chains, pool, cap=nc * ch - 100)
    assert torch.equal(a, b)
    assert torch.equal(a, ck.ivf_probe_matvec_plain(q, chains, pool, cap=nc * ch - 100))


def _ivf_flat_indexes(card):
    import vq_tpu_torch

    g = torch.Generator(device=card).manual_seed(8)
    centres = torch.randn(40, 64, generator=g, device=card) * 3
    x = centres[torch.randint(0, 40, (20_000,), generator=g, device=card)]
    x = x + 0.3 * torch.randn(20_000, 64, generator=g, device=card)
    flat = vq_tpu_torch.IVFFlatIndex.train(x[:5000], 32, max_iters=5)
    out = [flat,
           vq_tpu_torch.IVFFlatIndex(flat.coarse, store_dtype="bfloat16"),
           vq_tpu_torch.IVFFlatIndex(flat.coarse, metric="dot", store_dtype="float16"),
           vq_tpu_torch.IVFSQIndex.train(x[:5000], 32, max_iters=5),
           vq_tpu_torch.IVFSQIndex.train(x[:5000], 32, max_iters=5, by_residual=False,
                                         metric="dot")]
    for idx in out:
        idx.add(x)
    return out, x[:50] + 0.01


def test_ivf_flat_and_sq_search_equal_plain_route(card, monkeypatch):
    import vq_tpu_torch.ivf_flat as ivf_flat

    indexes, q = _ivf_flat_indexes(card)
    for idx in indexes:
        for nprobe in (4, 32):
            before = ck.ivf_probe_matvec_fused.launches
            got = idx.search(q, k=10, nprobe=nprobe)
            assert ck.ivf_probe_matvec_fused.launches == before + 1
            with monkeypatch.context() as m:
                m.setattr(ivf_flat, "ivf_probe_matvec_fused", ck.ivf_probe_matvec_plain)
                want = idx.search(q, k=10, nprobe=nprobe)
            assert torch.equal(got[1], want[1]), (idx, nprobe)
            assert torch.equal(got[0], want[0]), (idx, nprobe)


def test_rq_and_ivfrq_search_equal_plain_route(card, monkeypatch):
    """RQIndex (K5 l2 / dot, K8 over chunks for rerank and cosine) and
    IVFRQIndex (K1 at add, K7 at search) on the card, each search equal
    to the same search with every kernel wrapper swapped for its plain
    version."""
    import vq_tpu_torch
    import vq_tpu_torch.ivf_flat as ivf_flat
    import vq_tpu_torch.models.pq as pq
    import vq_tpu_torch.search as search

    g = torch.Generator(device=card).manual_seed(9)
    x = torch.randn(30_000, 32, generator=g, device=card) @ torch.randn(32, 32, generator=g, device=card)
    q = x[:40] + 0.05
    quant = vq_tpu_torch.ResidualQuantizer(x[:5000], 4, 64, max_iters=4)
    indexes = [vq_tpu_torch.RQIndex(quant, metric=m, keep_corpus=True)
               for m in ("squared_euclidean", "dot", "cosine")]
    ivf = vq_tpu_torch.IVFRQIndex.train(x[:5000], 16, 4, 64, max_iters=4)
    for idx in indexes + [ivf]:
        idx.add(x)
    calls = [(idx, dict(k=10)) for idx in indexes] + [(indexes[0], dict(k=10, rerank=200)),
                                                      (indexes[0], dict(k=10, chunk=7000))]
    calls += [(ivf, dict(k=10, nprobe=p)) for p in (2, 16)]
    fns = (ck.adc_scan_topk_fused, ck.adc_lookup_fused, ck.ivf_probe_adc_fused)
    before = [f.launches for f in fns]
    got = [idx.search(q, **kw) for idx, kw in calls]
    assert all(f.launches > b for f, b in zip(fns, before))
    with monkeypatch.context() as mp:
        for mod, name in ((search, "adc_scan_topk_fused"), (pq, "adc_lookup_fused"),
                          (ivf_flat, "ivf_probe_adc_fused")):
            mp.setattr(mod, name, getattr(ck, name.replace("_fused", "_plain")))
        want = [idx.search(q, **kw) for idx, kw in calls]
    for (gi, gd), (wi, wd) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gi, wi)


def test_seeded_training_is_reproducible(card):
    """Seeded k-means++ and Lloyd give bit-identical results from one call
    to the next on one card (K2 is deterministic, and the k-means++ draws
    scan their CDF in a fixed order)."""
    from vq_tpu_torch.ops import kmeans

    g = torch.Generator(device=card).manual_seed(6)
    x = torch.randn(20_000, 32, generator=g, device=card)
    a = kmeans.kmeans_plusplus_init_device(x, 256, seed=1)
    assert torch.equal(a, kmeans.kmeans_plusplus_init_device(x, 256, seed=1))
    r1 = kmeans.lloyd(x, 256, max_iters=5, seed=2, init="kmeans++")
    r2 = kmeans.lloyd(x, 256, max_iters=5, seed=2, init="kmeans++")
    assert torch.equal(r1.centroids, r2.centroids)
    assert torch.equal(r1.assignments, r2.assignments)


def test_launch_counters_count_card_launches(card):
    x = torch.rand(100, 8, device=card)
    cb = torch.rand(2, 5, 4, device=card)
    fns = (ck.pq_encode_fused, ck.pq_lloyd_accumulate_fused, ck.assign_fused,
           ck.lloyd_accumulate_fused, ck.ivf_probe_adc_fused, ck.ivf_probe_matvec_fused,
           ck.adc_lookup_fused)
    before = [f.launches for f in fns]
    ck.adc_lookup_fused(torch.rand(3, 2, 5, device=card), torch.zeros(7, 2, dtype=torch.uint8, device=card))
    ck.pq_encode_fused(x, cb)
    ck.pq_lloyd_accumulate_fused(x, cb)
    ck.assign_fused(x, x[:5])
    ck.lloyd_accumulate_fused(x, x[:5])
    ck.ivf_probe_adc_fused(torch.rand(3, 2, 5, device=card), torch.zeros(3, dtype=torch.int32, device=card),
                           torch.zeros(1, 4, 2, dtype=torch.uint8, device=card))
    ck.ivf_probe_matvec_fused(torch.rand(3, 2, device=card), torch.zeros(3, dtype=torch.int32, device=card),
                              torch.zeros(1, 4, 2, dtype=torch.uint8, device=card))
    assert [f.launches for f in fns] == [b + 1 for b in before]


@pytest.mark.parametrize("n", [20_000, 77])
def test_weighted_lloyd_accumulate_matches_plain(card, n):
    g = torch.Generator(device=card).manual_seed(13)
    x = torch.randn(n, 64, generator=g, device=card)
    c = torch.randn(300, 64, generator=g, device=card)
    w = torch.rand(n, generator=g, device=card) * 2
    got = ck.lloyd_accumulate_fused(x, c, w)
    torch.cuda.synchronize()
    want = ck.lloyd_accumulate_plain(x, c, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ck.lloyd_accumulate_fused(x, c, w)))


def test_seeded_weighted_lloyd_is_reproducible(card):
    """Two seeded weighted ``lloyd`` runs give bit-identical centroids,
    assignments and inertia (K2 sums Σ w·x and Σ w in one fixed order)."""
    from vq_tpu_torch.ops import kmeans

    g = torch.Generator(device=card).manual_seed(14)
    x = torch.randn(30_000, 32, generator=g, device=card)
    w = torch.rand(30_000, generator=g, device=card) + 0.1
    runs = [kmeans.lloyd(x, 128, max_iters=6, seed=3, weights=w) for _ in range(2)]
    for field in ("centroids", "assignments", "inertia", "iterations"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field)), field


# (n, d, m, W): the script's shape (build_w), a dense W, a depth that is
# no multiple of the 16 / 32-deep chunks, one subspace, a ragged tile.
_MPACKED = [(5000, 128, 8, "build_w"), (3001, 128, 8, "dense"), (1000, 40, 3, "dense"),
            (130, 16, 1, "build_w")]


def _mpacked_inputs(card, n, d, m, kind):
    g = torch.Generator(device=card).manual_seed(15)
    x = torch.rand(n, d, generator=g, device=card)
    if kind == "build_w":
        return (x, *mp.build_w(torch.rand(m, 256, d // m, generator=g, device=card)))
    return (x, torch.randn(d, m * 256, generator=g, device=card),
            torch.rand(m * 256, generator=g, device=card))


@pytest.mark.parametrize("dtypes", ["f32", "bf16-x", "bf16-x-w"])
@pytest.mark.parametrize("shape", _MPACKED, ids=lambda s: "n%d-d%d-m%d-%s" % s)
def test_mpacked_highest_matches_plain(card, shape, dtypes):
    x, w, cc = _mpacked_inputs(card, *shape)
    if dtypes != "f32":
        x = x.to(torch.bfloat16)
    if dtypes == "bf16-x-w":
        w = w.to(torch.bfloat16)
    before = mp.mpacked_encode.launches_by["highest"]
    got = mp.mpacked_encode(x, w, cc, "highest", block_rows=256)
    torch.cuda.synchronize()
    assert mp.mpacked_encode.launches_by["highest"] == before + 1
    assert torch.equal(got, mp.mpacked_encode_plain(x, w, cc, "highest"))


def test_mpacked_highest_equals_k4(card):
    """On build_w's operands B1 "highest" gives K4's codes exactly."""
    g = torch.Generator(device=card).manual_seed(17)
    x = torch.rand(20_000, 128, generator=g, device=card)
    cb = torch.rand(8, 256, 16, generator=g, device=card)
    w, cc = mp.build_w(cb)
    assert torch.equal(mp.mpacked_encode(x, w, cc, "highest"), ck.pq_encode_fused(x, cb))


@pytest.mark.parametrize("bf16_in", [False, True], ids=["f32-x", "bf16-resident"])
@pytest.mark.parametrize("shape", _MPACKED, ids=lambda s: "n%d-d%d-m%d-%s" % s)
def test_mpacked_default_matches_plain(card, shape, bf16_in):
    x, w, cc = _mpacked_inputs(card, *shape)
    if bf16_in:
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got = mp.mpacked_encode(x, w, cc, "default", block_rows=192)
    par = mp.kernel_parity(x, w, cc, got, "default")
    assert par.ok, par


# (Q, m, k, n): the script's shape at a ragged Q and n; k = 128 with codes
# up to 255 (out of range: 0); 40 subspaces (one query's B3 table is
# 40 KB); 100 subspaces (past B3's shared-memory budget: tables read
# from device memory); Q past one B2 block's 128 queries.
_ADC = [(5, 4, 256, 1001), (20, 8, 128, 4096), (9, 40, 256, 3000), (3, 100, 256, 2002),
        (130, 8, 256, 999)]


@pytest.mark.parametrize("shape", _ADC, ids=lambda s: "Q%d-m%d-k%d-n%d" % s)
def test_adc_variants_match_plain_and_k8(card, shape):
    q, m, k, n = shape
    g = torch.Generator(device=card).manual_seed(16)
    tables = torch.rand(q, m, k, generator=g, device=card)
    codes_t = torch.randint(0, 256, (m, n), generator=g, device=card).to(torch.uint8)
    k8 = ck.adc_lookup_fused(tables, codes_t.T.contiguous())
    kt = av.adc_kt(tables, codes_t)
    gather = av.adc_gather(tables, codes_t)
    torch.cuda.synchronize()
    assert torch.equal(kt, av.adc_kt_plain(tables, codes_t))
    assert torch.equal(gather, av.adc_gather_plain(tables, codes_t))
    assert torch.equal(kt, k8) and torch.equal(gather, k8)
    for only in (1, m):
        assert torch.equal(av.adc_gather(tables, codes_t, only=only, block_rows=100),
                           av.adc_gather_plain(tables, codes_t, only=only))
    assert torch.equal(av.adc_floor(tables, codes_t), av.adc_floor_plain(tables, codes_t))


def test_bench_launch_counters_count_card_launches(card):
    x, w, cc = _mpacked_inputs(card, 100, 16, 1, "build_w")
    tables = torch.rand(3, 2, 16, device=card)
    codes_t = torch.zeros(2, 7, dtype=torch.uint8, device=card)
    fns = (mp.mpacked_encode, av.adc_kt, av.adc_gather, av.adc_floor)
    before = [f.launches for f in fns]
    mp.mpacked_encode(x, w, cc, "default")
    for f in fns[1:]:
        f(tables, codes_t)
    assert [f.launches for f in fns] == [b + 1 for b in before]


# BQ, TSVQ and the stable top-k have no kernel: plain PyTorch on the card,
# held to the same functions on the CPU copies.


@pytest.mark.parametrize("dim", [33, 384])
def test_bq_on_the_card_equals_the_cpu(card, dim):
    g = torch.Generator(device=card).manual_seed(21)
    x = torch.rand(20_000, dim, generator=g, device=card)
    x[5, 3], x[7, 0] = float("nan"), 0.5
    q = tbq.BinaryQuantizer(0.5, 2, 9)
    xc = x.cpu()
    assert torch.equal(q.quantize(x).cpu(), q.quantize(xc))
    packed = q.quantize_packed(x)
    assert packed.dtype == torch.uint32 and torch.equal(packed.cpu(), q.quantize_packed(xc))
    assert torch.equal(tbq.unpack_bits(packed, dim).cpu(), tbq.unpack_bits(packed.cpu(), dim))
    ham = tbq.hamming_distance(packed[:37], packed)
    assert torch.equal(ham.cpu(), tbq.hamming_distance(packed[:37].cpu(), packed.cpu()))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "cosine"])
def test_tsvq_encode_on_the_card_equals_the_cpu(card, metric):
    """Leaf ids equal the CPU run's except float near ties (two summation
    orders of the same distances)."""
    rng = np.random.default_rng(22)
    data = rng.random((20_000, 96), dtype=np.float32)
    q = tt.TSVQ(data, 6, metric, device=card)
    x = torch.from_numpy(rng.random((50_000, 96), dtype=np.float32))
    got = q.encode(x.to(card)).cpu()
    want = tt.TSVQ(tree=q.tree.to("cpu"), distance=metric).encode(x)
    gaps = tt.descent_gaps(q.tree, x, got, want, metric)
    assert (gaps <= 1e-5).all(), gaps
    assert gaps.size <= 5, gaps


def test_tsvq_device_build_on_the_card(card):
    """The card's level build equals the same build on the CPU bit for bit
    (one fixed order of f32 adds), and the host recursion's tree except
    splits at float near ties."""
    rng = np.random.default_rng(23)
    data = rng.random((30_000, 64), dtype=np.float32)
    data[11, 4] = np.nan
    on_card = tt.tsvq_build_batched(torch.from_numpy(data).to(card), 5)
    on_cpu = tt.tsvq_build_batched(data, 5, device="cpu")
    assert torch.equal(on_card.left.cpu(), on_cpu.left) and torch.equal(on_card.right.cpu(), on_cpu.right)
    assert torch.equal(on_card.centroids.cpu().nan_to_num(7.0), on_cpu.centroids.nan_to_num(7.0))
    host = tt.tsvq_build(data, 5, device="cpu")
    for _, _, _, dev_a, dev_b in tt.split_differences(data, host, on_card):
        assert abs(dev_a - dev_b) <= 1e-5 * max(dev_a, dev_b)


def test_smallest_order_on_the_card_equals_the_cpu(card):
    """The stable sort under the searches' and recall's top-k: the card's
    order equals the CPU's on +-0.0, NaN of either sign and heavy ties."""
    neg_nan = torch.tensor([-0x400000], dtype=torch.int32).view(torch.float32)[0].item()
    pool = torch.tensor([0.0, -0.0, 1.0, -1.0, float("nan"), neg_nan, float("inf"),
                         float("-inf"), 0.5])
    g = torch.Generator().manual_seed(24)
    for shape, k in (((64, 300), 10), ((8, 70_000), 500), ((3, 2049), 2049)):
        d = pool[torch.randint(0, pool.numel(), shape, generator=g)]
        vals, pos = _smallest(d.to(card), k)
        want_vals, want_pos = _smallest(d, k)
        assert torch.equal(pos.cpu(), want_pos)
        assert torch.equal(vals.cpu().view(torch.int32), want_vals.view(torch.int32))


# ---------------------------------------------------------------------------
# The flat serving layer: FlatIndex, SQIndex, BinaryIndex, range_search,
# knn_graph. Searches on the card against the same index on the CPU:
# values within rtol 1e-5 / atol 1e-3 (the devices' products sum in their
# own f32 orders), ids equal at every rank whose value lies farther than
# that from every other value of its row; Hamming counts bit for bit; PQ /
# RQ range_search (K8 a chunk) bit for bit against the plain route.
# ---------------------------------------------------------------------------


def _separated_parity(got, want, rtol=1e-5, atol=1e-3):
    gi, gd = (t.cpu() for t in got)
    wi, wd = (t.cpu() for t in want)
    assert gi.dtype == torch.int32 and gi.shape == wi.shape
    assert bool(torch.isclose(gd, wd, rtol=rtol, atol=atol).all())
    fin = torch.where(torch.isfinite(wd), wd, 1e30)
    close = (fin[:, :, None] - fin[:, None, :]).abs() <= atol + rtol * fin[:, None, :].abs()
    apart = close.sum(-1) == 1
    assert torch.equal(torch.where(apart, gi, -2), torch.where(apart, wi, -2))


def _flat_data(card, n=30_000, d=32):
    g = torch.Generator(device=card).manual_seed(31)
    centres = torch.randn(64, d, generator=g, device=card) * 3
    x = centres[torch.randint(0, 64, (n,), generator=g, device=card)] + torch.randn(
        n, d, generator=g, device=card)
    return x, x[:40] + 0.1 * torch.randn(40, d, generator=g, device=card)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["squared_euclidean", "euclidean", "cosine", "dot", "manhattan"])
def test_flat_index_on_the_card_equals_the_cpu(card, metric, storage):
    import vq_tpu_torch

    x, q = _flat_data(card)
    on_card = vq_tpu_torch.FlatIndex.from_data(x, metric=metric, storage=storage)
    on_cpu = vq_tpu_torch.FlatIndex.from_data(x.cpu(), metric=metric, storage=storage)
    got = on_card.search(q, k=10, chunk=7000)
    assert got[0].device == x.device
    _separated_parity(got, on_cpu.search(q.cpu(), k=10, chunk=7000))
    radius = float(got[1][:, 9].median())
    gi, gv, gc = on_card.range_search(q, radius, max_results=10, chunk=7000)
    assert torch.equal(gi, torch.where(gi >= 0, got[0], -1))
    wc = on_cpu.range_search(q.cpu(), radius, max_results=10, chunk=7000)[2]
    assert int((gc.cpu() - wc).abs().max()) <= 1  # a value on the radius may round either way


@pytest.mark.parametrize("levels", [256, 16])
def test_sq_index_on_the_card_equals_the_cpu(card, levels):
    import vq_tpu_torch

    x, q = _flat_data(card)
    on_card = vq_tpu_torch.SQIndex.from_data(x, levels, keep_corpus=True)
    on_cpu = vq_tpu_torch.SQIndex.from_data(x.cpu(), levels, keep_corpus=True)
    assert torch.equal(on_card._codes.cpu(), on_cpu._codes)
    for kw in (dict(k=10), dict(k=10, rerank=50), dict(k=10, chunk=7000)):
        _separated_parity(on_card.search(q, **kw), on_cpu.search(q.cpu(), **kw))
    dot_card = vq_tpu_torch.SQIndex(on_card.sq, metric="dot")
    dot_card.add(x)
    dot_cpu = vq_tpu_torch.SQIndex(on_cpu.sq, metric="dot")
    dot_cpu.add(x.cpu())
    _separated_parity(dot_card.search(q, k=10), dot_cpu.search(q.cpu(), k=10))


def test_binary_index_on_the_card_equals_the_cpu(card):
    import vq_tpu_torch

    x, q = _flat_data(card, d=40)
    on_card = vq_tpu_torch.BinaryIndex(40, threshold=0.5, keep_corpus=True, device=card)
    on_card.add(x)
    on_cpu = vq_tpu_torch.BinaryIndex(40, threshold=0.5, keep_corpus=True, device="cpu")
    on_cpu.add(x.cpu())
    assert torch.equal(on_card._packed.cpu(), on_cpu._packed)
    got, want = on_card.search(q, k=12), on_cpu.search(q.cpu(), k=12)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    _separated_parity(on_card.search(q, k=5, rerank=200), on_cpu.search(q.cpu(), k=5, rerank=200))


def test_pq_and_rq_range_search_equal_plain_route(card, monkeypatch):
    """PQ (squared L2, cosine, packed) and RQ (squared L2, cosine, dot)
    range_search sum their tables through K8 a chunk: bit for bit the
    same search with K8 swapped for its plain version."""
    import vq_tpu_torch
    import vq_tpu_torch.models.pq as pq_mod

    x, q = _flat_data(card)
    indexes = []
    for metric, k in (("squared_euclidean", 64), ("cosine", 64), ("squared_euclidean", 16)):
        pq = vq_tpu_torch.ProductQuantizer(x[:5000], 8, k, max_iters=3, distance=metric)
        idx = vq_tpu_torch.PQIndex(pq)
        idx.add(x)
        indexes.append(idx)
    rq = vq_tpu_torch.ResidualQuantizer(x[:5000], 3, 64, max_iters=3)
    for metric in ("squared_euclidean", "cosine", "dot"):
        idx = vq_tpu_torch.RQIndex(rq, metric=metric)
        idx.add(x)
        indexes.append(idx)
    radii = [float(i.search(q, k=10)[1][:, 9].median()) for i in indexes]
    before = ck.adc_lookup_fused.launches
    got = [i.range_search(q, r, max_results=16, chunk=7000) for i, r in zip(indexes, radii)]
    assert ck.adc_lookup_fused.launches - before == 5 * 7  # 5 chunks a scan, PQ cosine's twice
    with monkeypatch.context() as m:
        m.setattr(pq_mod, "adc_lookup_fused", ck.adc_lookup_plain)
        want = [i.range_search(q, r, max_results=16, chunk=7000) for i, r in zip(indexes, radii)]
    for g_, w_ in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g_, w_))


def test_knn_graph_on_the_card_equals_the_cpu(card):
    import vq_tpu_torch

    x, _ = _flat_data(card, n=5000)
    got = vq_tpu_torch.knn_graph(x, k=8, query_batch=700)
    assert got[0].device == x.device
    _separated_parity(got, vq_tpu_torch.knn_graph(x.cpu(), k=8, query_batch=700))
    assert not bool((got[0] == torch.arange(5000, device=card)[:, None]).any())


# ---------------------------------------------------------------------------
# Score-aware PQ, the dot IVF-PQ index and OPQ.
# ---------------------------------------------------------------------------


def _mips_rows(card, n=30_000, d=32):
    """Clustered rows of varied norms, and 40 queries."""
    g = torch.Generator(device=card).manual_seed(41)
    centres = torch.randn(48, d, generator=g, device=card) * 2
    x = centres[torch.randint(0, 48, (n,), generator=g, device=card)] + torch.randn(
        n, d, generator=g, device=card)
    x = x * (0.3 + 2.7 * torch.rand(n, 1, generator=g, device=card))
    return x, torch.randn(40, d, generator=g, device=card)


def _aniso_row_losses(x, cb, codes, eta):
    x, cb = x.double(), cb.double()
    rec = cb[torch.arange(cb.shape[0], device=cb.device)[None, :], codes.long()].reshape(x.shape)
    r = x - rec
    norm = x.norm(dim=1)
    par = torch.where(norm > 0, (r * x).sum(1) / norm.clamp_min(1e-300), 0.0)
    return (r * r).sum(1) + (eta - 1.0) * par * par


def test_mips_search_equals_plain_route(card, monkeypatch):
    """``mips_search`` launches K5 in mode "dot" once a search (K8 a
    chunk where k > 128) and equals, bit for bit, the same search with
    the kernels swapped for their plain versions; the card's anisotropic
    codes equal the CPU's but at float64 near ties of a row's loss."""
    import vq_tpu_torch
    import vq_tpu_torch.models.pq as pq_mod
    import vq_tpu_torch.models.pq_anisotropic as tpa

    x, q = _mips_rows(card)
    apq = vq_tpu_torch.AnisotropicProductQuantizer(x[:5000], 4, 64, max_iters=4, refine_iters=2)
    codes = apq.encode(x)
    cpu = vq_tpu_torch.AnisotropicProductQuantizer(codebooks=apq.codebooks.cpu(), eta=apq.eta)
    want_codes = cpu.encode(x.cpu())
    rows = (codes.cpu() != want_codes).any(1)
    assert int(rows.sum()) <= 0.001 * x.shape[0]
    if bool(rows.any()):
        lg = _aniso_row_losses(x.cpu()[rows], cpu.codebooks, codes.cpu()[rows], apq.eta)
        lw = _aniso_row_losses(x.cpu()[rows], cpu.codebooks, want_codes[rows], apq.eta)
        assert bool(((lg - lw).abs() <= 1e-5 * lw.abs().clamp_min(1.0)).all())
    calls = [dict(k=10), dict(k=128), dict(k=150, chunk=7000)]
    before5, before8 = ck.adc_scan_topk_fused.launches, ck.adc_lookup_fused.launches
    got = [apq.mips_search(q, codes, **kw) for kw in calls]
    assert ck.adc_scan_topk_fused.launches == before5 + 2
    assert ck.adc_lookup_fused.launches == before8 + 5  # 5 chunks of 7000 rows
    with monkeypatch.context() as m:
        m.setattr(tpa, "adc_scan_topk_fused", ck.adc_scan_topk_plain)
        m.setattr(pq_mod, "adc_lookup_fused", ck.adc_lookup_plain)
        want = [apq.mips_search(q, codes, **kw) for kw in calls]
    for (gi, gs), (wi, ws) in zip(got, want):
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        assert bool((gs[:, :-1] >= gs[:, 1:]).all())


def test_anisotropic_refine_is_reproducible(card):
    """The refine's per-entry sums are one-hot fp32 products over row
    blocks in one order: the same bits on a second run."""
    import vq_tpu_torch
    from vq_tpu_torch.models.pq_anisotropic import pq_refine_anisotropic

    x, _ = _mips_rows(card)
    cb0 = vq_tpu_torch.pq_train(x[:10_000], 4, 64, max_iters=3)
    a = pq_refine_anisotropic(x, cb0, iters=3, chunk=7000)
    b = pq_refine_anisotropic(x, cb0, iters=3, chunk=7000)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    c = pq_refine_anisotropic(x.cpu(), cb0.cpu(), iters=3, chunk=7000)
    assert torch.allclose(a[0].cpu(), c[0], atol=1e-4, rtol=0)
    assert abs(float(a[2]) - float(c[2])) <= 1e-5 * abs(float(c[2]))


def test_ivfpq_dot_search_equals_plain_route(card, monkeypatch):
    """The dot IVF-PQ index (anisotropic codes on the raw rows, and plain
    PQ on the residuals with the q.c offset) launches K7 once a search,
    over negated dot tables, and equals the search with K7 swapped for its
    plain version, with and without rerank."""
    import vq_tpu_torch
    import vq_tpu_torch.ivf as ivf_mod

    x, q = _mips_rows(card)
    for by_residual in (False, True):
        idx = vq_tpu_torch.IVFPQIndex.train(x[:8000], 32, 4, 64, max_iters=4, metric="dot",
                                            by_residual=by_residual, keep_corpus=True)
        idx.add(x)
        for kw in (dict(nprobe=4), dict(nprobe=32), dict(nprobe=4, rerank=100)):
            before = ck.ivf_probe_adc_fused.launches
            got = idx.search(q, k=10, **kw)
            assert ck.ivf_probe_adc_fused.launches == before + 1
            with monkeypatch.context() as m:
                m.setattr(ivf_mod, "ivf_probe_adc_fused", ck.ivf_probe_adc_plain)
                want = idx.search(q, k=10, **kw)
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), (by_residual, kw)
            assert bool((got[1][:, :-1] >= got[1][:, 1:]).all())


def test_opq_on_the_card_equals_the_cpu(card):
    """OPQ trained on the card (K3, K4, the SVD), restored on the CPU from
    its arrays: codes equal but at float64 near ties of ``x @ R``'s
    scores, and ``adc_search`` (K5 "sum") ids equal where separated."""
    import vq_tpu_torch

    x, _ = _mips_rows(card, n=20_000)
    x = x @ torch.randn(32, 32, generator=torch.Generator(device=card).manual_seed(42),
                        device=card)
    opq = vq_tpu_torch.OPQQuantizer(x[:5000], 4, 64, opq_iters=2, pq_iters=2)
    assert opq.rotation.device.type == "cuda"
    cpu = vq_tpu_torch.OPQQuantizer(rotation=opq.rotation.cpu(), codebooks=opq.codebooks.cpu())
    got, want = opq.encode(x), cpu.encode(x.cpu())
    flips, _, ties = ck.encode_near_ties(x.cpu() @ cpu.rotation, cpu.codebooks,
                                         got.cpu().to(torch.int32), want.to(torch.int32), "highest")
    assert flips <= 0.001 * got.numel() and ties, flips
    before = ck.adc_scan_topk_fused.launches
    ids, d = opq.adc_search(x[:30] + 0.01, got, k=10)
    assert ck.adc_scan_topk_fused.launches == before + 1
    _separated_parity((ids, d), cpu.adc_search(x[:30].cpu() + 0.01, got.cpu(), k=10))


def _pools_equal(a, b):
    """Two chunk pools' layouts and payloads (``b`` on the CPU): exactly,
    but for the f32 norms, whose sums the card orders its own way (rtol
    1e-6)."""
    assert (a.n_rows, a.nlist, a._tail, a._free) == (b.n_rows, b.nlist, b._tail, b._free)
    assert np.array_equal(a.lens_h, b.lens_h) and np.array_equal(a._chains_h, b._chains_h)
    assert torch.equal(a.slot_ids.cpu(), b.slot_ids)
    assert torch.equal(a.pos[:a.n_rows].cpu(), b.pos[:b.n_rows])
    assert torch.equal(a.chains_search().cpu(), b.chains_search())
    for name in a.specs:
        got, want = a.data[name].cpu(), b.data[name]
        if got.dtype == torch.uint32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if name in ("sqn", "cross"):
            assert bool(torch.isclose(got, want, rtol=1e-6, atol=1e-6).all()), name
        else:
            assert torch.equal(got, want), name


def test_pool_mutations_on_the_card_equal_the_cpu(card):
    """append, append(row_ids=), free_lists, relabel_lists and remove give
    the same layout on the card as on the CPU (uint32 words included)."""
    from vq_tpu_torch.ivf_pool import ChunkPool

    rng = np.random.default_rng(5)
    specs = {"codes": ((3,), torch.uint8), "words": ((2,), torch.uint32), "sqn": ((), torch.float32)}
    pools = [ChunkPool(specs, 6, chunk_rows=8, device=d) for d in (card, "cpu")]
    lists = np.zeros((0,), np.int32)

    def append(new_lists, row_ids=None, pay=None):
        nb = len(new_lists)
        if pay is None:
            pay = {"codes": torch.from_numpy(rng.integers(0, 256, (nb, 3)).astype(np.uint8)),
                   "words": torch.from_numpy(rng.integers(0, 2 ** 32, (nb, 2), dtype=np.uint64)
                                             .astype(np.uint32)),
                   "sqn": torch.from_numpy(rng.random(nb, dtype=np.float32))}
        for p in pools:
            kw = {} if row_ids is None else {"row_ids": torch.from_numpy(row_ids).to(p.device)}
            p.append(torch.from_numpy(new_lists).to(p.device),
                     {k: v.to(p.device) for k, v in pay.items()}, **kw)
        _pools_equal(*pools)

    for nb in (40, 7, 90):
        new = rng.integers(0, 6, nb).astype(np.int32)
        append(new)
        lists = np.r_[lists, new]
    moved = np.where(np.isin(lists, [0, 4]))[0]
    pay = {k: pools[1].gather_rows(k, torch.from_numpy(moved)) for k in specs}
    for p in pools:
        p.free_lists([0, 4])
        p.relabel_lists(np.array([0, 1, 2, 3, -1, 4]), 6)
    _pools_equal(*pools)
    new = rng.integers(0, 6, moved.size).astype(np.int32)
    append(new, row_ids=moved, pay=pay)
    lists = np.where(lists == 5, 4, lists)
    lists[moved] = new
    removed = np.sort(rng.choice(lists.size, 30, replace=False))
    for p in pools:
        p.remove(removed, lists)
    _pools_equal(*pools)
    assert pools[0]._free and pools[0].n_rows == lists.size - 30


def _ivf_pair(card, family, x, ref=None):
    """The same IVF index on the card and on the CPU (numpy coarse and
    codebooks drawn from the rows ``ref``, ``x`` by default), both filled
    with ``x``."""
    import vq_tpu_torch as t

    rng = np.random.default_rng(6)
    xs = (x if ref is None else ref).cpu().numpy()
    coarse = xs[rng.choice(len(xs), 32, replace=False)]
    lo, hi = xs.min(0) - coarse.max(0), xs.max(0) - coarse.min(0)
    rq_cbs = np.stack([xs[rng.choice(len(xs), 64)] * 0.3 ** (s + 1) for s in range(3)])
    pq_cb = rng.normal(0, 0.7, (4, 64, 8)).astype(np.float32)
    out = []
    for dev in (card, torch.device("cpu")):
        if family == "flat":
            idx = t.IVFFlatIndex(coarse, device=dev)
        elif family == "sq":
            idx = t.IVFSQIndex(coarse, t.PerDimScalarQuantizer(lo, hi, device=dev), device=dev)
        elif family == "rq":
            idx = t.IVFRQIndex(coarse, t.ResidualQuantizer(codebooks=rq_cbs, device=dev))
        else:  # "pq", "pq_dot"
            idx = t.IVFPQIndex(coarse, t.ProductQuantizer(codebooks=pq_cb, device=dev),
                               keep_corpus=True, metric="dot" if family == "pq_dot" else "l2")
        idx.add(x.to(dev))
        out.append(idx)
    return out


@pytest.mark.parametrize("family", ["flat", "pq"])
def test_stubbed_rebalance_on_the_card_equals_the_cpu(card, family, monkeypatch):
    """With the split's lloyd stubbed (first k rows), the rebalance on the
    card (K1's reassignment, K4's re-encode for IVF-PQ) gives the CPU's
    centroids, lists and pool layout, and searches that agree."""
    import types

    import vq_tpu_torch.ivf_flat as flat_mod

    x, q = _flat_data(card)
    skew = x[torch.randint(0, 2000, (20_000,), generator=torch.Generator(device=card).manual_seed(8),
                           device=card)]
    on_card, on_cpu = _ivf_pair(card, family, torch.cat([x, skew]))
    monkeypatch.setattr(flat_mod, "lloyd", lambda v, k, **_: types.SimpleNamespace(centroids=v[:k]))
    before = ck.assign_fused.launches, ck.pq_encode_fused.launches
    info = on_card.rebalance(min_size=100)
    assert ck.assign_fused.launches > before[0]
    assert family != "pq" or ck.pq_encode_fused.launches > before[1]
    assert info == on_cpu.rebalance(min_size=100) and info["split"] >= 1
    assert torch.equal(on_card.coarse.cpu(), on_cpu.coarse)
    assert torch.equal(on_card._flat_lists.cpu(), on_cpu._flat_lists)
    _pools_equal(on_card._pool, on_cpu._pool)
    _separated_parity(on_card.search(q, k=10, nprobe=6), on_cpu.search(q.cpu(), k=10, nprobe=6),
                      atol=1e-2)


@pytest.mark.parametrize("family", ["flat", "sq", "rq", "pq", "pq_dot"])
def test_ivf_range_search_equals_plain_route(card, family, monkeypatch):
    """range_search takes the search's probe: one K6 (IVF-Flat, IVF-SQ) or
    K7 (IVF-RQ, IVF-PQ) launch a call, bit for bit the same result with the
    kernel swapped for its plain version, after a remove and a merge."""
    import vq_tpu_torch.ivf as ivf_mod
    import vq_tpu_torch.ivf_flat as flat_mod

    x, q = _flat_data(card)
    idx, _ = _ivf_pair(card, family, x[:20_000], ref=x)
    other, _ = _ivf_pair(card, family, x[20_000:], ref=x)
    idx.remove_ids(torch.arange(0, 20_000, 9, device=card))
    idx.merge_from(other)
    kernel = "ivf_probe_matvec_fused" if family in ("flat", "sq") else "ivf_probe_adc_fused"
    mod = ivf_mod if family.startswith("pq") else flat_mod
    vals = idx.search(q, k=10, nprobe=6)[1][:, 9]
    radius = float(vals.median())
    before = getattr(ck, kernel).launches
    got = [idx.range_search(q, radius, nprobe=p, max_results=m) for p, m in ((6, 64), (1, 4096))]
    assert getattr(ck, kernel).launches == before + 2
    with monkeypatch.context() as m:
        m.setattr(mod, kernel, getattr(ck, kernel.replace("_fused", "_plain")))
        want = [idx.range_search(q, radius, nprobe=p, max_results=m) for p, m in ((6, 64), (1, 4096))]
    for g_, w_ in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g_, w_))
    assert int(got[0][2].sum()) > 0


def test_ivf_binary_on_the_card_equals_the_cpu(card):
    """IVFBinaryIndex: Hamming searches (ties included) and range counts
    equal the CPU's bit for bit; reranked values within fp32 tolerance."""
    import vq_tpu_torch

    x, q = _flat_data(card)
    coarse = x[:: 1000][:30].cpu().numpy()
    on_card = vq_tpu_torch.IVFBinaryIndex(coarse, keep_corpus=True, device=card)
    on_cpu = vq_tpu_torch.IVFBinaryIndex(coarse, keep_corpus=True, device="cpu")
    on_card.add(x)
    on_cpu.add(x.cpu())
    _pools_equal(on_card._pool, on_cpu._pool)
    for kw in (dict(nprobe=4), dict(nprobe=30, k=50)):
        got, want = on_card.search(q, **kw), on_cpu.search(q.cpu(), **kw)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    _separated_parity(on_card.search(q, k=5, nprobe=8, rerank=200),
                      on_cpu.search(q.cpu(), k=5, nprobe=8, rerank=200))
    got, want = on_card.range_search(q, 6.0, nprobe=8), on_cpu.range_search(q.cpu(), 6.0, nprobe=8)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# Kmeans, the transforms, RefineIndex, load_index / IdMapIndex and
# BatchPipeline on the card: each equal to the same entry point on the CPU.
# ---------------------------------------------------------------------------


def _gapped(card, n=20_000, d=32):
    """Rows with a well-gapped spectrum (variances 16 * 0.7^j, j < 12,
    then a 1e-4 floor) along a random basis, so PCA's components are
    determined up to sign."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q, _ = torch.linalg.qr(torch.randn(d, d, generator=g, dtype=torch.float64))
    sd = torch.cat([4 * 0.7 ** (torch.arange(12, dtype=torch.float64) / 2),
                    torch.full((d - 12,), 1e-2, dtype=torch.float64)])
    z = torch.randn(n, d, generator=g, dtype=torch.float64) * sd
    return (z @ q.T + 2.0).to(torch.float32).to(card)


def test_kmeans_on_the_card_equals_the_cpu(card):
    """Warm-started Kmeans (K2 an iteration, K1 at the end): centroids
    within 1e-4, the objective within 1e-5 relative, labels equal (the
    blobs' distances are far apart); a seeded run the same bits twice."""
    import vq_tpu_torch

    x, _ = _flat_data(card)
    init = x[:64].clone()
    kw = dict(niter=6, max_points_per_centroid=0)
    on_card, on_cpu = vq_tpu_torch.Kmeans(32, 64, **kw), vq_tpu_torch.Kmeans(32, 64, **kw)
    before = ck.lloyd_accumulate_fused.launches, ck.assign_fused.launches
    obj = on_card.train(x, init_centroids=init)
    assert ck.lloyd_accumulate_fused.launches > before[0] and ck.assign_fused.launches > before[1]
    assert obj == pytest.approx(on_cpu.train(x.cpu(), init_centroids=init.cpu()), rel=1e-5)
    assert torch.allclose(on_card.centroids.cpu(), on_cpu.centroids, rtol=1e-4, atol=1e-4)
    _, lab = on_card.assign(x)
    _, want = on_cpu.assign(x.cpu())
    assert lab.device == x.device and torch.equal(lab.cpu(), want)
    ids, _ = on_card.index.search(x[:100], 1)
    assert torch.equal(ids[:, 0], lab[:100])
    a = vq_tpu_torch.Kmeans(32, 64, niter=5, nredo=2, seed=4, max_points_per_centroid=100)
    b = vq_tpu_torch.Kmeans(32, 64, niter=5, nredo=2, seed=4, max_points_per_centroid=100)
    assert a.train(x) == b.train(x) and torch.equal(a.centroids, b.centroids)


def test_transforms_on_the_card_equal_the_cpu(card):
    """PCA fitted on the card: mean within 1e-5, eigenvalues within 1e-4
    of the largest, components within 1e-4 up to sign (cuSOLVER and
    LAPACK choose their own signs); apply / reverse from one state within
    1e-5; ITQ's alternation from one start within 1e-4; a seeded rotation
    orthonormal."""
    import vq_tpu_torch
    import vq_tpu_torch.transforms as ttr
    from vq_tpu_torch.convert import from_state, state_of

    x = _gapped(card)
    on_card = vq_tpu_torch.PCATransform(32, 10).fit(x)
    on_cpu = vq_tpu_torch.PCATransform(32, 10).fit(x.cpu())
    assert torch.allclose(on_card._mean.cpu(), on_cpu._mean, rtol=1e-5, atol=1e-5)
    w = on_cpu.explained_variance
    assert torch.allclose(on_card.explained_variance.cpu(), w, rtol=0, atol=1e-4 * float(w[0]))
    cc, cw = on_card._components.cpu(), on_cpu._components
    signs = torch.sign((cc * cw).sum(0))
    assert torch.allclose(cc * signs, cw, rtol=0, atol=1e-4)
    carried = from_state(*state_of(on_cpu), device=card)
    y = carried.apply(x[:500])
    assert y.device == x.device
    assert torch.allclose(y.cpu(), on_cpu.apply(x[:500].cpu()), rtol=1e-5, atol=1e-5)
    assert torch.allclose(carried.reverse(y).cpu(), on_cpu.reverse(y.cpu()), rtol=1e-5, atol=1e-5)
    v = on_cpu.apply(x[:4000].cpu())
    r0 = vq_tpu_torch.RotationTransform.random(10, seed=1, device="cpu").matrix
    got = ttr._itq_rotation(v.to(card), r0.to(card), 50)
    assert torch.allclose(got.cpu(), ttr._itq_rotation(v, r0, 50), rtol=0, atol=1e-4)
    r = vq_tpu_torch.RotationTransform.random(32, seed=2, device=card).matrix
    assert r.device == x.device
    assert torch.allclose(r.T @ r, torch.eye(32, device=card), atol=1e-5)
    chain = vq_tpu_torch.itq_train(x, 16, seed=1)
    assert all(t.device == x.device for t in chain)


def _refine_pair(card, refiner, x, xs):
    """The same RefineIndex over an IVF-PQ base on the card and on the CPU
    (numpy coarse and codebooks drawn from ``xs``), both filled with ``x``."""
    import vq_tpu_torch as t

    rng = np.random.default_rng(8)
    coarse = xs[rng.choice(len(xs), 32, replace=False)]
    pq_cb = rng.normal(0, 0.7, (4, 64, 8)).astype(np.float32)
    ref_cb = rng.normal(0, 0.2, (8, 32, 4)).astype(np.float32)
    out = []
    for dev in (card, torch.device("cpu")):
        base = t.IVFPQIndex(coarse, t.ProductQuantizer(codebooks=pq_cb, device=dev))
        r = t.ProductQuantizer(codebooks=ref_cb, device=dev) if refiner == "pq" else refiner
        idx = t.RefineIndex(base, r)
        idx.add(x.to(dev))
        out.append(idx)
    return out


@pytest.mark.parametrize("refiner", ["flat", "sq8", "pq"])
def test_refine_index_on_the_card_equals_the_cpu(card, refiner):
    """RefineIndex over IVF-PQ (K1 / K4 on add, K7 on search): flat and
    SQ8 codes exact, residual PQ codes on >= 99.9% of the rows; searches
    equal the CPU's at separated ranks (values within 1e-3); the card's
    search equal, bit for bit, to its own _search_core."""
    x, q = _flat_data(card)
    on_card, on_cpu = _refine_pair(card, refiner, x, x.cpu().numpy())
    got, want = on_card._codes.cpu(), on_cpu._codes
    if refiner == "pq":
        assert (got == want).all(-1).float().mean() >= 0.999
    else:
        assert torch.equal(got, want)
    before = ck.ivf_probe_adc_fused.launches
    res = on_card.search(q, k=10, k_factor=4, nprobe=6)
    assert ck.ivf_probe_adc_fused.launches == before + 1
    _separated_parity(res, on_cpu.search(q.cpu(), k=10, k_factor=4, nprobe=6),
                      atol=1e-2 if refiner == "pq" else 1e-3)
    fn, arrays = on_card._search_core(10, k_factor=4, nprobe=6)
    again = fn(q, *arrays)
    assert torch.equal(again[0], res[0]) and torch.equal(again[1], res[1])


def test_pipeline_on_the_card_equals_per_batch_and_goes_stale(card):
    """BatchPipeline over IVF-Flat (K6) and a refine index (K7): each
    batch bit for bit one search; a stale pipeline raises after
    rebalance()."""
    import vq_tpu_torch as t

    x, q = _flat_data(card)
    xs = x.cpu().numpy()
    ivf = t.IVFFlatIndex(xs[np.random.default_rng(9).choice(len(xs), 32, replace=False)],
                         device=card)
    ivf.add(x)
    ref, _ = _refine_pair(card, "sq8", x, xs)
    qs = torch.stack([q, q + 0.01, q - 0.01])
    for idx, kw in ((ivf, dict(nprobe=6)), (ref, dict(nprobe=6, k_factor=4))):
        ids, vals = t.BatchPipeline(idx, k=10, **kw).search(qs)
        assert ids.device == x.device
        for b in range(3):
            want = idx.search(qs[b], 10, **kw)
            assert torch.equal(ids[b], want[0]) and torch.equal(vals[b], want[1])
        flat_ids, _ = t.pipelined_search(idx, qs.reshape(-1, 32), k=10, batch=40, **kw)
        assert torch.equal(flat_ids.reshape(3, 40, 10), ids)
    pipe = t.BatchPipeline(ivf, k=10, nprobe=6)
    assert ivf.rebalance(target_max=600)["split"] > 0
    with pytest.raises(t.InvalidData):
        pipe.search(qs)


def test_new_kinds_round_trip_on_the_card(card, tmp_path):
    """load_index of a TransformedIndex, RefineIndex and IdMapIndex saved
    on the card, and Kmeans.load: the same search (or centroids) on the
    card, bit for bit."""
    import vq_tpu_torch as t

    x, q = _flat_data(card)
    xs = x.cpu().numpy()
    tr = t.TransformedIndex([t.PCATransform(32, 16).fit(x)], t.FlatIndex(16, device=card))
    tr.add(x)
    ref, _ = _refine_pair(card, "flat", x, xs)
    idm = t.IdMapIndex(t.FlatIndex(32, device=card))
    idm.add_with_ids(x, np.arange(len(xs), dtype=np.int64) + 2**35)
    for name, idx, kw in (("tr", tr, {}), ("ref", ref, dict(nprobe=6)), ("idm", idm, {})):
        back = t.load_index(idx.save(str(tmp_path / name)), device=card)
        got, want = back.search(q, 10, **kw), idx.search(q, 10, **kw)
        assert got[0].device == x.device
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    assert int(idm.search(q[:1], 1)[0][0, 0]) == 2**35  # q[0] is near row 0
    km = t.Kmeans(32, 16, niter=3, seed=1)
    km.train(x)
    back = t.Kmeans.load(km.save(str(tmp_path / "km")), device=card)
    assert torch.equal(back.centroids, km.centroids)
