"""Each CUDA kernel of ``vq_tpu_torch`` against its plain PyTorch version,
on the card. Every test is marked ``cuda`` and skips where there is no
GPU. The file imports no JAX, so it also runs where only PyTorch is
installed; ``tests/conftest.py`` needs JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 codes and distances, K4 codes, K5 values and ids and K7
values exact (the kernels repeat the plain versions' fp32 arithmetic);
K2 and K3 counts exact, sums at rtol 1e-5 / atol 1e-4 and inertia at
rtol 1e-5 (fp32 summation order), and both bit-identical from one run
to the next.
"""

import numpy as np
import pytest
import torch

from vq_tpu_torch.ops import cuda_kernels as ck
from vq_tpu_torch.ops.packing import pack_codes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (m, k, s): the main configuration; s > 16 (slice read through L1); a
# subspace codebook too large for shared memory (streamed in chunks).
_PQ_SHAPES = [(8, 256, 16), (4, 300, 24), (2, 1000, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _PQ_SHAPES)
def test_pq_encode_matches_plain(card, shape, dtype):
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(5000, m * s, generator=g, device=card).to(dtype)
    cb = torch.randn(m, k, s, generator=g, device=card)
    got = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.pq_encode_plain(x, cb))


def test_pq_encode_nan_and_ties(card):
    cb = torch.rand(2, 6, 4, device=card)
    cb[:, 3] = cb[:, 1]
    cb[0, 0] = float("nan")
    x = torch.cat([cb[0], cb[1]], dim=1).nan_to_num(0.5)
    got = ck.pq_encode_fused(x, cb)
    assert torch.equal(got, ck.pq_encode_plain(x, cb))
    assert not bool((got == 3).any())


@pytest.mark.parametrize("shape", _PQ_SHAPES)
@pytest.mark.parametrize("n", [20_000, 77])
def test_pq_lloyd_matches_plain(card, shape, n):
    m, k, s = shape
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(n, m * s, generator=g, device=card)
    cb = torch.randn(m, k, s, generator=g, device=card)
    sums, counts, inertia = ck.pq_lloyd_accumulate_fused(x, cb)
    torch.cuda.synchronize()
    ps, pc, pi = ck.pq_lloyd_accumulate_plain(x, cb)
    assert torch.equal(counts, pc)
    torch.testing.assert_close(sums, ps, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(inertia, pi, rtol=1e-5, atol=0.0)
    again = ck.pq_lloyd_accumulate_fused(x, cb)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again))


def _adc_inputs(mode, pack_bits, device, n=5000):
    rng = np.random.default_rng(10)
    q, m = 3, 5
    k = {8: 200, 4: 16, 2: 4, 1: 2}[pack_bits]
    tables = torch.from_numpy(rng.random((q, m, k), dtype=np.float32))
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    codes[900] = codes[100]  # exact ties: the lowest id must come first
    codes[n - 1] = codes[100]
    codes_t = pack_codes(codes, pack_bits).T.contiguous()
    kw = {}
    if mode == "l2":
        kw = {"qn2": torch.from_numpy(rng.random(q, dtype=np.float32) * 4),
              "offsets": torch.from_numpy(rng.random(n, dtype=np.float32))}
    return tables.to(device), codes_t.to(device), {a: b.to(device) for a, b in kw.items()}


@pytest.mark.parametrize("pack_bits", [8, 4, 2, 1])
@pytest.mark.parametrize("mode", ["sum", "l2", "dot"])
@pytest.mark.parametrize("fetch", [1, 10, 128])
def test_adc_scan_topk_matches_plain(card, mode, pack_bits, fetch):
    tables, codes_t, kw = _adc_inputs(mode, pack_bits, card)
    got = ck.adc_scan_topk_fused(tables, codes_t, fetch, mode=mode, pack_bits=pack_bits, **kw)
    torch.cuda.synchronize()
    want = ck.adc_scan_topk_plain(tables, codes_t, fetch, mode=mode, pack_bits=pack_bits, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("tile", [128, 512, 2048])
def test_adc_scan_topk_tiles(card, tile):
    tables, codes_t, _ = _adc_inputs("sum", 8, card, n=3000)
    got = ck.adc_scan_topk_fused(tables, codes_t, 16, tile=tile)
    want = ck.adc_scan_topk_plain(tables, codes_t, 16, tile=tile)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# (n, k, d): the IVF coarse width, a ragged k and d, a k past every TPU
# VMEM budget (65536 at d = 128, one launch), and a single centroid.
_ASSIGN_SHAPES = [(5000, 1024, 128), (777, 300, 24), (300, 65536, 128), (65, 1, 7)]


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
    torch.testing.assert_close(sums, ps, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(inertia, pi, rtol=1e-5, atol=0.0)
    again = ck.lloyd_accumulate_fused(x, c)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again))


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
           ck.lloyd_accumulate_fused, ck.ivf_probe_adc_fused)
    before = [f.launches for f in fns]
    ck.pq_encode_fused(x, cb)
    ck.pq_lloyd_accumulate_fused(x, cb)
    ck.assign_fused(x, x[:5])
    ck.lloyd_accumulate_fused(x, x[:5])
    ck.ivf_probe_adc_fused(torch.rand(3, 2, 5, device=card), torch.zeros(3, dtype=torch.int32, device=card),
                           torch.zeros(1, 4, 2, dtype=torch.uint8, device=card))
    assert [f.launches for f in fns] == [b + 1 for b in before]
