"""Each CUDA kernel of ``vq_tpu_torch`` against its plain PyTorch version,
on the card. Every test is marked ``cuda`` and skips where there is no
GPU. The file imports no JAX, so it also runs where only PyTorch is
installed; ``tests/conftest.py`` needs JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K4 codes and K5 values and ids exact (the kernels repeat the
plain versions' fp32 arithmetic); K3 counts exact, sums at rtol 1e-5 /
atol 1e-4 and inertia at rtol 1e-5 (fp32 summation order), and K3
bit-identical from one run to the next.
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


def test_launch_counters_count_card_launches(card):
    x = torch.rand(100, 8, device=card)
    cb = torch.rand(2, 5, 4, device=card)
    before = ck.pq_encode_fused.launches, ck.pq_lloyd_accumulate_fused.launches
    ck.pq_encode_fused(x, cb)
    ck.pq_lloyd_accumulate_fused(x, cb)
    assert (ck.pq_encode_fused.launches, ck.pq_lloyd_accumulate_fused.launches) == (
        before[0] + 1, before[1] + 1)
