"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``vq_tpu_torch.ops.cuda_kernels`` runs its
plain PyTorch version, which is the arithmetic the CUDA kernel is held to
on the card; here it is held to the Pallas kernel run in interpret mode,
on the same numpy inputs. Tolerances: codes, counts, ADC values and ids
exact; K3 sums at rtol 1e-5 / atol 1e-4 and inertia at rtol 1e-5 (fp32
summation order). ``test_torch_cuda.py`` holds each CUDA kernel to its
plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.ops import cuda_kernels as ck


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
    assert before == (
        ck.pq_encode_fused.launches,
        ck.pq_lloyd_accumulate_fused.launches,
        ck.adc_scan_topk_fused.launches,
    )
