"""``vq_tpu_torch.models.sq`` against ``vq_tpu.models.sq`` on the same
seeded numpy inputs.

Tolerances: codes exact (both packages compute
``floor((clamp(x) - lo) / step + 0.5)`` elementwise in fp32, one rounding
an operation); decoded values within one rounding of the largest value
of their column (``lo + code * step``: XLA's CPU backend contracts it
into one fused multiply-add, the port rounds the product and the sum
separately); fitted ranges exact (min / max and the pad of degenerate
dimensions are elementwise). Validation raises the same error classes
with the same messages, and ``.npz`` files load across packages in both
directions.
"""

import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from vq_tpu.models.sq import PerDimScalarQuantizer as JPerDim
from vq_tpu.models.sq import ScalarQuantizer as JSQ
from vq_tpu.utils import load as jload
from vq_tpu.utils import save as jsave
from vq_tpu_torch.models.sq import PerDimScalarQuantizer as TPerDim
from vq_tpu_torch.models.sq import ScalarQuantizer as TSQ
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _eq(got, want):
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decoded(got, want):
    """Decoded values: one rounding of the largest value of each column
    apart (a fused or a separate multiply-add)."""
    want = np.asarray(want)
    err = np.abs(got.numpy() - want)
    assert (err <= 2.0 ** -23 * np.abs(want).max(axis=0)).all(), err.max()


@pytest.mark.parametrize("levels", [2, 16, 200, 256])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.5, 2.25), (-1e-3, 1e-3)])
def test_scalar_codes_and_decode_match_jax(lo, hi, levels):
    rng = np.random.default_rng(levels)
    span = hi - lo
    x = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (300, 7)).astype(np.float32)
    j, t = JSQ(lo, hi, levels), TSQ(lo, hi, levels)
    codes = t.quantize(x)
    assert codes.dtype == torch.uint8
    _eq(codes, j.quantize(x))
    _decoded(t.dequantize(codes), j.dequantize(np.asarray(j.quantize(x))))
    assert t.step == j.step and t.levels == j.levels


def test_scalar_out_of_range_clamps_and_decode_extrapolates():
    j, t = JSQ(-1.0, 1.0, 16), TSQ(-1.0, 1.0, 16)
    x = np.array([-1e9, -1.0, -0.9999, 0.0, 0.9999, 1.0, 7.0, 1e30], np.float32)
    _eq(t.quantize(x), j.quantize(x))
    assert t.quantize(x).tolist() == [0, 0, 0, 7, 15, 15, 15, 15]  # 1 / fl32(2/15) < 7.5
    codes = np.arange(256, dtype=np.uint8)  # codes past levels - 1 extrapolate
    _decoded(t.dequantize(codes), j.dequantize(codes))
    assert float(t.dequantize(np.array([255], np.uint8))[0]) > 1.0


@pytest.mark.parametrize("levels", [256, 11])
def test_scalar_exact_midpoints_round_half_away(levels):
    """Midpoints between two levels go up (``floor(t + 0.5)``), where
    ``torch.round`` would round half to even."""
    j, t = JSQ(0.0, float(levels - 1), levels), TSQ(0.0, float(levels - 1), levels)
    x = np.arange(levels - 1, dtype=np.float32) + np.float32(0.5)  # step 1: exact halves
    codes = t.quantize(x)
    _eq(codes, j.quantize(x))
    assert codes.tolist() == list(range(1, levels))


def test_scalar_any_rank_and_integer_input():
    j, t = JSQ(-2.0, 5.0, 64), TSQ(-2.0, 5.0, 64)
    x = np.random.default_rng(3).normal(1, 3, (4, 5, 6)).astype(np.float32)
    _eq(t.quantize(x), j.quantize(x))
    assert tuple(t.quantize(x).shape) == (4, 5, 6)
    ints = np.arange(-4, 8, dtype=np.int32)
    _eq(t.quantize(ints), j.quantize(ints))
    _eq(t.quantize(torch.from_numpy(x).to(torch.float16)), j.quantize(x.astype(np.float16)))


@pytest.mark.parametrize("levels", [2, 100, 256])
def test_perdim_codes_and_decode_match_jax(levels):
    rng = np.random.default_rng(10 + levels)
    scale = np.array([1e-3, 0.5, 1.0, 4.0, 100.0] * 4, np.float32)
    train = (rng.normal(0, 1, (500, 20)) * scale).astype(np.float32)
    x = (rng.normal(0, 1.3, (400, 20)) * scale).astype(np.float32)  # some out of range
    j, t = JPerDim.from_data(train, levels), TPerDim.from_data(train, levels)
    _eq(t.mins, j.mins)
    _eq(t.maxs, j.maxs)
    _eq(t.steps, j.steps)
    codes = t.quantize(x)
    _eq(codes, j.quantize(x))
    _decoded(t.dequantize(codes), j.dequantize(np.asarray(codes)))
    assert t.dim == j.dim == 20 and t.levels == levels


def test_perdim_midpoints_round_half_away():
    lo = np.array([0.0, -4.0, 10.0], np.float32)
    hi = lo + 255.0  # step 1 in every dimension
    j, t = JPerDim(lo, hi), TPerDim(lo, hi)
    x = lo[None, :] + np.arange(255, dtype=np.float32)[:, None] + np.float32(0.5)
    codes = t.quantize(x)
    _eq(codes, j.quantize(x))
    np.testing.assert_array_equal(codes.numpy()[:, 0], np.arange(1, 256))


def test_from_data_degenerate_dimensions():
    """Constant columns (zero, small, large, negative) get the symmetric
    pad ``max(|lo| * 1e-6, 1e-6)`` and still decode to their value."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (64, 6)).astype(np.float32)
    x[:, 1] = 0.0
    x[:, 2] = 3e-9
    x[:, 3] = 12345.0
    x[:, 4] = -7.5
    j, t = JPerDim.from_data(x), TPerDim.from_data(x)
    _eq(t.mins, j.mins)
    _eq(t.maxs, j.maxs)
    codes = t.quantize(x)
    _eq(codes, j.quantize(x))
    rec = t.dequantize(codes).numpy()
    np.testing.assert_allclose(rec[:, 1:5], x[:, 1:5], rtol=1e-6, atol=2e-6)
    one_row = TPerDim.from_data(x[:1])  # every dimension degenerate
    _eq(one_row.mins, JPerDim.from_data(x[:1]).mins)


_SCALAR_BAD = [
    (float("nan"), 1.0, 256), (0.0, float("inf"), 256), (1.0, 1.0, 256),
    (2.0, 1.0, 256), (0.0, 1.0, 1), (0.0, 1.0, 257),
]


@pytest.mark.parametrize("args", _SCALAR_BAD, ids=lambda a: "min%s-max%s-levels%s" % a)
def test_scalar_validation_matches_jax(args):
    with pytest.raises(jerr.VqError) as want:
        JSQ(*args)
    with pytest.raises(terr.VqError) as got:
        TSQ(*args)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


_PERDIM_BAD = {
    "ragged": lambda S: S(np.zeros(3, np.float32), np.ones(4, np.float32)),
    "two_d": lambda S: S(np.zeros((2, 2), np.float32), np.ones((2, 2), np.float32)),
    "nonfinite": lambda S: S(np.array([0.0, np.nan], np.float32), np.ones(2, np.float32)),
    "inverted": lambda S: S(np.array([0.0, 2.0], np.float32), np.ones(2, np.float32)),
    "levels": lambda S: S(np.zeros(2, np.float32), np.ones(2, np.float32), 300),
    "from_data_empty": lambda S: S.from_data(np.zeros((0, 3), np.float32)),
    "from_data_1d": lambda S: S.from_data(np.zeros(3, np.float32)),
    "quantize_dim": lambda S: S(np.zeros(3, np.float32), np.ones(3, np.float32)).quantize(
        np.zeros((2, 4), np.float32)),
}


@pytest.mark.parametrize("case", sorted(_PERDIM_BAD))
def test_perdim_validation_matches_jax(case):
    with pytest.raises(jerr.VqError) as want:
        _PERDIM_BAD[case](JPerDim)
    with pytest.raises(terr.VqError) as got:
        _PERDIM_BAD[case](TPerDim)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_sq_checkpoints_load_across_packages(tmp_path):
    x = np.random.default_rng(7).normal(0, 2, (50, 9)).astype(np.float32)
    jsq, jpd = JSQ(-1.5, 3.0, 100), JPerDim.from_data(x, 64)
    port_sq = vq_tpu_torch.load(jsave(str(tmp_path / "jsq"), jsq))
    port_pd = vq_tpu_torch.load(jsave(str(tmp_path / "jpd"), jpd))
    assert isinstance(port_sq, TSQ) and isinstance(port_pd, TPerDim)
    assert (port_sq.min, port_sq.max, port_sq.levels) == (jsq.min, jsq.max, jsq.levels)
    _eq(port_sq.quantize(x), jsq.quantize(x))
    _eq(port_pd.quantize(x), jpd.quantize(x))
    back_sq = jload(vq_tpu_torch.save(str(tmp_path / "tsq"), port_sq))
    back_pd = jload(vq_tpu_torch.save(str(tmp_path / "tpd"), port_pd))
    assert isinstance(back_sq, JSQ) and isinstance(back_pd, JPerDim)
    np.testing.assert_array_equal(np.asarray(back_pd.mins), port_pd.mins.numpy())
    np.testing.assert_array_equal(np.asarray(back_pd.maxs), port_pd.maxs.numpy())
    assert back_pd.levels == 64 and back_sq.levels == 100
    _eq(port_pd.quantize(x), back_pd.quantize(x))


def test_exports_and_repr():
    assert vq_tpu_torch.ScalarQuantizer is TSQ
    assert vq_tpu_torch.PerDimScalarQuantizer is TPerDim
    assert repr(TSQ(0.0, 1.0, 4)) == repr(JSQ(0.0, 1.0, 4))
    pd = TPerDim(np.zeros(3, np.float32), np.ones(3, np.float32), 8)
    assert repr(pd) == "PerDimScalarQuantizer(dim=3, levels=8)"
    assert isinstance(pd, vq_tpu_torch.Quantizer)
