"""``vq_tpu_torch.models.bq`` against ``vq_tpu.models.bq`` on the same
seeded numpy inputs.

Tolerances: none. Codes, dequantized values, packed words, unpacked bits
and Hamming distances are bit for bit equal to the JAX package's, NaN
included (a NaN compares false against the threshold and maps to
``low``). Packed words are ``torch.uint32`` like the JAX package's.
Validation raises the same error classes, and ``bq`` checkpoints load
across packages in both directions.
"""

import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu_torch
import vq_tpu_torch.errors as terr
from vq_tpu.models import bq as jbq
from vq_tpu.utils import load as jload
from vq_tpu.utils import save as jsave
from vq_tpu_torch.models import bq as tbq
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _eq(got, want):
    assert isinstance(got, torch.Tensor)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _data(shape, seed=0):
    """Seeded normal values with NaN, +-inf, +-0.0 and exact threshold hits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 12), replace=False)
    specials = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 0.25]
    for i, p in enumerate(picks):
        flat[p] = specials[i % len(specials)]
    return x


@pytest.mark.parametrize("shape", [(7,), (40, 33), (3, 5, 64)], ids=str)
@pytest.mark.parametrize("threshold,low,high", [(0.0, 0, 1), (0.5, 3, 200), (0.25, 0, 255)])
def test_quantize_dequantize_match_jax(shape, threshold, low, high):
    x = _data(shape, seed=len(shape))
    j, t = jbq.BinaryQuantizer(threshold, low, high), tbq.BinaryQuantizer(threshold, low, high)
    codes = t.quantize(x)
    assert codes.dtype == torch.uint8
    _eq(codes, j.quantize(x))
    all_codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _eq(t.dequantize(all_codes), j.dequantize(all_codes))
    _eq(t.dequantize(codes), j.dequantize(np.asarray(j.quantize(x))))


def test_nan_maps_to_low():
    t = tbq.BinaryQuantizer(-1.0, low=7, high=9)
    x = np.array([np.nan, -np.nan, -2.0, -1.0, np.inf], np.float32)
    assert t.quantize(x).tolist() == [7, 7, 7, 9, 9]


@pytest.mark.parametrize("dim", [1, 31, 32, 33, 64, 100, 384])
def test_pack_unpack_match_jax(dim):
    rng = np.random.default_rng(dim)
    bits = rng.random((50, dim)) < 0.4
    words = tbq.pack_bits(bits)
    assert words.dtype == torch.uint32
    assert words.shape == (50, tbq.packed_width(dim)) and tbq.packed_width(dim) == jbq.packed_width(dim)
    _eq(words, jbq.pack_bits(bits))
    _eq(tbq.unpack_bits(words, dim), jbq.unpack_bits(np.asarray(jbq.pack_bits(bits)), dim))
    _eq(tbq.pack_bits(bits[0]), jbq.pack_bits(bits[0]))  # a 1-D row is one row
    all_ones = np.ones((2, dim), bool)
    assert int(tbq.pack_bits(all_ones).to(torch.int64).max()) == (2 ** min(dim, 32)) - 1


@pytest.mark.parametrize("dim", [33, 384])
def test_hamming_matches_jax(dim):
    rng = np.random.default_rng(dim + 1)
    a = np.array(jbq.pack_bits(rng.random((9, dim)) < 0.5))
    b = np.array(jbq.pack_bits(rng.random((130, dim)) < 0.5))
    got = tbq.hamming_distance(a, b)
    assert got.dtype == torch.int32
    _eq(got, jbq.hamming_distance(a, b))
    _eq(tbq.hamming_distance(a[0], b), jbq.hamming_distance(a[0], b))
    # uint32 tensors and the words' int32 bit patterns give the same counts.
    _eq(tbq.hamming_distance(torch.from_numpy(a), torch.from_numpy(b.view(np.int32))),
        jbq.hamming_distance(a, b))


def test_hamming_blocks_cover_every_pair(monkeypatch):
    """Blocks of one row and a few columns give the unblocked result."""
    rng = np.random.default_rng(5)
    a = tbq.pack_bits(rng.random((6, 70)) < 0.5)
    b = tbq.pack_bits(rng.random((23, 70)) < 0.5)
    whole = tbq.hamming_distance(a, b)
    monkeypatch.setitem(tbq._HAMMING_CELLS, "cpu", 15)  # 5 columns of 3 words a block
    assert torch.equal(tbq.hamming_distance(a, b), whole)
    bits_a, bits_b = tbq.unpack_bits(a, 70), tbq.unpack_bits(b, 70)
    assert torch.equal(whole.long(), (bits_a[:, None, :] != bits_b[None]).sum(-1))


def test_quantize_packed_match_jax():
    x = _data((20, 70), seed=3)
    j, t = jbq.BinaryQuantizer(0.1, 2, 5), tbq.BinaryQuantizer(0.1, 2, 5)
    packed = t.quantize_packed(x)
    _eq(packed, j.quantize_packed(x))
    _eq(t.dequantize_packed(packed, 70), j.dequantize_packed(np.asarray(packed), 70))
    _eq(t.quantize_packed(x[0]), j.quantize_packed(x[0]))


@pytest.mark.parametrize("args", [(float("nan"),), (float("inf"),), (0.0, 1, 1), (0.0, 2, 1),
                                  (0.0, -1, 1), (0.0, 0, 256)], ids=str)
def test_validation_matches_jax(args):
    with pytest.raises(jerr.InvalidParameter) as want:
        jbq.BinaryQuantizer(*args)
    with pytest.raises(terr.InvalidParameter) as got:
        tbq.BinaryQuantizer(*args)
    assert str(got.value) == str(want.value)


def test_checkpoints_load_across_packages(tmp_path):
    x = _data((10, 40), seed=4)
    j = jbq.BinaryQuantizer(0.3, 1, 6)
    t = vq_tpu_torch.load(jsave(str(tmp_path / "jax_bq"), j))
    assert isinstance(t, tbq.BinaryQuantizer) and repr(t) == repr(j)
    _eq(t.quantize(x), j.quantize(x))
    back = jload(vq_tpu_torch.save(str(tmp_path / "port_bq"), t))
    assert isinstance(back, jbq.BinaryQuantizer)
    assert (back.threshold, back.low, back.high) == (0.3, 1, 6)
