"""OPQ in the port — ``models/opq.py`` — against the JAX package on the
same seeded numpy inputs (JAX on the CPU, the port on its plain CPU
paths: K3's and K4's plain versions). The JAX quantizer is trained once,
in the module fixture ``jax_opq``, and the other JAX calls take its
shapes, so that they reuse its compiled programs.

Tolerances:

* ``_procrustes`` (no random draws): the rotation within atol 1e-4, and
  orthogonal to 1e-5.
* A quantizer restored from the JAX package's rotation and codebooks:
  codes equal but at float near ties of ``x @ R`` (the PQ encode rule,
  ``cuda_kernels.encode_near_ties``: at least 99.9% equal, every other
  code a float64 gap within 1e-5 of the score); ``decode`` within atol
  1e-5 (one fp32 ``[d, d]`` product); ``quantize`` within one f16 step;
  ADC search ids equal at every rank whose distance is unique in its
  row, distances within rtol 1e-5 / atol 1e-3: the rotated queries come
  from two fp32 products whose last bits differ, and the tables' ``||q||^2
  - 2 q.c + ||c||^2`` (values up to ~150 here) carry that into ~1e-4.
* Seeded training (the random streams differ by design): reconstruction
  MSE within 5% of the JAX run's, and below plain PQ's on correlated data.
"""

import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu.models.opq as jopq
import vq_tpu.utils.serialize as jser
import vq_tpu_torch
import vq_tpu_torch.errors as terr
import vq_tpu_torch.models.opq as topq
from test_torch_pq import assert_search_parity, one_torch_thread  # noqa: F401  (an autouse fixture)
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_M, _K = 4, 16
_ADC_TOL = {"rtol": 1e-5, "atol": 1e-3}


def _correlated(seed=30, n=2000, d=32):
    """A low-rank mix plus noise, unevenly scaled: the case OPQ is for."""
    rng = np.random.default_rng(seed)
    latent = rng.normal(0, 1, (n, 6))
    mix = rng.normal(0, 1, (6, d)) * np.linspace(3.0, 0.2, d)
    return (latent @ mix + rng.normal(0, 0.1, (n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_opq():
    x = _correlated()
    return x, jopq.OPQQuantizer(x, _M, _K, opq_iters=4, pq_iters=3, seed=1)


@pytest.fixture(scope="module")
def restored(jax_opq):
    x, jq = jax_opq
    return topq.OPQQuantizer(rotation=np.asarray(jq.rotation), codebooks=np.asarray(jq.codebooks))


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def test_procrustes_matches_jax():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    rot0 = np.linalg.qr(rng.normal(size=(32, 32)))[0].astype(np.float32)
    y = (x @ rot0 + rng.normal(0, 0.3, x.shape)).astype(np.float32)
    want = np.asarray(jopq._procrustes(x, y))
    got = topq._procrustes(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose((got.T @ got).numpy(), np.eye(32), atol=1e-5)


def test_restored_encode_decode_match_jax(jax_opq, restored):
    x, jq = jax_opq
    got, want = restored.encode(x), np.asarray(jq.encode(x))
    assert got.dtype == torch.uint8 and got.shape == (x.shape[0], _M)
    xr = torch.from_numpy(x) @ restored.rotation
    flips, _, ties = ck.encode_near_ties(xr, restored.codebooks, got.to(torch.int32),
                                         torch.from_numpy(want.astype(np.int32)), "highest")
    assert flips <= 0.001 * got.numel() and ties, flips
    np.testing.assert_allclose(restored.decode(want).numpy(), np.asarray(jq.decode(want)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(restored.quantize(x).numpy().astype(np.float32),
                               np.asarray(jq.quantize(x)).astype(np.float32),
                               rtol=1e-3, atol=1e-3)
    one = restored.encode(x[0])
    assert one.shape == (_M,) and torch.equal(one, got[0])
    deq = restored.dequantize(restored.quantize(x[:5]))
    assert deq.dtype == torch.float32 and deq.shape == (5, 32)
    assert repr(restored).startswith(repr(jq)[:-1])
    assert (restored.num_subspaces, restored.num_centroids, restored.dim) == (_M, _K, 32)


@pytest.mark.parametrize("rerank", [0, 40])
def test_restored_adc_search_matches_jax(jax_opq, restored, rerank):
    x, jq = jax_opq
    codes = np.asarray(jq.encode(x))
    q = x[:9] + 0.05
    kw = {"rerank": rerank, "corpus": x} if rerank else {}
    want = jq.adc_search(q, codes, k=5, **kw)
    got = restored.adc_search(q, codes, k=5, **kw)
    assert_search_parity(got, want, **_ADC_TOL)


def test_seeded_training_matches_jax(jax_opq):
    x, jq = jax_opq
    tq = vq_tpu_torch.OPQQuantizer(x, _M, _K, opq_iters=4, pq_iters=3, seed=1)
    rot = tq.rotation
    np.testing.assert_allclose((rot.T @ rot).numpy(), np.eye(32), atol=1e-5)
    mse_t = _mse(tq.decode(tq.encode(x)).numpy(), x)
    mse_j = _mse(jq.decode(jq.encode(x)), x)
    assert abs(mse_t - mse_j) <= 0.05 * mse_j, (mse_t, mse_j)
    plain = vq_tpu_torch.ProductQuantizer(x, _M, _K, max_iters=10, seed=1)
    assert mse_t < _mse(plain.decode(plain.encode(x)).numpy(), x)
    rot2, cb2 = vq_tpu_torch.opq_train(x, _M, _K, opq_iters=4, pq_iters=3, seed=1)
    assert torch.equal(rot2, rot) and torch.equal(cb2, tq.codebooks)


def test_checkpoints_load_across_packages(jax_opq, restored, tmp_path):
    x, jq = jax_opq
    loaded = vq_tpu_torch.load(jser.save(str(tmp_path / "jax"), jq))
    assert isinstance(loaded, vq_tpu_torch.OPQQuantizer)
    assert torch.equal(loaded.rotation, restored.rotation)
    assert torch.equal(loaded.encode(x), restored.encode(x))
    back = jser.load(vq_tpu_torch.save(str(tmp_path / "port"), loaded))
    assert isinstance(back, jopq.OPQQuantizer)
    np.testing.assert_array_equal(np.asarray(back.rotation), np.asarray(jq.rotation))
    np.testing.assert_array_equal(np.asarray(back.codebooks), np.asarray(jq.codebooks))


_BAD = {
    "no_data": lambda p, x, q: p.OPQQuantizer(None, 4, 16),
    "no_m": lambda p, x, q: p.OPQQuantizer(x, None, 16),
    "m_divides": lambda p, x, q: p.opq_train(x, 5, 16, opq_iters=1),
    "m_zero": lambda p, x, q: p.opq_train(x, 0, 16, opq_iters=1),
    "encode_dim": lambda p, x, q: q.encode(x[:3, :30]),
    "quantize_dim": lambda p, x, q: q.quantize(x[:3, :30]),
    "dequantize_dim": lambda p, x, q: q.dequantize(x[:3, :30]),
    "search_dim": lambda p, x, q: q.adc_search(x[:3, :30], np.zeros((4, 4), np.uint8)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_errors_match_jax(jax_opq, restored, case):
    x, jq = jax_opq
    with pytest.raises(jerr.VqError) as want:
        _BAD[case](jopq, x[:100], jq)
    with pytest.raises(terr.VqError) as got:
        _BAD[case](topq, x[:100], restored)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_entry_points_default_to_the_card(jax_opq):
    """Numpy input and no ``device`` go to ``cuda``: with no card, that
    raises rather than running on the CPU."""
    x, jq = jax_opq
    arrays = {"rotation": np.asarray(jq.rotation), "codebooks": np.asarray(jq.codebooks)}
    with default_device(None):
        with pytest.raises(terr.InvalidParameter, match="no CUDA device"):
            vq_tpu_torch.OPQQuantizer(**arrays)
        with pytest.raises(terr.InvalidParameter, match="no CUDA device"):
            vq_tpu_torch.opq_train(x[:200], _M, _K, opq_iters=1, pq_iters=1)
    assert vq_tpu_torch.OPQQuantizer(**arrays).device == torch.device("cpu")


def test_cpu_tensors_never_launch(jax_opq, restored):
    x, _ = jax_opq
    fns = (ck.pq_encode_fused, ck.pq_lloyd_accumulate_fused, ck.adc_scan_topk_fused)
    before = [f.launches for f in fns]
    codes = restored.encode(x[:300])
    restored.adc_search(x[:4], codes, k=5)
    vq_tpu_torch.opq_train(x[:300], _M, _K, opq_iters=1, pq_iters=1, final_pq_iters=1)
    assert [f.launches for f in fns] == before
