"""The PQ encode precision ladder of the port — K4-bf16 (``"bf16_fast"``,
``"default"``) and K4-bf16x3 (``"bf16x3"``, ``"high"``) — against the JAX
package, on the same seeded numpy inputs (JAX on the CPU).

* The plain versions against the Pallas bodies ``_pq_encode_bf16_kernel``
  and ``_pq_encode_bf16x3_kernel`` run in interpret mode: codes equal but
  where the two scores differ by no more than fp32 summation order, i.e.
  a near tie verified in float64 on the operands the precision defines
  (gap within 1e-5 of the sum of the absolute terms).
* ``pq_encode(precision=...)`` against the JAX package's
  ``pq_encode(precision=...)`` (its m-packed matmul; on the CPU "high" is
  exact f32 and "default" one bf16 pass): at least 0.999 of the codes
  equal for "high" / "bf16x3" and 0.97 for "default" / "bf16_fast", and
  every flip a near tie as ``tests/test_pq.py`` defines it (the exact
  squared distances of the two centroids within 2% of ``||x_sub||^2``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu.models.pq as jpq
import vq_tpu_torch
import vq_tpu_torch.models.pq as tpq
from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_TIE_RTOL = 1e-5  # of the sum of the absolute terms of a score


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _scores64(xs, cb, precision):
    """Scores ``[n, m, k]`` in float64 of the operands ``precision``
    defines, and the sum of the absolute terms of each."""
    cc = (cb.astype(np.float64) ** 2).sum(-1)
    if precision == "bf16_fast":
        parts = [(_bf16(xs), _bf16(cb))]
    else:
        xh, ch = _bf16(xs), _bf16(cb)
        xl, cl = _bf16(xs - xh), _bf16(cb - ch)
        parts = [(xh, ch), (xh, cl), (xl, ch)]
    dot = sum(np.einsum("nms,mks->nmk", a.astype(np.float64), b.astype(np.float64))
              for a, b in parts)
    mag = sum(np.einsum("nms,mks->nmk", np.abs(a).astype(np.float64), np.abs(b).astype(np.float64))
              for a, b in parts)
    return cc[None] - 2.0 * dot, cc[None] + 2.0 * mag


def assert_codes_near_ties(got, want, x, cb, precision):
    """Codes equal except at float64-verified near ties."""
    n, m = got.shape
    xs = np.asarray(x, np.float32).reshape(n, m, -1)
    rows, subs = np.nonzero(got != want)
    if rows.size == 0:
        return
    score, mag = _scores64(xs[rows], cb, precision)
    r = np.arange(rows.size)
    gap = np.abs(score[r, subs, got[rows, subs]] - score[r, subs, want[rows, subs]])
    assert (gap <= _TIE_RTOL * mag[r, subs, want[rows, subs]]).all(), gap.max()


_CASES = [(p, k, dt) for p in ("bf16_fast", "bf16x3") for k in (16, 100)
          for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "%s-k%d-%s" % c)
def test_encode_matches_pallas(case):
    precision, k, dtype = case
    rng = np.random.default_rng(k)
    n, m, s = 701, 4, 8  # odd n
    x = rng.normal(0, 1, (n, m * s)).astype(np.float32)
    cb = rng.normal(0, 1, (m, k, s)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)  # the same values in both packages, stored as bf16
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else x
    want = np.asarray(pk.pq_encode_fused(jx, cb, block_rows=256, interpret=True,
                                         precision=precision))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ck.pq_encode_fused(tx, torch.from_numpy(cb), precision=precision).numpy()
    assert got.shape == (n, m) and got.dtype == np.int32
    assert (got == want).mean() >= 0.99
    assert_codes_near_ties(got, want, x, cb, precision)


@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
def test_encode_plain_is_the_precision_arithmetic(precision):
    """bf16_fast of a bf16 input equals bf16_fast of the same values in
    f32; bf16x3 codes track the exact ones (near ties aside), and both
    differ from each other only where bf16 rounding moves an argmin."""
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.normal(0, 1, (500, 32)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(0, 1, (4, 64, 8)).astype(np.float32))
    got = ck.pq_encode_plain(x, cb, precision)
    if precision == "bf16_fast":
        xb = x.to(torch.bfloat16)
        assert torch.equal(ck.pq_encode_plain(xb, cb, precision),
                           ck.pq_encode_plain(xb.to(torch.float32), cb, precision))
    exact = ck.pq_encode_plain(x, cb)
    assert float((got == exact).float().mean()) >= (0.999 if precision == "bf16x3" else 0.95)


@pytest.fixture(scope="module")
def ladder():
    rng = np.random.default_rng(41)
    x = rng.random((700, 32), dtype=np.float32)  # as tests/test_pq.py draws it
    cb = np.array(jpq.pq_train(x, 4, 16, max_iters=3, seed=1))
    return x, cb


def _flips_are_near_ties(got, ref, x, cb):
    xs = x.reshape(x.shape[0], cb.shape[0], -1)
    for n_i, m_i in zip(*np.nonzero(got != ref)):
        d_ref = ((xs[n_i, m_i] - cb[m_i, ref[n_i, m_i]]) ** 2).sum()
        d_got = ((xs[n_i, m_i] - cb[m_i, got[n_i, m_i]]) ** 2).sum()
        assert abs(d_got - d_ref) / ((xs[n_i, m_i] ** 2).sum() + 1e-9) < 0.02, (n_i, m_i)


_LADDER = {"highest": 1.0, "high": 0.999, "bf16x3": 0.999, "default": 0.97, "bf16_fast": 0.97}


@pytest.mark.parametrize("precision", sorted(_LADDER))
def test_pq_encode_precision_matches_jax(ladder, precision):
    x, cb = ladder
    want = np.asarray(jpq.pq_encode(x, cb, precision=precision))
    got = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), precision=precision).numpy()
    assert (got == want).mean() >= _LADDER[precision], (got == want).mean()
    _flips_are_near_ties(got, want, x, cb)
    exact = np.asarray(jpq.pq_encode(x, cb))
    _flips_are_near_ties(got, exact, x, cb)


@pytest.mark.parametrize("metric", ["cosine", "manhattan"])
def test_non_l2_metric_ignores_precision(ladder, metric):
    x, cb = ladder
    want = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), metric)
    for precision in ("default", "high"):
        got = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(cb), metric, precision=precision)
        assert torch.equal(got, want)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jpq.pq_encode(x, cb, metric, precision="default")))


@pytest.mark.parametrize("precision", ["high", "default"])
def test_pqindex_add_precision_matches_jax(ladder, precision):
    """``PQIndex.add(precision=...)`` reaches the same encode in both
    packages (u8 codes, unpacked)."""
    x, cb = ladder
    jidx = vq_tpu.PQIndex(vq_tpu.ProductQuantizer(codebooks=cb), packed=False)
    tidx = vq_tpu_torch.PQIndex(vq_tpu_torch.ProductQuantizer(codebooks=cb), packed=False)
    jidx.add(x, precision=precision)
    tidx.add(x, precision=precision)
    got, want = tidx._codes.numpy(), np.asarray(jidx._codes)
    assert (got == want).mean() >= _LADDER[precision]
    _flips_are_near_ties(got.astype(np.int64), want.astype(np.int64), x, cb)
    assert torch.equal(tidx.pq.encode(x, precision=precision), tidx._codes)
