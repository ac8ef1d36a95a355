"""The lower-precision PQ encodes of the port on the CPU: the NaN rule of
the plain versions, the float64 near-tie rule that holds the
tensor-core kernels K4-bf16 and K4-bf16x3 on the card, and the fragment
layout those kernels read their codebook in.

* NaN never wins (the int2 rule): a NaN score keys above +inf whatever
  its sign. torch's CPU cast of f32 to bf16 turns a NaN into the negative
  NaN 0xFFFF, and ``inf - inf`` on x86 is the negative default NaN; both
  keyed below -inf before, so a NaN or ``inf - inf`` centroid won every
  row (``ROADMAP.md``, R7). The JAX package's Pallas path still lets such
  a NaN win (its bf16 bodies take ``jnp.argmin``, and its
  ``_orderable_key`` keys a negative NaN below -inf): the one parity test
  here that reaches one names that split.
* :func:`encode_parity` / :func:`encode_near_ties`: codes equal but at
  float64 near ties (gap within ``TIE_RTOL`` of ``max(|score|, 1)``) and
  at least ``MIN_MATCH`` of them equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu.ops import pallas_kernels as pk
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_NEG_NAN = torch.tensor([-0x400000], dtype=torch.int32).view(torch.float32)  # 0xFFC00000
_BAD = {"nan": float("nan"), "negative-nan": float(_NEG_NAN), "inf": float("inf")}


def _bad_centroid_case(kind, m=3, k=10, s=16, n=64, seed=0):
    """x in (0.1, 1.1) against ``randn`` codebooks with one entry of
    centroid 3 of every subspace NaN (either sign) or +inf."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.random((n, m * s)) + 0.1).astype(np.float32))
    cb = torch.from_numpy(rng.normal(0, 1, (m, k, s)).astype(np.float32))
    cb[:, 3, 5] = _BAD[kind]
    if kind == "negative-nan":
        cb[:, 3, 5] = _NEG_NAN
    return x, cb


def _argmin_without(x, cb, drop, precision):
    """Codes of the plain encode with centroid ``drop`` pushed far away."""
    far = cb.clone()
    far[:, drop] = 1e6
    return ck.pq_encode_plain(x, far, precision)


def test_orderable_key_sends_every_nan_above_inf():
    scores = torch.cat([_NEG_NAN, torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])])
    key = ck.orderable_key(scores)
    assert int(key[0]) > int(key[2]) and int(key[1]) > int(key[2]) > int(key[3])
    assert int(key[4]) == 0
    back = ck.key_to_f32(key)
    assert bool(torch.isnan(back[:2]).all())
    assert not bool(torch.signbit(back[:2]).any())


@pytest.mark.parametrize("row, want", [
    ([float(_NEG_NAN), 5.0, -1.0], 2),
    ([3.0, float(_NEG_NAN), 1.0], 2),
    ([float(_NEG_NAN), float("inf"), 7.0], 2),
    ([float(_NEG_NAN), float("inf")], 1),
    ([float(_NEG_NAN), float("nan")], 0),  # every score NaN: the two key alike, lowest index
    ([-float("inf"), float(_NEG_NAN)], 0),
])
def test_int_argmin_negative_nan_never_wins(row, want):
    smin, idx = ck.int_argmin(torch.tensor([row], dtype=torch.float32))
    assert int(idx[0]) == want
    expect = torch.tensor([row[want]], dtype=torch.float32).view(torch.int32)
    if np.isnan(row[want]):
        expect = expect & 0x7FFFFFFF  # a NaN minimum comes back positive
    assert torch.equal(smin.view(torch.int32), expect)


@pytest.mark.parametrize("kind", sorted(_BAD))
@pytest.mark.parametrize("precision", ck.ENCODE_PRECISIONS)
def test_plain_encode_never_picks_a_nan_or_inf_minus_inf_centroid(precision, kind):
    x, cb = _bad_centroid_case(kind)
    got = ck.pq_encode_plain(x, cb, precision)
    assert not bool((got == 3).any())
    assert torch.equal(got, _argmin_without(x, cb, 3, precision))
    assert torch.equal(ck.pq_encode_fused(x, cb, precision), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ck.ENCODE_PRECISIONS)
def test_plain_encode_nan_rows_take_code_0(precision, dtype):
    """A NaN in a row's subspace (either sign, f32 or cast to bf16) makes
    every score of it the same NaN: code 0; the other rows as without."""
    x, cb = _bad_centroid_case("nan", seed=1)
    cb[:, 3, 5] = 0.5
    x[7] = float("nan")
    x[9, 3] = _NEG_NAN
    got = ck.pq_encode_plain(x.to(dtype), cb, precision)
    assert bool((got[7] == 0).all()) and int(got[9, 0]) == 0
    keep = torch.ones(x.shape[0], dtype=torch.bool)
    keep[7] = False
    want = ck.pq_encode_plain(x[keep].to(dtype), cb, precision)
    assert torch.equal(got[keep][:, 1:], want[:, 1:])


def test_r7_reference_lets_negative_nan_win():
    """The split R7: on the same inputs the Pallas path (interpret mode)
    picks the +inf centroid at "highest" (its score ``inf - inf`` is the
    CPU's negative NaN) and the NaN centroid at "bf16_fast" (its bf16 body
    takes ``jnp.argmin``); the port picks neither."""
    for kind, precision in (("inf", "highest"), ("nan", "bf16_fast")):
        x, cb = _bad_centroid_case(kind, m=1, n=16)
        want = np.asarray(pk.pq_encode_fused(x.numpy(), cb.numpy(), block_rows=16, interpret=True,
                                             precision=precision))
        got = ck.pq_encode_plain(x, cb, precision).numpy()
        assert (want == 3).all(), want
        assert not (got == 3).any()


# --- the near-tie rule ------------------------------------------------------


@pytest.fixture(scope="module")
def rule_data():
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.normal(0, 1, (2000, 64)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(0, 1, (8, 32, 8)).astype(np.float32))
    return x, cb


@pytest.mark.parametrize("precision", ck.ENCODE_PRECISIONS)
def test_rule_accepts_the_plain_version_against_itself(rule_data, precision):
    x, cb = rule_data
    par = ck.encode_parity(x, cb, ck.pq_encode_plain(x, cb, precision), precision)
    assert par == ck.EncodeParity(True, 1.0, 0, 0.0)


def _near_tie(precision, nudge):
    """Codebooks whose centroid 1 is centroid 0 with one entry moved by
    ``nudge`` ulps, and x rows at centroid 0: a flip 0 <-> 1 is a tie of
    a few ulps (nudge 0: an exact tie)."""
    rng = np.random.default_rng(3)
    cb = torch.from_numpy(rng.normal(0, 1, (2, 16, 8)).astype(np.float32))
    cb[:, 1] = cb[:, 0]
    bits = cb[:, 1, 0].view(torch.int32) + nudge
    cb[:, 1, 0] = bits.view(torch.float32)
    x = cb[:, 0].reshape(1, -1).repeat(6000, 1) + 1e-3 * torch.from_numpy(
        rng.normal(0, 1, (6000, 16)).astype(np.float32))
    want = ck.pq_encode_plain(x, cb, precision)
    return x, cb, want


@pytest.mark.parametrize("nudge", [0, 1])
@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
def test_rule_accepts_a_flip_at_a_near_tie(precision, nudge):
    x, cb, want = _near_tie(precision, nudge)
    got = want.clone()
    assert int(got[5, 1]) in (0, 1)
    got[5, 1] = 1 - got[5, 1]
    par = ck.encode_parity(x, cb, got, precision, want=want)
    assert par.ok and par.flips == 1 and par.max_gap <= ck.TIE_RTOL * 40
    flips, gap, ties = ck.encode_near_ties(x, cb, got, want, precision)
    assert (flips, ties) == (1, True) and gap == par.max_gap


@pytest.mark.parametrize("precision", ck.ENCODE_PRECISIONS)
def test_rule_rejects_a_flip_far_from_a_tie(rule_data, precision):
    x, cb = rule_data
    want = ck.pq_encode_plain(x, cb, precision)
    got = want.clone()
    got[11, 2] = (got[11, 2] + 7) % cb.shape[1]
    par = ck.encode_parity(x, cb, got, precision)
    assert not par.ok and par.flips == 1 and par.max_gap > 1e-2
    assert par.match == pytest.approx(1 - 1 / got.numel())


@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
def test_rule_rejects_too_many_flips_even_at_ties(precision):
    """Exact ties everywhere (nudge 0), but 0.1% of the codes flipped:
    below MIN_MATCH."""
    x, cb, want = _near_tie(precision, 0)
    got = want.clone()
    got[:12, 0] = 1 - got[:12, 0]
    par = ck.encode_parity(x, cb, got, precision, want=want)
    assert not par.ok and par.flips == 12 and par.max_gap == 0.0


# --- the fragment layout of K4-bf16 / K4-bf16x3 ------------------------------


@pytest.mark.parametrize("precision", ["bf16_fast", "bf16x3"])
@pytest.mark.parametrize("shape", [(8, 256, 16), (4, 300, 24), (2, 1000, 12), (3, 257, 5),
                                   (1, 40, 64), (1, 9, 70)])
def test_mma_fragments_hold_each_lanes_b_operand(shape, precision):
    """Lane 4 g + t of n8 tile j and k-step q holds centroid 8 j + g at
    e = 16 q + 8 h + 2 t + u in slot 2 h + u (the m16n8k16 B fragment),
    zeros past k and s; bf16x3 puts the low half in slots 4-7."""
    m, k, s = shape
    rng = np.random.default_rng(sum(shape))
    cb = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    frag = ck.mma_fragments(cb, precision)
    kt, ks = -(-k // 8), -(-s // 16)
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    halves = ck._split_codebooks(cb) if precision == "bf16x3" else (ck._bf16(cb),)
    assert tuple(frag.shape) == (m, kt, ks, 32, 4 * len(halves))
    j, q, lane, h, u = np.meshgrid(np.arange(kt), np.arange(ks), np.arange(32), np.arange(2),
                                   np.arange(2), indexing="ij")
    cent, e = 8 * j + lane // 4, 16 * q + 8 * h + 2 * (lane % 4) + u
    for p, half in enumerate(halves):
        pad = torch.zeros((m, 8 * kt, 16 * ks))
        pad[:, :k, :s] = half
        want = pad[:, torch.from_numpy(cent), torch.from_numpy(e)]  # [m, kt, ks, 32, 2, 2]
        got = frag[..., 4 * p:4 * p + 4].to(torch.float32).reshape(want.shape)
        assert torch.equal(got, want)


def test_near_tie_scores_use_the_precisions_operands():
    """The float64 scores of the rule round the operands as the precision
    does, and ||c||^2 comes from the f32 centroid: centroid 1 is centroid
    0 with 2^-12 added to one entry, a tie at "highest" (gap 2^-24) but
    not in bf16, where its dot loses the 2^-12 and its norm keeps it (gap
    about 2^-11)."""
    x = torch.tensor([[1.0, 1.0]])
    cb = torch.tensor([[[1.0, 1.0], [1.0, 1.0 + 2.0 ** -12]]])  # [1, 2, 2]
    got, want = torch.tensor([[1]]), torch.tensor([[0]])
    flips, gap, ties = ck.encode_near_ties(x, cb, got, want, "highest")
    assert (flips, ties) == (1, True) and gap == pytest.approx(2.0 ** -24)
    for precision in ("bf16_fast", "bf16x3"):
        flips, gap, ties = ck.encode_near_ties(x, cb, got, want, precision)
        assert (flips, ties) == (1, precision == "bf16x3")
