"""Twin of ``benchmarks/mpacked_encode.py`` on the card: the m-packed PQ
encode (B1).

The encode as one ``[tile, d] x [d, m*256]`` product plus ``||c||^2``,
then an int2 argmin over each 256-wide column block:
``codes[r, i] = argmin_j (x @ W + cc)[r, i*256 + j]``. :func:`build_w`
makes ``W`` the block-diagonal ``-2 c^T`` of a codebook, which gives K4's
codes; the function takes any ``W``.

:func:`mpacked_encode` launches ``csrc/mpacked_encode.cu``, the port of
the TPU kernel ``benchmarks/mpacked_encode.py::_mpacked_kernel`` (:46,
called through ``pl.pallas_call`` at :76), on CUDA tensors and runs
:func:`mpacked_encode_plain` on CPU tensors; it counts its launches in
``launches`` and, by precision, in ``launches_by``.

Precisions, as the TPU function takes them:

* ``"highest"``: exact fp32 on the CUDA cores, each score summed from
  +0.0 in ascending ``d`` one rounded multiply and add at a time, then
  ``+ cc``; bit-identical to the plain version.
* ``"default"``: bf16 tensor cores with f32 accumulation; ``x`` and ``W``
  rounded to bf16 (to nearest even), a bf16 ``x`` and ``W`` (the
  bf16-resident variant) taken as they are. The tensor core sums in its
  own order, so the kernel is held to the plain version (the rounded
  operands summed in ascending ``d``) by the near-tie rule
  (:func:`near_ties`): codes differ only where the two candidates'
  float64 scores lie within ``TIE_RTOL`` of each other.

:func:`main` keeps the script's flags ``--n``, ``--block`` (rows a
kernel block owns, a multiple of 64) and ``--output``, adds ``--device``,
and prints the script's JSON lines: ``mpacked_parity_highest`` /
``mpacked_parity_default`` (code match on 100,000 rows against the port's
exact encode ``pq_encode_fused``, and ``parity``: the kernel against its
plain version under its rule), then ``encode_shipped_fused``,
``encode_mpacked_highest``, ``encode_mpacked_default`` and
``encode_mpacked_bf16resident`` in ms from CUDA events (``null`` on the
CPU). Not ported: ``--t`` (the TPU's scan-chained timing; the card times
with CUDA events), ``--decompose`` (it measures the JAX package's XLA
path ``_pq_encode_mpacked_jit``, which is no Pallas kernel) and
``--interpret`` (``--device cpu`` runs the plain versions).

    python3 -m vq_tpu_torch.benchmarks.mpacked_encode [--n 1000000] [--block 512]
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple, Tuple

import torch

from vq_tpu_torch.benchmarks import Emitter, timed
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import _bf16, _launch, _on_card, int_argmin, pq_encode_fused

__all__ = [
    "K",
    "MIN_MATCH",
    "PRECISIONS",
    "Parity",
    "TIE_RTOL",
    "build_w",
    "kernel_parity",
    "main",
    "mpacked_encode",
    "mpacked_encode_plain",
    "near_ties",
]

K = 256  # columns a subspace: the TPU function fixes k = 256
PRECISIONS = ("highest", "default")
TIE_RTOL = 1e-5  # near tie: a float64 score gap within this of max(|score|, 1)
MIN_MATCH = 0.9999  # "default": least share of codes equal to the plain version's
_ROW_TILE = 64  # rows of a kernel tile (csrc/mpacked_encode.cu kTile)
_PLAIN_CELLS = 1 << 25  # [rows, m*k] scores a block of the plain version


def build_w(cb) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(W [m*s, m*k], cc [1, m*k])`` f32 of codebooks ``cb [m, k, s]``:
    the block-diagonal ``-2 c^T`` and the ``||c||^2`` row (the script's
    ``build_w``, on ``cb``'s device)."""
    cb = torch.as_tensor(cb).to(torch.float32)
    m, k, s = cb.shape
    w = torch.zeros((m * s, m * k), dtype=torch.float32, device=cb.device)
    for i in range(m):
        w[i * s:(i + 1) * s, i * k:(i + 1) * k] = -2.0 * cb[i].T
    return w, (cb * cb).sum(-1).reshape(1, m * k)


def _check(precision: str, x: torch.Tensor, w: torch.Tensor, cc: torch.Tensor) -> int:
    if precision not in PRECISIONS:
        raise InvalidParameter("precision", f"must be one of {list(PRECISIONS)}, got {precision!r}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise InvalidParameter(
            "w", f"expected x [n, d] and W [d, m*{K}], got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if w.shape[1] == 0 or w.shape[1] % K:
        raise InvalidParameter("w", f"columns must be a positive multiple of {K}, got {w.shape[1]}")
    if cc.numel() != w.shape[1]:
        raise InvalidParameter("cc", f"expected {w.shape[1]} values, got {cc.numel()}")
    return w.shape[1] // K


def _operands(x, w, precision):
    """``x`` and ``W`` as f32, rounded to bf16 for ``"default"``."""
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    return (_bf16(xf), _bf16(wf)) if precision == "default" else (xf, wf)


def mpacked_encode_plain(x: torch.Tensor, w: torch.Tensor, cc: torch.Tensor,
                         precision: str = "highest") -> torch.Tensor:
    """Plain version of B1 -> codes ``[n, m]`` i32: each score summed from
    +0.0 in ascending ``d`` one rounded multiply and add at a time (the
    operands rounded to bf16 for ``"default"``), then ``+ cc``, then the
    int2 argmin of each 256-wide column block."""
    m = _check(precision, x, w, cc)
    xf, wf = _operands(x, w, precision)
    c = cc.reshape(-1).to(torch.float32)
    n, d = x.shape
    out = torch.empty((n, m), dtype=torch.int32, device=x.device)
    rows = max(1, _PLAIN_CELLS // (m * K))
    for b0 in range(0, n, rows):
        xb = xf[b0:b0 + rows]
        scores = torch.zeros((xb.shape[0], m * K), dtype=torch.float32, device=x.device)
        for e in range(d):
            scores = scores + xb[:, e, None] * wf[e][None, :]
        out[b0:b0 + rows] = int_argmin((scores + c).view(-1, m, K))[1]
    return out


def mpacked_encode(x: torch.Tensor, w: torch.Tensor, cc: torch.Tensor,
                   precision: str = "highest", block_rows: int = 512) -> torch.Tensor:
    """B1: codes ``[n, m]`` i32 of ``x [n, d]`` (f32 or bf16; other types
    upcast) through ``W [d, m*256]`` (f32 or bf16) and ``cc [m*256]`` (or
    ``[1, m*256]``) f32 at ``precision``. ``block_rows`` rows (rounded up
    to a multiple of 64) go to a kernel block."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    if w.dtype not in (torch.float32, torch.bfloat16):
        w = w.to(torch.float32)
    cc = cc.to(torch.float32)
    if not _on_card(x, w, cc):
        return mpacked_encode_plain(x, w, cc, precision)
    m = _check(precision, x, w, cc)
    tensor_cores = precision == "default"
    if tensor_cores:
        w = w.to(torch.bfloat16)
    x, w, cc = x.contiguous(), w.contiguous(), cc.reshape(-1).contiguous()
    n, d = x.shape
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    if n == 0:
        return codes
    rows = -(-max(int(block_rows), 1) // _ROW_TILE) * _ROW_TILE
    bf16 = torch.bfloat16
    _launch(
        "vq_mpacked_encode", x.data_ptr(), int(x.dtype == bf16), w.data_ptr(),
        int(w.dtype == bf16), cc.data_ptr(), codes.data_ptr(), n, d, m, int(tensor_cores), rows,
    )
    mpacked_encode.launches += 1
    mpacked_encode.launches_by[precision] += 1
    return codes


mpacked_encode.launches = 0
mpacked_encode.launches_by = dict.fromkeys(PRECISIONS, 0)


def near_ties(x, w, cc, got, want, precision: str = "default"):
    """``(flips, max_gap, all_ties)`` of two code arrays ``[n, m]`` of
    ``argmin_j (x @ W + cc)`` over ``m`` equal column blocks (256 wide for
    B1; any width, so K1's and K4's codes are checked by it too): the
    (row, block) pairs where they differ, the largest float64 score gap
    between their two candidates (on the operands the precision rounds),
    and whether every gap is a near tie (at most ``TIE_RTOL`` of
    ``max(|score|, 1)``)."""
    rows, subs = torch.nonzero(got != want, as_tuple=True)
    if rows.numel() == 0:
        return 0, 0.0, True
    width = w.shape[1] // got.shape[1]
    xf, wf = _operands(x[rows], w, precision)
    xd, wd, cd = xf.double(), wf.double(), cc.reshape(-1).double()

    def score(codes):
        col = subs.to(torch.int64) * width + codes[rows, subs].to(torch.int64)
        return (xd * wd[:, col].T).sum(-1) + cd[col]

    sg, sw = score(got), score(want)
    gap = (sg - sw).abs()
    ties = gap <= TIE_RTOL * sw.abs().clamp_min(1.0)
    return rows.numel(), float(gap.max()), bool(ties.all())


class Parity(NamedTuple):
    """B1's codes against its plain version's: ``ok`` under the
    precision's rule, the share equal, the count that differ and their
    largest float64 score gap."""

    ok: bool
    match: float
    flips: int
    max_gap: float


def kernel_parity(x, w, cc, got, precision: str) -> Parity:
    """The kernel's codes ``got`` against the plain version's under its
    rule: equal for ``"highest"``; for ``"default"`` at least
    ``MIN_MATCH`` equal and every difference a float64 near tie."""
    want = mpacked_encode_plain(x, w, cc, precision)
    match = float((got == want).float().mean()) if got.numel() else 1.0
    flips, gap, ties = near_ties(x, w, cc, got, want, precision)
    ok = flips == 0 if precision == "highest" else match >= MIN_MATCH and ties
    return Parity(ok, match, flips, gap)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--block", type=int, default=512, help="rows a kernel block owns")
    p.add_argument("--output", type=str, default="-")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    emit = Emitter(args.output, dev)
    n, dim, m = args.n, 128, 8
    g = torch.Generator(device=dev).manual_seed(66)
    x = torch.rand((n, dim), generator=g, device=dev)
    cb = torch.rand((m, K, dim // m), generator=g, device=dev)
    w, cc = build_w(cb)

    # Parity first: codes against the port's exact encode (K4), and each
    # kernel against its plain version.
    n_par = min(100_000, n)
    ref = pq_encode_fused(x[:n_par], cb, "highest")
    match = {}
    for precision in PRECISIONS:
        got = mpacked_encode(x[:n_par], w, cc, precision, args.block)
        match[precision] = float((ref == got).float().mean())
        emit(op=f"mpacked_parity_{precision}", code_match=match[precision], n=n_par,
             parity=kernel_parity(x[:n_par], w, cc, got, precision).ok)
    # bf16-resident operands: the corpus stored bf16, W cast once outside.
    xh, wh = x.to(torch.bfloat16), w.to(torch.bfloat16)
    got_h = mpacked_encode(xh[:n_par], wh, cc, "default", args.block)
    parity_h = kernel_parity(xh[:n_par], wh, cc, got_h, "default").ok

    emit(op="encode_shipped_fused", ms=timed(dev, lambda: pq_encode_fused(x, cb), 5))
    emit(op="encode_mpacked_highest",
         ms=timed(dev, lambda: mpacked_encode(x, w, cc, "highest", args.block), 3),
         block=args.block, code_match_vs_shipped=match["highest"])
    emit(op="encode_mpacked_default",
         ms=timed(dev, lambda: mpacked_encode(x, w, cc, "default", args.block), 5),
         block=args.block)
    emit(op="encode_mpacked_bf16resident",
         ms=timed(dev, lambda: mpacked_encode(xh, wh, cc, "default", args.block), 5),
         block=args.block, code_match_vs_shipped=float((ref == got_h).float().mean()),
         parity=parity_h)
    emit.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
