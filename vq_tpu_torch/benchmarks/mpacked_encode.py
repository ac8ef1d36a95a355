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
  ``+ cc``; bit-identical to the plain version. The kernel takes ``W``
  transposed, ``[m*256, d]`` f32, made once a call.
* ``"default"``: bf16 ``wgmma`` tensor cores with f32 accumulation; ``x``
  and ``W`` rounded to bf16 (to nearest even), a bf16 ``x`` and ``W``
  (the bf16-resident variant) taken as they are. The kernel takes ``W``
  as :func:`mpacked_image`, made once a call, on the plan
  :func:`mpacked_plan` reckons. The tensor core sums in its own order,
  so the kernel is held to the plain version (the rounded operands
  summed in ascending ``d``) by the near-tie rule (:func:`near_ties`):
  codes differ only where the two candidates' float64 scores lie within
  ``TIE_RTOL`` of each other.

:func:`main` keeps the script's flags ``--n``, ``--block`` (rows a
kernel block takes at a time, :func:`mpacked_encode`'s ``block_rows``)
and ``--output``, adds ``--device``,
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
import functools
import sys
from typing import Tuple

import torch

from vq_tpu_torch.benchmarks import Emitter, timed
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import (  # the near-tie rule of every tensor-core encode
    EncodeParity,
    MIN_MATCH,
    TIE_RTOL,
    _bf16,
    _launch,
    _on_card,
    int_argmin,
    pq_encode_fused,
)

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
    "mpacked_image",
    "mpacked_plan",
    "near_ties",
]

K = 256  # columns a subspace: the TPU function fixes k = 256
PRECISIONS = ("highest", "default")
_HI_ROWS = 128  # rows of a "highest" tile (csrc/mpacked_encode.cu kBM)
_BOX = 64  # depths of a "default" box: 128 bytes of bf16 a row
_W_BOX = K * _BOX * 2  # bytes of a W box (kWBox)
_X_BOX = 64 * _BOX * 2  # bytes of an x box, one 64-row m-tile (kXBox)
_SMEM = 232_448  # opt-in shared memory a block (H100, H200)
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


def _round_up(v: int, unit: int) -> int:
    return -(-max(int(v), 1) // unit) * unit


def mpacked_plan(n: int, d: int, m: int, block_rows: int = 512) -> dict:
    """B1's launch plans for ``x [n, d]`` against ``W [d, m*256]``.

    ``"highest"``: tiles of 128 rows, each reading all of ``W``
    transposed (``m*256*d`` f32) from L2: ``hi_w_bytes`` a call; a block
    owns ``hi_rows`` rows (``block_rows`` rounded up to 128).

    ``"default"``: ``d`` padded to ``d_pad``, a multiple of 64, in
    ``boxes`` boxes of 64 depths a subspace (a W box: 256 columns, 32
    KiB of bf16; the image :func:`mpacked_image` is ``image_bytes``). A
    resident plan takes units of ``rows`` = 256 rows, a ring of
    ``stages`` W boxes (a subspace's and one ahead) and its x in
    ``x_slots`` slots of one 64-row m-tile each (``boxes`` x 8 KiB):
    eight (the unit's four and the next unit's) where the shared memory
    (``smem``, 1 KiB of alignment and 16 bytes of mbarriers a stage and a
    slot included) fits 227 KiB, else four; past that (``d_pad`` > 192)
    the plan is ``streamed``: units of 128 rows, four stages of a W box
    and the unit's two x boxes. Each unit reads every W box once from L2:
    ``w_bytes`` = ``units`` x ``image_bytes`` a call. A block takes
    ``group_units`` units in a row (``block_rows`` rounded up to
    ``rows``), groups dealt out to the persistent blocks in turn. At the
    twin's shape (1M x 128, m = 8): 3,907 units x 512 KiB = 2.05 GB, and
    ``"highest"`` 7,813 tiles x 1 MiB = 8.19 GB."""
    d_pad = _round_up(d, _BOX)
    boxes = d_pad // _BOX
    slot = boxes * _X_BOX

    def smem(stages, slots, stage_bytes):
        return 1024 + stages * stage_bytes + slots * slot + 16 * (stages + slots)

    stages = boxes + 1
    slots = next((k for k in (8, 4) if smem(stages, k, _W_BOX) <= _SMEM), 0)
    if slots:
        streamed, rows, size = False, 256, smem(stages, slots, _W_BOX)
    else:
        streamed, rows, stages = True, 128, 4
        size = smem(stages, 0, _W_BOX + 2 * _X_BOX)
    units = -(-n // rows)
    image_bytes = m * boxes * _W_BOX
    hi_tiles = -(-n // _HI_ROWS)
    return dict(d_pad=d_pad, boxes=boxes, streamed=streamed, rows=rows, stages=stages,
                x_slots=slots, smem=size, group_units=_round_up(block_rows, rows) // rows,
                units=units, image_bytes=image_bytes, w_bytes=units * image_bytes,
                hi_rows=_round_up(block_rows, _HI_ROWS), hi_tiles=hi_tiles,
                hi_w_bytes=hi_tiles * m * K * d * 4)


def mpacked_image(w: torch.Tensor) -> torch.Tensor:
    """``W [d, m*256]`` as the ``"default"`` kernel's image of wgmma's
    128-byte-swizzled K-major B operand: bf16 (rounded to nearest even),
    ``[m, boxes, 256, 8, 8]``. Box ``b`` of subspace ``i`` holds
    ``W[64b + 8p + e, 256i + j]`` in column row ``j``, 16-byte chunk
    ``p ^ (j % 8)``, element ``e``; zero past ``d``."""
    d, mk = w.shape
    m = mk // K
    boxes = _round_up(d, _BOX) // _BOX
    wb = w.to(torch.bfloat16)
    if boxes * _BOX != d:
        wb = torch.nn.functional.pad(wb, (0, 0, 0, boxes * _BOX - d))
    img = wb.view(boxes, 8, 8, m, K).permute(3, 0, 4, 1, 2)  # [m, boxes, col, chunk, e]
    return torch.gather(img, 3, _swizzle(w.device).expand(img.shape))


@functools.lru_cache(maxsize=None)
def _swizzle(device: torch.device) -> torch.Tensor:
    """``[1, 1, 256, 8, 1]``: the chunk a swizzled column row ``j`` holds
    at position ``p``, ``p ^ (j % 8)``."""
    chunk = torch.arange(8, device=device)
    return (chunk[None, :] ^ (torch.arange(K, device=device) % 8)[:, None]).view(1, 1, K, 8, 1)


def mpacked_encode(x: torch.Tensor, w: torch.Tensor, cc: torch.Tensor,
                   precision: str = "highest", block_rows: int = 512) -> torch.Tensor:
    """B1: codes ``[n, m]`` i32 of ``x [n, d]`` (f32 or bf16; other types
    upcast) through ``W [d, m*256]`` (f32 or bf16) and ``cc [m*256]`` (or
    ``[1, m*256]``) f32 at ``precision``.

    ``block_rows`` is the rows a kernel block takes at a time, rounded up
    to the body's row unit (:func:`mpacked_plan`): ``"highest"`` launches
    one block a ``block_rows`` rounded up to 128 and walks its 128-row
    tiles in turn; ``"default"`` is persistent (one block an SM) and
    deals out groups of ``block_rows`` rounded up to its unit (256 rows,
    or 128 where x streams) to its blocks in turn."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    if w.dtype not in (torch.float32, torch.bfloat16):
        w = w.to(torch.float32)
    cc = cc.to(torch.float32)
    if not _on_card(x, w, cc):
        return mpacked_encode_plain(x, w, cc, precision)
    m = _check(precision, x, w, cc)
    n, d = x.shape
    codes = torch.empty((n, m), dtype=torch.int32, device=x.device)
    if n == 0:
        return codes
    if d == 0:  # one zero depth: every score is 0 + cc, as the plain version's
        x, w = x.new_zeros((n, 1)), w.new_zeros((1, w.shape[1]))
        d = 1
    x, cc = x.contiguous(), cc.reshape(-1).contiguous()
    if cc.data_ptr() % 16:
        cc = cc.clone()  # the "default" epilogue reads cc in 8-byte pairs
    bf16 = int(x.dtype == torch.bfloat16)
    plan = mpacked_plan(n, d, m, block_rows)
    if precision == "highest":
        wt = w.to(torch.float32).t().contiguous()
        _launch("vq_mpacked_highest", x.data_ptr(), bf16, wt.data_ptr(), cc.data_ptr(),
                codes.data_ptr(), n, d, m, plan["hi_rows"])
    else:
        img = mpacked_image(w)
        _launch("vq_mpacked_default", x.data_ptr(), bf16, img.data_ptr(), cc.data_ptr(),
                codes.data_ptr(), n, d, m, plan["boxes"], int(plan["streamed"]),
                plan["stages"], plan["x_slots"], plan["group_units"], plan["units"])
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


Parity = EncodeParity  # B1's codes against its plain version's, as every encode's


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
    p.add_argument("--block", type=int, default=512, help="rows a kernel block takes at a time")
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
