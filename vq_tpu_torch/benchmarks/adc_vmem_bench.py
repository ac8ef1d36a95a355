"""Twin of ``benchmarks/adc_vmem_bench.py`` on the card: three designs of
K8's function, the dense ADC table sum ``out[q, j] = sum_i tables[q, i,
codes_t[i, j]]`` (``tables [Q, m, k]`` f32, ``codes_t [m, n]`` u8, ``out
[Q, n]`` f32, added from +0.0 in ascending subspace order), and the bytes
floor of its output. Each wrapper launches its kernel in
``csrc/adc_variants.cu`` on CUDA tensors, runs its plain version on CPU
tensors, and counts its launches in ``launches``:

* B2 :func:`adc_kt` replaces ``benchmarks/adc_vmem_bench.py::_adc_kt_kernel``
  (:55, called at :79): a one-hot matmul on the tensor cores, the tables
  split into three bf16 parts whose products are exact. Contract: finite
  tables (the split is exact for finite normal f32); a code >= k adds 0,
  as on the TPU. Bit-identical to its plain version, and on finite tables
  to B3 and K8.
* B3 :func:`adc_gather` replaces ``::_adc_gather_kernel`` (:99, called at
  :136): per-subspace gathers with the sums in registers; ``only > 0``
  sums just the first ``only`` subspaces. A code >= k adds 0.0, K8's
  rule; the JAX function in interpret mode gives NaN there (numpy's fill
  mode) and TPU hardware is undefined there, so B3 is held to it on
  in-range codes only.
* B4 :func:`adc_floor` replaces ``::_adc_floor_kernel`` (:156, called at
  :173): the same I/O with no lookup, ``out[q, j] = f32(codes_t[0, j]) +
  tables[0, 0, 0]`` for every q.

:func:`main` keeps the script's flags ``--n``, ``--q``, ``--m``, ``--k``,
``--block`` (rows a B3 block owns) and ``--only`` (a comma list of
variants; ``xla`` always runs), adds ``--device``, and prints one JSON
line a variant, ``{"variant", "ms", "parity", "mvecs_per_s"}``: ``xla``
(:func:`adc_lookup_plain`, the counterpart of ``_adc_lookup_jit``),
``old`` (K8, ``adc_lookup_fused`` on ``[n, m]`` codes), ``kt``,
``gather``, ``floor`` and ``gather1`` (B3 with ``only=1``). ``parity`` is
bit-identity with ``xla``'s output, except for ``floor`` and ``gather1``,
which compute other functions and are held to their own plain versions
(``against`` names what each was compared with). ``ms`` comes from CUDA
events (``null`` on the CPU). Not ported: ``--interpret``.

    python3 -m vq_tpu_torch.benchmarks.adc_vmem_bench [--n 1000000] [--q 128]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

import torch

from vq_tpu_torch.benchmarks import Emitter, timed
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import (
    _TARGET_BLOCKS,
    _launch,
    _on_card,
    adc_lookup_fused,
    adc_lookup_plain,
)

__all__ = [
    "adc_floor",
    "adc_floor_plain",
    "adc_gather",
    "adc_gather_plain",
    "adc_kt",
    "adc_kt_plain",
    "main",
    "split3",
]

_KT_ROWS = 64  # corpus rows a B2 block (csrc/adc_variants.cu kKtRows)
_GATHER_MAX = 8  # queries a B3 group, at most (kGatherMax)
_GATHER_SMEM = 64 * 1024  # shared memory a B3 group's tables may take
_GATHER_ROWS = 1024  # rows a B3 block step (256 threads x 4 rows)
_FLOOR_QUERIES = 16  # queries a B4 block writes


def _check(tables: torch.Tensor, codes_t: torch.Tensor) -> None:
    if tables.ndim != 3:
        raise InvalidParameter("tables", f"expected [Q, m, k], got {tuple(tables.shape)}")
    if codes_t.ndim != 2 or codes_t.shape[0] != tables.shape[1]:
        raise InvalidParameter(
            "codes_t", f"expected [{tables.shape[1]}, n], got {tuple(codes_t.shape)}"
        )
    if codes_t.dtype != torch.uint8:
        raise InvalidParameter("codes_t", f"must be uint8, got {codes_t.dtype}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def split3(tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hi, mid, lo)`` bf16: ``hi = bf(t)``, ``mid = bf(t - hi)``, ``lo =
    bf(t - hi - mid)``; ``(hi + mid) + lo`` is ``t`` again for finite
    normal f32."""
    t = tables.to(torch.float32)
    hi = t.to(torch.bfloat16)
    r = t - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(torch.float32)).to(torch.bfloat16)


def adc_kt_plain(tables: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """Plain version of B2, bit-identical to it: each entry rebuilt as
    ``(hi + mid) + lo`` from its three bf16 parts, then summed by K8's
    plain version."""
    _check(tables, codes_t)
    hi, mid, lo = (p.to(torch.float32) for p in split3(tables))
    return adc_lookup_plain((hi + mid) + lo, codes_t.T)


def adc_kt(tables: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """B2: ``[Q, n]`` ADC sums of ``tables [Q, m, k]`` over ``codes_t [m,
    n]`` u8 through one-hot products on the tensor cores (finite
    tables)."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, codes_t):
        return adc_kt_plain(tables, codes_t)
    _check(tables, codes_t)
    q, m, k = tables.shape
    n = codes_t.shape[1]
    out = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0 or m == 0 or k == 0:
        return out.zero_()
    kk = min(k, 256)  # a u8 code never picks an entry past 255
    kp, qp = _round_up(kk, 16), _round_up(q, 16)
    parts = []
    for part in split3(tables[:, :, :kk]):
        padded = torch.zeros((qp, m, kp), dtype=torch.bfloat16, device=tables.device)
        padded[:q, :, :kk] = part
        parts.append(padded)
    codes_t = codes_t.contiguous()
    _launch("vq_adc_kt", *(p.data_ptr() for p in parts), codes_t.data_ptr(), out.data_ptr(),
            q, qp, m, kk, kp, n)
    adc_kt.launches += 1
    return out


adc_kt.launches = 0


def _check_only(only: int, m: int) -> int:
    if not 0 <= int(only) <= m:
        raise InvalidParameter("only", f"must be in [0, {m}], got {only}")
    return int(only) or m


def adc_gather_plain(tables: torch.Tensor, codes_t: torch.Tensor, only: int = 0) -> torch.Tensor:
    """Plain version of B3, bit-identical to it: K8's plain version over
    the first ``only`` subspaces (all when 0)."""
    _check(tables, codes_t)
    subspaces = _check_only(only, tables.shape[1])
    return adc_lookup_plain(tables[:, :subspaces], codes_t[:subspaces].T)


def adc_gather(tables: torch.Tensor, codes_t: torch.Tensor, only: int = 0,
               block_rows: Optional[int] = None) -> torch.Tensor:
    """B3: ``[Q, n]`` ADC sums of ``tables [Q, m, k]`` over ``codes_t [m,
    n]`` u8 by gathers, over the first ``only`` subspaces when ``only >
    0``. ``block_rows`` (a multiple of 4; default: enough blocks to fill
    the card) rows go to a block."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, codes_t):
        return adc_gather_plain(tables, codes_t, only)
    _check(tables, codes_t)
    q, m, k = tables.shape
    n = codes_t.shape[1]
    subspaces = _check_only(only, m)
    out = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0 or m == 0 or k == 0:
        return out.zero_()
    tables, codes_t = tables.contiguous(), codes_t.contiguous()
    per_query = m * k * 4
    in_smem = per_query <= _GATHER_SMEM
    group = min(q, _GATHER_MAX, max(1, _GATHER_SMEM // per_query))
    groups = -(-q // group)
    if block_rows is None:
        row_blocks = max(1, min(-(-n // _GATHER_ROWS), -(-4 * _TARGET_BLOCKS // groups)))
        rows = _round_up(-(-n // row_blocks), _GATHER_ROWS)
    else:
        rows = _round_up(max(int(block_rows), 1), 4)
    vec = n % 4 == 0 and codes_t.data_ptr() % 4 == 0
    _launch("vq_adc_gather", tables.data_ptr(), codes_t.data_ptr(), out.data_ptr(), q, m, k, n,
            group, int(in_smem), subspaces, rows, int(vec))
    adc_gather.launches += 1
    return out


adc_gather.launches = 0


def _check_floor(tables, codes_t):
    _check(tables, codes_t)
    if tables.shape[1] == 0 or tables.shape[2] == 0:
        raise InvalidParameter("tables", "B4 reads tables[0, 0, 0]: m and k must be positive")


def adc_floor_plain(tables: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """Plain version of B4, bit-identical to it."""
    _check_floor(tables, codes_t)
    row = codes_t[0].to(torch.float32) + tables[0, 0, 0].to(torch.float32)
    return row[None, :].repeat(tables.shape[0], 1)


def adc_floor(tables: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """B4: ``out [Q, n]`` with ``out[q, j] = f32(codes_t[0, j]) +
    tables[0, 0, 0]``, K8's I/O without its lookups."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, codes_t):
        return adc_floor_plain(tables, codes_t)
    _check_floor(tables, codes_t)
    q, n = tables.shape[0], codes_t.shape[1]
    out = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0:
        return out
    tables, codes_t = tables.contiguous(), codes_t.contiguous()
    vec = n % 4 == 0 and codes_t.data_ptr() % 4 == 0
    _launch("vq_adc_floor", tables.data_ptr(), codes_t.data_ptr(), out.data_ptr(), q, n,
            _FLOOR_QUERIES, int(vec))
    adc_floor.launches += 1
    return out


adc_floor.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--q", type=int, default=128)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--block", type=int, default=2048, help="rows a B3 block owns")
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    emit = Emitter("-", dev)
    g = torch.Generator(device=dev).manual_seed(66)
    tables = torch.rand((args.q, args.m, args.k), generator=g, device=dev)
    codes = torch.randint(0, args.k, (args.n, args.m), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    codes_i32 = codes.to(torch.int32)
    codes_t = codes.T.contiguous()  # [m, n] u8, contiguous a subspace

    variants = {
        "xla": lambda: adc_lookup_plain(tables, codes_i32),
        "old": lambda: adc_lookup_fused(tables, codes),
        "kt": lambda: adc_kt(tables, codes_t),
        "gather": lambda: adc_gather(tables, codes_t, block_rows=args.block),
        "floor": lambda: adc_floor(tables, codes_t),
        "gather1": lambda: adc_gather(tables, codes_t, only=1, block_rows=args.block),
    }
    own_plain = {
        "floor": ("adc_floor_plain", lambda: adc_floor_plain(tables, codes_t)),
        "gather1": ("adc_gather_plain(only=1)", lambda: adc_gather_plain(tables, codes_t, only=1)),
    }
    if args.only:
        keep = set(args.only.split(","))
        variants = {k: v for k, v in variants.items() if k in keep or k == "xla"}

    ref = variants["xla"]()
    for name, fn in variants.items():
        against, want = own_plain.get(name, ("xla", None))
        ok = torch.equal(fn(), ref if want is None else want())
        ms = timed(dev, fn, 10)
        emit(variant=name, ms=ms, parity=ok, against=against,
             mvecs_per_s=None if ms is None else args.n / ms / 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
