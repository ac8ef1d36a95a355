"""Twin of ``benchmarks/adc_vmem_bench.py`` on the card: three designs of
K8's function, the dense ADC table sum ``out[q, j] = sum_i tables[q, i,
codes_t[i, j]]`` (``tables [Q, m, k]`` f32, ``codes_t [m, n]`` u8, ``out
[Q, n]`` f32, added from +0.0 in ascending subspace order), and the bytes
floor of its output. Each wrapper launches its kernel in
``csrc/adc_variants.cu`` on CUDA tensors, runs its plain version on CPU
tensors, and counts its launches in ``launches``:

* B2 :func:`adc_kt` replaces ``benchmarks/adc_vmem_bench.py::_adc_kt_kernel``
  (:55, called at :79): a one-hot matmul on Hopper's warpgroup tensor
  cores (``wgmma``), the tables split into three bf16 parts whose
  products are exact. The one-hot is built in registers from the codes
  (the A operand); the parts are the B operand, laid out by
  :func:`kt_slabs` as the kernel's shared-memory image (one slab a group
  of 32 queries and a subspace) and copied in once a 576-row unit
  (:func:`kt_plan`). Contract: finite tables (the split is exact for
  finite normal f32); a code >= k adds 0, as on the TPU. Bit-identical
  to its plain version, and on finite tables to B3 and K8.
* B3 :func:`adc_gather` replaces ``::_adc_gather_kernel`` (:99, called at
  :136): per-subspace gathers with the sums in registers; ``only > 0``
  sums just the first ``only`` subspaces. The tables of 16 queries sit in
  shared memory as 128-byte lines of two subspaces' entries, and the two
  4-lane groups of a quarter-warp run one subspace apart, so every phase
  of a 16-byte load costs one shared-memory wavefront on any codes
  (:func:`gather_wavefronts` counts them); :func:`gather_plan` is its
  launch plan. A code >= k adds 0.0, K8's rule; the JAX function in
  interpret mode gives NaN there (numpy's fill mode) and TPU hardware is
  undefined there, so B3 is held to it on in-range codes only.
* B4 :func:`adc_floor` replaces ``::_adc_floor_kernel`` (:156, called at
  :173): the same I/O with no lookup, ``out[q, j] = f32(codes_t[0, j]) +
  tables[0, 0, 0]`` for every q.

:func:`main` keeps the script's flags ``--n``, ``--q``, ``--m``, ``--k``
and ``--only`` (a comma list of variants; ``xla`` always runs), adds
``--device``, and prints one JSON
line a variant, ``{"variant", "ms", "parity", "mvecs_per_s"}``: ``xla``
(:func:`adc_lookup_plain`, the counterpart of ``_adc_lookup_jit``),
``old`` (K8, ``adc_lookup_fused`` on ``[n, m]`` codes), ``kt``,
``gather``, ``floor`` and ``gather1`` (B3 with ``only=1``). ``parity`` is
bit-identity with ``xla``'s output, except for ``floor`` and ``gather1``,
which compute other functions and are held to their own plain versions
(``against`` names what each was compared with). ``ms`` comes from CUDA
events (``null`` on the CPU). Not ported: ``--interpret``, and ``--block``
(rows a B3 block owns): B3's plan is :func:`gather_plan`'s, no caller's.

    python3 -m vq_tpu_torch.benchmarks.adc_vmem_bench [--n 1000000] [--q 128]
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple

import torch

from vq_tpu_torch.benchmarks import Emitter, timed
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.ops.cuda_kernels import (
    SMEM_OPTIN,
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
    "gather_plan",
    "gather_wavefronts",
    "kt_plan",
    "kt_slabs",
    "main",
    "split3",
]

_KT_QUERIES = 32  # queries a B2 group (csrc/adc_variants.cu kKtQueries)
_KT_ROWS = 576  # corpus rows a B2 unit (kKtRows): 3 warpgroups x 3 m-tiles of 64
_KT_BOX = 64  # table entries a 128-byte swizzled slab row
_GATHER_QUERIES = 16  # queries a B3 block, at most (kGQueries): 4 quads
_GATHER_LINE = 128  # bytes a B3 table line, 2 subspaces x 4 quads (kGLine)
_GATHER_WARPS = 16  # warps a B3 block (kGThreads / 32), 32 rows each a step
_MODEL_STEPS = 2048  # block steps :func:`gather_wavefronts` models at once
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


def kt_plan(q: int, m: int, k: int, n: int) -> dict:
    """B2's launch plan for ``tables [q, m, k]`` over ``n`` rows: the
    k-steps of 16 entries a subspace, the 64-entry boxes of a slab and its
    bytes, the query groups, the units (576 rows x one group), and the
    table bytes the kernel reads from device memory a call (each slab
    once a unit)."""
    entries = min(k, 256)  # a u8 code never picks an entry past 255
    ksteps = -(-entries // 16)
    boxes = -(-ksteps // 4)
    groups = -(-q // _KT_QUERIES)
    slab_bytes = boxes * 3 * _KT_QUERIES * 128
    units = -(-n // _KT_ROWS) * groups
    return dict(entries=entries, ksteps=ksteps, boxes=boxes, groups=groups,
                slab_bytes=slab_bytes, units=units,
                table_bytes=units * m * slab_bytes)


def kt_slabs(tables: torch.Tensor) -> torch.Tensor:
    """The three :func:`split3` parts of ``tables [Q, m, k]`` as B2's
    slabs, ``[groups, m, boxes, 96, 8, 8]`` bf16 (a box: 96 column rows
    of 64 entries, eight 16-byte chunks each): slab ``(g, i)`` holds
    queries ``32g ..`` of subspace ``i``, column ``32p + q`` part ``p``
    (hi, mid, lo) of query ``32g + q``, entry ``64b + e`` in box ``b``,
    and each 128-byte column row is swizzled (16-byte chunk ``c`` stored at
    ``c ^ (column % 8)``): the shared-memory image of wgmma's K-major B
    operand. Zero past ``Q`` and past ``k``."""
    q, m, k = tables.shape
    plan = kt_plan(q, m, k, 0)
    groups, boxes, entries = plan["groups"], plan["boxes"], plan["entries"]
    parts = torch.stack(split3(tables[:, :, :entries]))
    parts = torch.nn.functional.pad(
        parts, (0, boxes * _KT_BOX - entries, 0, 0, 0, groups * _KT_QUERIES - q))
    cols = 3 * _KT_QUERIES
    slabs = parts.view(3, groups, _KT_QUERIES, m, boxes, 8, 8).permute(1, 3, 4, 0, 2, 5, 6)
    slabs = slabs.reshape(groups, m, boxes, cols, 8, 8)
    chunk = torch.arange(8, device=tables.device)
    swz = chunk[None, :] ^ (torch.arange(cols, device=tables.device) % 8)[:, None]
    return torch.gather(slabs, 4, swz.view(1, 1, 1, cols, 8, 1).expand(slabs.shape))


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
    plan = kt_plan(q, m, k, n)
    slabs = kt_slabs(tables)
    codes_t = codes_t.contiguous()
    _launch("vq_adc_kt", slabs.data_ptr(), codes_t.data_ptr(), out.data_ptr(), q, m,
            plan["ksteps"], plan["slab_bytes"], n, plan["groups"], plan["units"])
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


def gather_plan(q: int, m: int, k: int, n: int, only: int = 0) -> dict:
    """B3's launch plan for ``tables [q, m, k]`` over ``n`` rows, summing
    the first ``only`` subspaces (all when 0): the tier (``"paired"``, the
    tables in shared memory as 128-byte lines of two subspaces' entries
    for 4 quads; ``"device"``, read from device memory where those lines
    pass the 227 KB opt-in window), the queries a block, the shared bytes
    (``(subspaces + 1) // 2 * kp * 128``; ``kp`` is ``k + 1``, a zero
    entry for codes >= k, where a u8 code can reach k, else 256), the
    steps of a row set (an odd subspace count gets an idle one) and the
    query groups and 512-row block steps of the grid.
    ``csrc/adc_variants.cu`` checks the plan and refuses one that does not
    fit."""
    subspaces = _check_only(only, m)
    kp = k + 1 if k < 256 else 256
    paired = -(-subspaces // 2) * kp * _GATHER_LINE
    tier = "paired" if paired <= SMEM_OPTIN else "device"
    queries = min(_GATHER_QUERIES, 4 * -(-max(q, 1) // 4))
    return dict(tier=tier, queries=queries, smem_bytes=paired if tier == "paired" else 0,
                subspaces=subspaces, k=k, kp=kp, steps=subspaces + subspaces % 2,
                groups=-(-q // queries), tiles=-(-n // (32 * _GATHER_WARPS)))


def _wavefronts(addr: torch.Tensor) -> torch.Tensor:
    """Wavefronts of each phase ``addr [P, 8]`` (byte addresses of 8
    lanes' 16-byte shared loads): as many as the most distinct addresses
    that share one of the 8 16-byte slots of a 128-byte row of banks (one
    address read by several lanes is a broadcast)."""
    addr = addr.sort(1).values
    first = torch.ones_like(addr, dtype=torch.int64)
    first[:, 1:] = (addr[:, 1:] != addr[:, :-1]).to(torch.int64)
    per_slot = torch.zeros((addr.shape[0], 8), dtype=torch.int64, device=addr.device)
    return per_slot.scatter_add_(1, addr // 16 % 8, first).amax(1)


def gather_wavefronts(codes_t: torch.Tensor, plan: dict, lane_map: str = "b3") -> torch.Tensor:
    """Shared-memory wavefronts of each phase (8 lanes of a 16-byte load)
    of one query group's lookups over ``codes_t [m, n]`` u8, by the rule
    of :func:`_wavefronts`, at the paired tier of ``plan``
    (:func:`gather_plan`).

    ``lane_map="b3"``: B3's kernel as one block over all n rows. Warp w
    takes rows 32w .. + 31 of each 512-row step; lane 8h + 4g + l reads
    quad l's float4 of row set 4g + h at line ``(i // 2, c)``, byte ``(i
    % 2) * 64 + 16 l``, group 1 one step behind group 0 (one extra step at
    the end where the subspace count is even), an odd count with an idle
    step a row set. Every lane loads at every step: a bubble, a row set
    past n, or group 1's step before its first row set reads code 0.
    ``"k8"``: K8's (``csrc/adc_lookup.cu``): a phase is 8 lanes of 4
    consecutive rows each at one subspace, one quad's 16-byte entries
    ``[m][kp]`` (K8's kp: k, or k + 1 where k < 256), rows past n reading
    code 0 as K8 does; per quad."""
    s, n = plan["subspaces"], codes_t.shape[1]
    dev = codes_t.device
    codes = codes_t[:s].to(torch.int64)
    lane = torch.arange(4, device=dev)
    if lane_map == "k8":
        k = plan["k"]
        kp = k if k >= 256 else k + 1
        rows = -(-n // 32) * 32
        c = torch.nn.functional.pad(codes, (0, rows - n)).view(s, rows // 32, 8, 4)
        c = torch.minimum(c, torch.tensor(kp - 1, device=dev))  # past k: any one entry
        addr = (torch.arange(s, device=dev).view(s, 1, 1, 1) * kp + c) * 16
        addr = addr.permute(1, 0, 3, 2).reshape(-1, 8)  # (rows, subspace, row e) x 8 lanes
        return _wavefronts(addr)
    if lane_map != "b3":
        raise InvalidParameter("lane_map", f"must be 'b3' or 'k8', got {lane_map!r}")
    steps, kp, tile = plan["steps"], plan["kp"], 32 * _GATHER_WARPS
    tiles = -(-n // tile)
    last = plan["k"] if plan["k"] < 256 else 255  # the clamp's zero entry, or no clamp
    padded = torch.nn.functional.pad(codes, (0, tiles * tile - n))
    g = torch.arange(2, device=dev).view(1, 1, 1, 2)  # group
    warp = torch.arange(_GATHER_WARPS, device=dev).view(1, -1, 1, 1)
    quarter = torch.arange(4, device=dev).view(1, 1, 4, 1)
    e = torch.arange(4, device=dev)
    total, out = tiles * steps + (s % 2 == 0), []
    for t0 in range(0, total, _MODEL_STEPS):
        v = torch.arange(t0, min(total, t0 + _MODEL_STEPS), device=dev).view(-1, 1, 1, 1) - g
        tau, i = v.div(steps, rounding_mode="floor"), v.remainder(steps)
        j = tau * tile + 32 * warp + 4 * (4 * g + quarter)  # [step, warp, quarter, group]
        live = (tau >= 0) & (tau < tiles) & (i < s) & (j < n)
        c = padded[torch.where(live, i, 0)[..., None], torch.where(live, j, 0)[..., None] + e]
        c = torch.where(live[..., None], torch.minimum(c, torch.tensor(last, device=dev)), 0)
        line = (i // 2)[..., None] * kp + c  # [.., row]
        addr = line[..., None] * _GATHER_LINE + (i % 2)[..., None, None] * 64 + 16 * lane
        addr = addr.permute(0, 1, 2, 4, 3, 5).reshape(-1, 8)  # (.., row) x (group, quad)
        out.append(_wavefronts(addr))
    return torch.cat(out)


def adc_gather(tables: torch.Tensor, codes_t: torch.Tensor, only: int = 0) -> torch.Tensor:
    """B3: ``[Q, n]`` ADC sums of ``tables [Q, m, k]`` over ``codes_t [m,
    n]`` u8 by gathers, over the first ``only`` subspaces when ``only >
    0``, launched by :func:`gather_plan`'s plan."""
    tables = tables.to(torch.float32)
    if not _on_card(tables, codes_t):
        return adc_gather_plain(tables, codes_t, only)
    _check(tables, codes_t)
    q, m, k = tables.shape
    n = codes_t.shape[1]
    _check_only(only, m)
    out = torch.empty((q, n), dtype=torch.float32, device=tables.device)
    if q == 0 or n == 0 or m == 0 or k == 0:
        return out.zero_()
    plan = gather_plan(q, m, k, n, only)
    tables, codes_t = tables.contiguous(), codes_t.contiguous()
    vec = n % 4 == 0 and codes_t.data_ptr() % 4 == 0
    _launch("vq_adc_gather", tables.data_ptr(), codes_t.data_ptr(), out.data_ptr(), q, m, k, n,
            plan["subspaces"], plan["queries"], plan["smem_bytes"], int(vec))
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
        "gather": lambda: adc_gather(tables, codes_t),
        "floor": lambda: adc_floor(tables, codes_t),
        "gather1": lambda: adc_gather(tables, codes_t, only=1),
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
