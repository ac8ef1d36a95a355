"""K2, K3, K4, K4-bf16, K4-bf16x3 and K6 of this checkout beside another
checkout's, on one card.

    python3 -m vq_tpu_torch.benchmarks.pq_scan_ab --against DIR

``DIR`` is another checkout of the repository, e.g. a parent commit
unpacked with ``git archive``. Its kernel library is built from its own
sources by its own ``ops/_build.py`` (under ``DIR/build/``), and its wrappers
(``DIR/vq_tpu_torch/ops/cuda_kernels.py``) are loaded by file path under
another module name and launch into that library; so the two versions run
in one process on the same operands. On a seeded Gaussian mixture (1M x
128, codebooks 8x256x16 drawn from it) the script encodes the 1M rows
with f32 and bf16 input exactly (K4), at ``"bf16_fast"`` with f32 and
bf16 input (K4-bf16) and at ``"bf16x3"`` (K4-bf16x3), runs one PQ
Lloyd pass on the first 100k and 200k rows (K3) and one k-means Lloyd
pass on the first 200k rows against 1024 and 256 of the rows (K2), and
runs K6 on the operands of this checkout's IVF-Flat f32 / bf16 and IVF-SQ
searches (IVF1024 trained on the first 200k rows, the 1M rows added, 128
queries at nprobe 8 and 64). It prints one JSON line a case: whether the
outputs agree, and the milliseconds a call (CUDA events, 5 calls a
round) of each version in rounds other, this, this, other. K2, K4 and K6
agree bit for bit; the lower-precision encodes by
``cuda_kernels.encode_parity`` (their tensor-core sums may flip a code at
a float64 near tie), with the share of codes equal. K3 sums in another
order than a checkout before its segmented sums stage: there the counts
agree exactly and the sums and inertia within ``K3_RTOL`` (of each sum
plus of the largest), and each side is also held to its own plain
version (this checkout's bit for bit, the other's by the same rule where
it is not bit-identical). The last line is the card's ``nvidia-smi`` name
and power limit. Exits 1 if any case disagrees.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Sequence

import torch

from vq_tpu_torch.benchmarks import cuda_ms
from vq_tpu_torch.ops import cuda_kernels as ck

N, DIM, M, K, SEED = 1_000_000, 128, 8, 256, 0
K3_ROWS = (100_000, 200_000)
K3_RTOL = 1e-5  # K3 against a checkout that sums in another order
K2_ROWS, K2_CLUSTERS = 200_000, (1024, 256)
NLIST, IVF_TRAIN, QUERIES, NPROBES = 1024, 200_000, 128, (8, 64)  # K6's searches


def _load(name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def other_kernels(root: Path) -> ModuleType:
    """``root``'s ``cuda_kernels`` module, launching into ``root``'s own
    kernel library (built on first use from ``root``'s sources)."""
    build = _load("_other_build", root / "vq_tpu_torch" / "ops" / "_build.py")
    mod = _load("_other_cuda_kernels", root / "vq_tpu_torch" / "ops" / "cuda_kernels.py")

    def launch(fn, *args):
        err = getattr(build.LIBRARY.get(), fn)(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{root}: {fn}: CUDA launch failed with error {err}")

    mod._launch = launch
    return mod


def make_operands(device):
    """Seeded mixture ``x [N, DIM]`` (1024 rank-24 clusters) and codebooks
    ``[M, K, DIM / M]`` drawn from its rows."""
    g = torch.Generator(device=device).manual_seed(SEED)
    centres = torch.randn(1024, DIM, generator=g, device=device) * 4.0
    lab = torch.randint(0, 1024, (N,), generator=g, device=device)
    basis = torch.randn(24, DIM, generator=g, device=device) * (2.0 / 24 ** 0.5)
    x = (centres[lab] + torch.randn(N, 24, generator=g, device=device) @ basis
         + 0.1 * torch.randn(N, DIM, generator=g, device=device))
    pick = torch.randperm(N, generator=g, device=device)[:K]
    cb = x[pick].reshape(K, M, DIM // M).permute(1, 0, 2).contiguous()
    return x.contiguous(), cb


def k6_operands(x) -> dict:
    """``{case: (args, kwargs)}`` of K6's call in each IVF-Flat f32 /
    bf16 and IVF-SQ search of this checkout, over ``x``."""
    import vq_tpu_torch
    import vq_tpu_torch.ivf_flat as ivf_flat

    g = torch.Generator(device=x.device).manual_seed(SEED + 1)
    pick = torch.randperm(N, generator=g, device=x.device)[:QUERIES]
    queries = x[pick] + 0.05 * torch.randn(QUERIES, DIM, generator=g, device=x.device)
    flat = vq_tpu_torch.IVFFlatIndex.train(x[:IVF_TRAIN], NLIST, max_iters=10)
    indexes = {"f32": flat, "bf16": vq_tpu_torch.IVFFlatIndex(flat.coarse, store_dtype="bfloat16"),
               "u8": vq_tpu_torch.IVFSQIndex.train(x[:IVF_TRAIN], NLIST, max_iters=10)}
    kernel, out = ivf_flat.ivf_probe_matvec_fused, {}
    for name, idx in indexes.items():
        idx.add(x)
        for p in NPROBES:
            calls = []
            ivf_flat.ivf_probe_matvec_fused = lambda *a, **kw: calls.append((a, kw)) or kernel(*a, **kw)
            try:
                idx.search(queries, k=10, nprobe=p)
            finally:
                ivf_flat.ivf_probe_matvec_fused = kernel
            out[f"K6 {name} nprobe={p}"] = calls[0]
    return out


def k3_close(a, b) -> bool:
    """Counts equal; sums within ``K3_RTOL`` of each sum plus ``K3_RTOL``
    of the largest; inertia within ``K3_RTOL``."""
    (sa, ca, ia), (sb, cb_, ib) = a, b
    tol = K3_RTOL * sb.abs() + K3_RTOL * float(sb.abs().max())
    return (torch.equal(ca, cb_) and bool(((sa - sb).abs() <= tol).all())
            and abs(float(ia) - float(ib)) <= K3_RTOL * abs(float(ib)))


def compare(this: Callable, other: Callable, agree: Callable = None, reps: int = 5):
    """``(agree, this ms [2], other ms [2])``: the outputs bit for bit (or
    by ``agree(this's, other's)``), then rounds other, this, this, other."""
    a, b = this(), other()
    if agree is not None:
        ok = agree(a, b)
    else:
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        ok = len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
    o1, t1, t2, o2 = (cuda_ms(f, reps) for f in (other, this, this, other))
    return ok, [t1, t2], [o1, o2]


def main(argv: Sequence[str] = ()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path, help="another checkout's root")
    ap.add_argument("--only", nargs="*", default=(), help="run the cases whose names hold one of these")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        raise SystemExit("pq_scan_ab: needs an NVIDIA GPU")
    other = other_kernels(args.against.resolve())

    def selected(name):
        return not args.only or any(w in name for w in args.only)

    x, cb = make_operands("cuda")
    xb = x.to(torch.bfloat16)
    cases = {
        "K4 f32 1M": (lambda: ck.pq_encode_fused(x, cb), lambda: other.pq_encode_fused(x, cb)),
        "K4 bf16 1M": (lambda: ck.pq_encode_fused(xb, cb), lambda: other.pq_encode_fused(xb, cb)),
    }
    for n in K3_ROWS:
        cases[f"K3 {n}"] = (lambda n=n: ck.pq_lloyd_accumulate_fused(x[:n], cb),
                            lambda n=n: other.pq_lloyd_accumulate_fused(x[:n], cb))
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cents = x[torch.randperm(N, generator=g, device="cuda")[:max(K2_CLUSTERS)]]
    for kc in K2_CLUSTERS:
        cases[f"K2 {K2_ROWS} x {kc}"] = (
            lambda kc=kc: ck.lloyd_accumulate_fused(x[:K2_ROWS], cents[:kc]),
            lambda kc=kc: other.lloyd_accumulate_fused(x[:K2_ROWS], cents[:kc]))
    if any(selected(f"K6 {t} nprobe={p}") for t in ("f32", "bf16", "u8") for p in NPROBES):
        for name, (a, kw) in k6_operands(x).items():
            cases[name] = (lambda a=a, kw=kw: ck.ivf_probe_matvec_fused(*a, **kw),
                           lambda a=a, kw=kw: other.ivf_probe_matvec_fused(*a, **kw))
    rules = {}
    for name, xx, p in (("K4-bf16 f32 1M", x, "bf16_fast"), ("K4-bf16 bf16 1M", xb, "bf16_fast"),
                        ("K4-bf16x3 1M", x, "bf16x3")):
        cases[name] = (lambda xx=xx, p=p: ck.pq_encode_fused(xx, cb, precision=p),
                       lambda xx=xx, p=p: other.pq_encode_fused(xx, cb, precision=p))
        rules[name] = (xx, p)
    ok = True
    for name, (this, oth) in cases.items():
        if not selected(name):
            continue
        extra, agree = {}, None
        if name.startswith("K3"):
            n = int(name.split()[1])

            def agree(a, b, n=n):
                same = [torch.equal(u, v) for u, v in zip(a, b)]
                this_plain = ck.pq_lloyd_accumulate_plain(x[:n], cb)
                other_plain = other.pq_lloyd_accumulate_plain(x[:n], cb)
                extra.update(
                    bits_equal=same, max_sums_diff=float((a[0] - b[0]).abs().max()),
                    this_plain_equal=all(torch.equal(u, v) for u, v in zip(a, this_plain)),
                    other_plain_equal=all(torch.equal(u, v) for u, v in zip(b, other_plain)),
                    other_plain_close=k3_close(b, other_plain))
                return (k3_close(a, b) and extra["this_plain_equal"]
                        and (extra["other_plain_equal"] or extra["other_plain_close"]))
        elif name in rules:
            xx, p = rules[name]

            def agree(a, b, xx=xx, p=p):
                par = ck.encode_parity(xx, cb, a, p, want=b)
                extra.update(match=par.match, flips=par.flips, max_gap=par.max_gap)
                return par.ok
        equal, t_ms, o_ms = compare(this, oth, agree)
        ok &= equal
        print(json.dumps({"case": name, "equal": equal, **extra, "this_ms": t_ms, "other_ms": o_ms,
                          "other": str(args.against)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
