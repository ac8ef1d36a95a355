#!/usr/bin/env python3
"""On-card smoke run of vq_tpu_torch, the PyTorch / CUDA port of vq_tpu.

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, one line each (any failure exits non-zero with no result line):

1. device — the card's ``nvidia-smi`` name and power limit, TF32 off;
2. build — nvcc builds ``vq_tpu_torch/csrc`` for sm_90a under ``build/``;
3. kernels — K3, K4 and K5 each held to its plain PyTorch version on the
   card at the main path's shapes (1M x 128 corpus, 8x256x16 codebooks,
   128-query batches; K3 at 100k and 200k rows, sums, counts and inertia
   bit for bit and on a second run, its scan's minimum scores equal to
   the plain smin; K4 bit for bit with f32 and bf16 input; K5 at
   fetch 1, 10, 100 and 128 and on tie-heavy codes, bit for bit and on a
   second run);
4. main path — ``ProductQuantizer`` trained on 100k rows, ``PQIndex.add``
   of the 1M corpus, ``search(k=10)`` and ``search(k=10, rerank=100)``
   through the public entry points, with the launch counters of all three
   kernels checked, results held to the plain route on the same card and
   recall@10 against exact brute force;
5. ivf kernels — K1 (assign) at 1M x 1024 x 128 in f32 and bf16, held to
   its plain version on the card, and K2 (Lloyd accumulate) at 200k x
   1024 x 128 (IVF) and 200k x 256 x 128 (an RQ stage), held bit for bit
   to its plain version and to a second run;
6. ivf path — ``IVFPQIndex.train`` (IVF1024, PQ 8x256 on residuals) on
   200k rows, ``add`` of the 1M corpus, ``search(k=10)`` at nprobe 8 and
   64 with rerank 0 and 500, through the public entry points: launch
   counts of K1, K2, K3, K4 and K7 read from that run, lists, codes and
   search results held to the plain route (every kernel wrapper swapped
   for its plain version) on the same card, recall@10 against the exact
   ground truth; then K7 held to its plain version over the built
   index's probed chains at nprobe 8 and 64;
7. ivf-flat path — ``IVFFlatIndex.train`` (IVF1024) and
   ``IVFSQIndex.train`` (IVF1024, residual SQ8) on 200k rows, ``add`` of
   the 1M corpus to an f32, a bf16 and an SQ index (and a ``metric="dot"``
   f32 one), ``search(k=10)`` at nprobe 8 and 64 (the dot index at 8),
   the width of ``benchmarks/serving_bench.py``: launch counts of K1, K2
   and K6 read from that run, every search held to the plain route on
   the same card, recall@10 against the exact ground truth; then K6 held
   to its plain version on the operands each search gave it (f32, bf16
   and u8 payloads at nprobe 8 and 64), and its work list (which
   (pair, chain slot) entries read each chunk) to the plain version's;
8. lowp kernels — K4-bf16 and K4-bf16x3 (tensor cores) held to their
   plain versions at 1M x 128 against 8x256x16 with f32 and bf16 input by
   the near-tie rule (``cuda_kernels.encode_parity``: >= 0.9999 of the
   codes equal, every other one a float64 near tie), and bit for bit on
   small-integer operands at the same shapes;
9. pq precision — on the main phase's quantizer, ``PQIndex.add(corpus,
   precision="high")`` and ``(..., "default")`` and
   ``ProductQuantizer.adc_distances`` at [128, 1M]: launch counts of
   K4-bf16x3, K4-bf16 and K8 read from that run, codes held to the plain
   route by the near-tie rule, distances and each search (over the
   index's own codes) held to it bit for bit, code-match rates against the exact encode and
   recall@10 beside the exact index's; then K8 held to its plain version
   on those operands;
10. rq path — the width of ``benchmarks/serving_bench.py:186-204,
   327-351``: ``ResidualQuantizer`` 8x256 trained on 200k rows, ``RQIndex``
   ``add`` of 1M and ``search(k=10)`` (K5 l2), ``rerank=500`` (K8 over 4
   chunks), a ``metric="cosine"`` (K8) and a ``metric="dot"`` (K5 dot)
   index; ``IVFRQIndex.train`` (IVF1024, RQ 8x256, 200k rows), ``add`` of
   1M, ``search(k=10)`` at nprobe 8 and 64 (K7): launch counts of K1, K2,
   K5, K7 and K8 read from that run, codes and searches held to the plain
   route, recall@10 against the exact ground truth; then K8 held to its
   plain version on one RQ chunk (262,144 rows);
11. timings — CUDA events, kernel beside plain version (and, for K8, the
   one PyTorch call that computes the same function,
   ``embedding_bag``), each line stamped with the card's name and power
   limit, with K1's floor under its exact contract and a cuBLAS fp32
   product of its shape beside it; K3 at 100k and 200k rows and K4 at 1M
   with their floors under the same contract; K5 at fetch 1 to 128 and on
   tie-heavy codes, with its shared-memory lookup floor; K6 on each
   search's operands, with a ``[bound]`` line (the rows of the chunks its
   probe table names, read once, plus the output) and a
   ``torch.profiler`` line of its launches (memset, entry pass, scan,
   cursor, scatter, matvec); K2 at both
   shapes, with a
   ``torch.profiler`` line a shape of the device time of each of its
   stages, and its sums stage beside ``index_add_`` (one PyTorch call
   with float atomics, a yardstick the port never calls) and its bytes
   bound; K3 at 100k and 200k rows with a ``torch.profiler`` line of the
   device time of each of its launches (K4's scan, the labels and
   inertia partials, K2's sums stage, the inertia sum), and its sums
   stage beside its bytes bound and ``index_add_``; K7 at nprobe 8 and 64,
   each with its bound; K8 at [128, 1M] and on one RQ chunk beside
   ``embedding_bag``, and on codes that cost one shared-memory wavefront
   a phase, with its bytes bound at both shapes, its 4-byte lookup floor
   and its 16-byte design's floor counted on this run's codes
   (:func:`k8_wavefronts`); then a
   ``torch.profiler`` line a call of the PQ and IVF-PQ trainers,
   ``PQIndex.add``, the IVF adds, ``PQIndex.search``, the IVF-Flat,
   IVF-SQ and IVF-PQ searches (nprobe 8 and 64), and the precision and
   RQ paths (wall, device time, busy share, top kernels, K7's launches
   by stage, K8's share);
12. bench kernels — the benchmark twins' kernels on seeded uniform data
   made on the card (x [1M, 128], codebooks 8x256x16 through
   ``build_w``, tables [128, 8, 256], u8 codes [1M, 8] and their
   transpose): B1 ``"highest"`` on 100k rows bit-identical to its plain
   version, and on all 1M rows to K4; B1 ``"default"`` with f32 and
   bf16-resident operands held to its plain version by
   ``mpacked_encode.kernel_parity`` (>= 0.9999 of the codes equal, the
   rest float64 near ties), and its match against K4-bf16; B2 and B3 bit
   for bit against their plain versions and K8, B4 against its plain
   version; K2 with seeded weights at both of its shapes twice and
   against its weighted plain version, bit for bit. Then the twins' ``main()``
   (``vq_tpu_torch.benchmarks.mpacked_encode`` and ``.adc_vmem_bench``)
   run at their default sizes, the slice's main path: launch counts read
   from that run, every ``parity`` field true. Then timings: B1's three
   variants beside K4, K4-bf16 and K4-bf16x3 at 1M, and B2, B3, B4 beside
   K8 and ``embedding_bag`` at [128, 1M];
13. eval path — the four eval harnesses' ``main()``
   (``vq_tpu_torch.cli.eval_{bq,sq,pq,tsvq}``) at the reference grid's
   width, ``--sizes 1000000 --dim 384 --recall`` with every other flag
   at its default (seed 66, BQ threshold 0.5, SQ 256 levels, PQ 16x256
   with 10 iterations, TSVQ depth 5, euclidean): every row parsed, its
   ``mse`` and ``recall_at_k`` finite, K3's and K4's launch counts read
   from ``eval_pq``'s run (no kernel in the other three); K4 on all 1M
   rows and K3 on 100k of them, with ``eval_pq``'s own codebooks
   (16x256x24), bit for bit against their plain versions; BQ codes,
   uint32 words and a [128, 1M] Hamming block equal to the same functions
   on the CPU copies; TSVQ leaf ids of 100k rows on the card equal to the
   CPU run's except float near ties (printed and counted); the TSVQ
   device build at 200k x 384, depth 5, bit-identical to the same build
   on the CPU, and to the host recursion's tree except splits at float
   near ties (each printed with its two summed deviations). Then K3 and
   K4 timed at that shape beside their plain versions and floors, and a
   ``torch.profiler`` line a harness (one more ``main()`` each: wall,
   device time, busy share, top kernels).

Before the last line it prints a JSON line of per-kernel results (each
with its launches on its path, its error against the plain version, its
time, the plain version's, the least time the card could take for the
same work at its shapes — bytes over 3.35 TB/s or operations over the
67 TFLOP/s fp32 / 989 TFLOP/s bf16 peak, whichever is larger — and a
library call's time where one exists) and the ``nvidia-smi`` line; the last line is the run's verdict,
``{"ok": true, "device": {...}}``. The data is a seeded Gaussian mixture
made on the card; the weights are trained from it.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import subprocess
import sys
import time

from vq_tpu_torch.benchmarks import cuda_ms  # CUDA-event ms a call, after one warm-up

N_CORPUS, DIM, N_QUERY = 1_000_000, 128, 128
N_TRAIN, M, K = 100_000, 8, 256
N_CLUSTERS, LATENT, SEED = 1024, 24, 0
# K3 (K4's scan, then K2's sums stage over the [n*m, s] view: one
# segmented order shared with the plain version): bit-identical.
# K1's distances where its codes agree: within 1e-5 of the largest.
K1_DIST_RTOL = 1e-5
# K1, B1 "default", K4-bf16 and K4-bf16x3: a code may differ from the
# plain version's only where the two candidates' scores, recomputed in
# float64, are near ties (``mpacked_encode.near_ties``,
# ``cuda_kernels.encode_near_ties``: TIE_RTOL relative gap). K4 (the
# register-tiled scan of csrc/pq_encode.cu, the plain version's order, no
# FMA) is held bit for bit; its floor, like K1's, is 2 n m k s FP32
# instructions over the card's instruction rate.
# IVF path, the width of the repo's IVF benchmark (benchmarks/ivf_bench.py).
NLIST, N_IVF_TRAIN, NPROBES, RERANKS = 1024, 200_000, (8, 64), (0, 500)
# K1 (csrc/assign.cu: 8 x 8 register tiles, x resident in shared memory,
# a cp.async ring of centroid slices) sums each dot in the plain version's
# order with no FMA, so it is bit-identical by design: the phase counts the
# codes and distances that differ (0 expected) and still holds any code to
# a float64-verified near tie, the distance to 1e-5 where codes agree. Its
# floor under that contract is 2 n k d FP32 instructions over the card's
# instruction rate (SMs x 128 lanes x max SM clock), not the FMA-counted bound.
# K2 (kernel and plain version share one segmented summation order), K6
# and K7: bit-identical.
# IVF-Flat / IVF-SQ searches, the width of benchmarks/serving_bench.py.
FLAT_KINDS, FLAT_MIN_RECALL = ("flat_f32", "flat_bf16", "sq"), 0.9
# RQ path, the width of benchmarks/serving_bench.py:186-204 (RQIndex 8x256
# greedy over 1M x 128) and :327-351 (IVF-RQ); K8's chunk of the RQ scan.
RQ_STAGES, RQ_ITERS, RQ_RERANK, RQ_CHUNK = 8, 8, 500, 262_144
# The benchmark twins' kernels: B1 held to its plain version on the
# scripts' 100k parity rows (``mpacked_encode.kernel_parity``).
B1_ROWS = 100_000
# Phase 13, the eval harnesses at the reference grid's width: 1M x 384
# rows; K3 held on 100k of them; 128 Hamming queries; TSVQ's builds on 200k
# rows and its encode on 100k; a TSVQ near tie is a float64 gap within
# 1e-5 of the larger distance (or summed deviation).
EVAL_ROWS, EVAL_DIM, EVAL_K3_ROWS, EVAL_QUERIES = 1_000_000, 384, 100_000, 128
EVAL_TSVQ_ROWS, EVAL_TSVQ_ENCODE, TSVQ_TIE_RTOL = 200_000, 100_000, 1e-5
PQ_EVAL = (16, 256, 24)  # eval_pq's default codebooks on dim 384
# The H100's published peaks (SXM, 700 W): HBM bytes/s, fp32 on the CUDA
# cores and bf16 on the tensor cores, FLOP/s.
HBM_BPS, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# K2's kernels (csrc/lloyd.cu) by stage, as the profiler names them.
K2_STAGES = (("assign", "assign_kernel"), ("memset", "Memset"), ("histogram", "chunk_hist_kernel"),
             ("totals", "cluster_totals_kernel"), ("scan", "cluster_scan_kernel"),
             ("cursor", "chunk_cursor_kernel"), ("scatter", "chunk_scatter_kernel"),
             ("table", "segment_table_kernel"), ("sums", "segment_sum_kernel"),
             ("combine", "segment_combine_kernel"), ("inertia", "inertia_kernel"))
# K3's launches (csrc/pq_lloyd.cu), as the profiler names them: K4's scan,
# the labels and inertia partials, then K2's sums stage (lloyd.cu).
K3_STAGES = (("pq scan", "pq_scan_"), ("terms", "pq_terms_kernel")) + K2_STAGES[1:]
# K6's launches (csrc/ivf_matvec.cu): the work-list pass and the matvec.
K6_STAGES = (("memset", "Memset"), ("entry pass", "entry_pass_kernel"), ("scan", "bin_scan_kernel"),
             ("cursor", "bin_cursor_kernel"), ("scatter", "entry_scatter_kernel"),
             ("matvec", "chunk_matvec_kernel"))
# K7's launches (csrc/ivf_probe.cu): the pairs' bins, K6's work list over
# them (the quads), then the sums.
K7_STAGES = (("keys", "pair_key_kernel"),) + K6_STAGES[:-1] + (("sums", "ivf_probe_kernel"),)
# Every kernel wrapper the paths call, and the modules that call it.
KERNEL_CALLERS = (
    ("vq_tpu_torch.ops.kmeans", ("assign_fused", "lloyd_accumulate_fused",
                                 "pq_lloyd_accumulate_fused")),
    ("vq_tpu_torch.models.pq", ("pq_encode_fused", "adc_scan_topk_fused", "adc_lookup_fused")),
    ("vq_tpu_torch.models.rq", ("assign_fused",)),
    ("vq_tpu_torch.search", ("adc_scan_topk_fused",)),
    ("vq_tpu_torch.ivf", ("ivf_probe_adc_fused",)),
    ("vq_tpu_torch.ivf_flat", ("ivf_probe_matvec_fused", "ivf_probe_adc_fused")),
    ("vq_tpu_torch.benchmarks.mpacked_encode", ("pq_encode_fused",)),
    ("vq_tpu_torch.benchmarks.adc_vmem_bench", ("adc_lookup_fused",)),
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_once(fn):
    """``(result, ms)`` of one call by CUDA events (no warm-up)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def clocked(fn):
    """``(fn(), note)``: fn runs while ``nvidia-smi`` samples the SM clock,
    power draw and active clock-event reasons every 20 ms; the note gives
    their range over fn's run, so that a time taken below the card's
    maximum clock says so."""
    import datetime

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,clocks_event_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)  # nvidia-smi's start-up
        t0 = datetime.datetime.now()
        out = fn()
        t1 = datetime.datetime.now()
    finally:
        proc.terminate()
        lines = proc.communicate(timeout=60)[0].splitlines()
    rows = []
    for line in lines:
        f = [s.strip() for s in line.split(",")]
        try:
            rows.append((datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f"),
                         float(f[1]), float(f[2]), f[3]))
        except (ValueError, IndexError):
            continue
    inside = [r for r in rows if t0 <= r[0] <= t1]
    if not inside:
        return out, "no clock sample inside the window"
    mhz = [r[1] for r in inside]
    return out, (f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz, power up to "
                 f"{max(r[2] for r in inside):.0f} W, clock-event reasons "
                 f"{sorted({r[3] for r in inside})} ({len(inside)} samples)")


def all_kernels():
    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    return (ck.assign_fused, ck.lloyd_accumulate_fused, ck.pq_lloyd_accumulate_fused,
            ck.pq_encode_fused, ck.adc_scan_topk_fused, ck.ivf_probe_adc_fused,
            ck.ivf_probe_matvec_fused, ck.adc_lookup_fused, mp.mpacked_encode, av.adc_kt,
            av.adc_gather, av.adc_floor)


def reset_counts():
    """Every launch count to 0 (K4's and B1's counts a precision too)."""
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    for fn in all_kernels():
        fn.launches = 0
    ck.pq_encode_fused.launches_by = dict.fromkeys(ck.ENCODE_PRECISIONS, 0)
    mp.mpacked_encode.launches_by = dict.fromkeys(mp.PRECISIONS, 0)


def read_counts():
    """The launch counts by wrapper, K4 and B1 split by precision."""
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    out = {fn.__name__: fn.launches for fn in all_kernels()}
    out.update({f"pq_encode_fused[{p}]": n for p, n in ck.pq_encode_fused.launches_by.items()})
    out.update({f"mpacked_encode[{p}]": n for p, n in mp.mpacked_encode.launches_by.items()})
    return out


def stage_times(events, table=None, calls: int = 1):
    """``{stage: (ms a call, launches a call)}`` of the kernels of ``table``
    (K2's stages by default) among the profiler's device events, over
    ``calls`` calls."""
    out = {}
    for e in events:
        for stage, key in table or K2_STAGES:
            if key in e.key:
                ms, n = out.get(stage, (0.0, 0))
                out[stage] = (ms + e.self_device_time_total / 1e3 / calls, n + e.count / calls)
    return out


def k2_shapes(kres):
    """K2's two shapes: ``{tag: centroids}`` for the 200k training rows."""
    return {f"{N_IVF_TRAIN} x {NLIST} x {DIM}": kres["cents"],
            f"{N_IVF_TRAIN} x {K} x {DIM}": kres["cents_rq"]}


def sm_rate():
    """``(SMs, max SM clock in MHz)`` of card 0, for the floors of K1 and K5."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz


def bound(nbytes: float, flops: float, peak: float):
    """``(ms, "bytes" or "operations")``: the least time the card could
    take, the larger of bytes over HBM bandwidth and operations over
    ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_route():
    """The paths with every kernel wrapper swapped for its plain version
    (on the same card), for holding the paths' results to them; checks
    that no kernel launched meanwhile."""
    from vq_tpu_torch.ops import cuda_kernels as ck

    before = read_counts()
    saved = []
    for mod_name, names in KERNEL_CALLERS:
        mod = importlib.import_module(mod_name)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(ck, name.replace("_fused", "_plain")))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    assert read_counts() == before, "a kernel ran on the plain route"


@contextlib.contextmanager
def recording(mod_name: str, name: str):
    """Yields a list that gathers ``(args, kwargs)`` of every call of
    ``mod_name.name`` meanwhile (the call itself goes through)."""
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, name)
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(mod, name, record)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


def make_data(device):
    """Seeded Gaussian mixture on the card -> (corpus, queries, generator).

    Each component's covariance is low-rank (rank LATENT) plus a small
    isotropic part, as embeddings tend to be; with isotropic components
    in 128-d, points of a cluster are all about equally far apart and
    nearest neighbours are noise."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    n = N_CORPUS + N_QUERY
    centres = torch.randn(N_CLUSTERS, DIM, generator=g, device=device) * 4.0
    lab = torch.randint(0, N_CLUSTERS, (n,), generator=g, device=device)
    basis = torch.randn(LATENT, DIM, generator=g, device=device) * (2.0 / LATENT ** 0.5)
    pts = (centres[lab]
           + torch.randn(n, LATENT, generator=g, device=device) @ basis
           + 0.1 * torch.randn(n, DIM, generator=g, device=device))
    return pts[:N_CORPUS].contiguous(), pts[N_CORPUS:].contiguous(), g


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    import vq_tpu_torch  # noqa: F401  (sets TF32 off)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi} | torch.cuda: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from vq_tpu_torch.ops._build import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    secs = time.perf_counter() - t0
    for line in LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", "ptxas: " + line.strip())
    log("build", f"{secs:.2f} s (library {LIBRARY.path})")
    return secs


def _near_ties(x, cents, got, want):
    """``(rows, max gap)``: the rows where two assignments differ and their
    largest float64 score gap; fails unless every one is a near tie (one
    block of ``k`` columns, ``W = -2 c^T``)."""
    from vq_tpu_torch.benchmarks.mpacked_encode import near_ties

    cd = cents.double()
    flips, gap, ties = near_ties(x, -2.0 * cents.float().T, (cd * cd).sum(-1), got[:, None],
                                 want[:, None], "highest")
    assert ties, f"{flips} differing codes are not near ties"
    return flips, gap


def _k4_check(x, cb, tag):
    """K4 against its plain version, bit for bit."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    got = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    want = ck.pq_encode_plain(x, cb)
    assert torch.equal(got, want), (
        f"K4 {tag}: {int((got != want).sum())} codes differ from the plain version")
    plan = ck.pq_scan_plan(x.shape[0], *cb.shape)
    log("kernels", f"K4 pq_encode {tag} {tuple(x.shape)} vs 8x256x16: {got.numel()} codes "
        f"bit-identical to the plain version (scan plan {plan})")
    return got


def phase_kernels(corpus, queries, g):
    import torch

    from vq_tpu_torch.models.pq import _adc_tables
    from vq_tpu_torch.ops import cuda_kernels as ck
    from vq_tpu_torch.ops.distance import Metric
    from vq_tpu_torch.ops.packing import pack_codes

    dev = corpus.device
    s = DIM // M
    pick = torch.randperm(N_CORPUS, generator=g, device=dev)[:K]
    cb = corpus[pick].reshape(K, M, s).permute(1, 0, 2).contiguous()  # [m, k, s]
    res = {"cb": cb}

    codes = _k4_check(corpus, cb, "f32")
    _k4_check(corpus.to(torch.bfloat16), cb, "bf16")
    res["k4_err"] = 0.0

    for n3 in (N_TRAIN, N_IVF_TRAIN):
        x3 = corpus[:n3]
        got = ck.pq_lloyd_accumulate_fused(x3, cb)
        again = ck.pq_lloyd_accumulate_fused(x3, cb)
        minval = ck._pq_lloyd_card(x3, cb)[3]
        torch.cuda.synchronize()
        want = ck.pq_lloyd_accumulate_plain(x3, cb)
        diffs = [int((a != b).sum()) for a, b in zip(got, want)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"K3 {n3}: {diffs} sums / counts / inertia differ from the plain version")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (
            f"K3 {n3} is not deterministic from run to run")
        assert int(got[1].sum()) == n3 * M
        smin = ck._pq_scan_plain(x3, cb)[1]
        assert torch.equal(minval.view(torch.int32), smin.view(torch.int32)), (
            f"K3 {n3}: the scan's minimum scores differ from the plain smin")
        log("kernels", f"K3 pq_lloyd_accumulate {tuple(x3.shape)} vs {M}x{K}x{s}: sums, counts and "
            f"inertia ({float(got[2]):.9g}) bit-identical to the plain version and on a second run, "
            f"minimum scores equal to the plain smin (codewords: largest {int(got[1].max())} rows, "
            f"empty {int((got[1] == 0).sum())})")
    res["k3_err"] = 0.0

    codes_t = codes.to(torch.uint8).T.contiguous()
    tables = _adc_tables(queries, cb, Metric.SQUARED_EUCLIDEAN)
    cb16 = cb[:, :16].contiguous()
    codes16 = pack_codes(ck.pq_encode_fused(corpus, cb16), 4).T.contiguous()
    tables16 = _adc_tables(queries, cb16, Metric.SQUARED_EUCLIDEAN)
    # Tie-heavy: codes from 4 values a subspace and integer tables in
    # [0, 3), so a tile's 2048 sums take at most 17 values.
    tied_t = torch.randint(0, 4, (M, N_CORPUS), generator=g, device=dev, dtype=torch.uint8)
    tied_tab = torch.randint(0, 3, (N_QUERY, M, K), generator=g, device=dev).float()
    cases = [
        ("u8 8x256 fetch=10", tables, codes_t, 10, {}),
        ("u8 8x256 fetch=100", tables, codes_t, 100, {}),
        ("u8 8x256 fetch=1", tables, codes_t, 1, {}),
        ("u8 8x256 fetch=128", tables, codes_t, 128, {}),
        ("tie-heavy u8 8x256 fetch=10", tied_tab, tied_t, 10, {}),
        ("tie-heavy u8 8x256 fetch=100", tied_tab, tied_t, 100, {}),
        ("4-bit 8x16 fetch=10", tables16, codes16, 10, {"pack_bits": 4}),
    ]
    small = min(50_000, N_CORPUS)
    qn2 = (queries[:16] * queries[:16]).sum(-1)
    off = torch.rand(small, generator=g, device=dev) * 10
    cases += [
        ("l2 mode small", tables[:16], codes_t[:, :small], 10,
         {"mode": "l2", "qn2": qn2, "offsets": off}),
        ("dot mode small", tables[:16], codes_t[:, :small], 10, {"mode": "dot"}),
    ]
    err5 = 0.0
    for name, tab, ct, fetch, kw in cases:
        v, i = ck.adc_scan_topk_fused(tab, ct, fetch, **kw)
        v2, i2 = ck.adc_scan_topk_fused(tab, ct, fetch, **kw)
        torch.cuda.synchronize()
        pv, pidx = ck.adc_scan_topk_plain(tab, ct, fetch, **kw)
        fin = torch.isfinite(pv)
        err5 = max(err5, float(torch.where(fin, (v - pv).abs(), 0.0).max()))
        assert torch.equal(i, pidx), f"K5 {name}: ids differ"
        assert torch.equal(v, pv), f"K5 {name}: values differ"
        assert torch.equal(i2, i) and torch.equal(v2, v), f"K5 {name}: a second run differs"
        hits = int((pidx >= 0).sum())
        log("kernels", f"K5 adc_scan_topk {name} Q={tab.shape[0]} n={ct.shape[1]}: "
            f"values and ids bit-identical ({hits} candidates), and on a second run")
    res.update(codes_t=codes_t, tables=tables, k5_err=err5, k5_tied=(tied_tab, tied_t))
    return res


def _recall(ids, gt):
    hits = (ids[:, :, None] == gt[:, None, :]).any(-1).float().sum(-1)
    return float((hits / gt.shape[1]).mean())


def _ground_truth(corpus, queries, k=10, chunk=100_000):
    import torch

    best_d = best_i = None
    qq = (queries * queries).sum(-1, keepdim=True)
    for c0 in range(0, corpus.shape[0], chunk):
        x = corpus[c0:c0 + chunk]
        d = qq + (x * x).sum(-1)[None] - 2.0 * torch.matmul(queries, x.T)
        i = torch.arange(c0, c0 + x.shape[0], device=x.device).expand_as(d)
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
        best_d, pos = torch.topk(d, k, dim=1, largest=False)
        best_i = torch.gather(i, 1, pos)
    return best_i


def _parity(got, want, name):
    import torch

    gi, gd = got
    wi, wd = want
    assert torch.equal(gd, wd), f"{name}: distances differ from the plain route"
    unique = (wd[:, :, None] == wd[:, None, :]).sum(-1) == 1
    assert torch.equal(torch.where(unique, gi.long(), -1), torch.where(unique, wi.long(), -1)), (
        f"{name}: ids differ from the plain route at unique distances")


def phase_main_path(corpus, queries):
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.models.pq import _merge_candidates
    from vq_tpu_torch.ops import cuda_kernels as ck

    kernels = (ck.pq_lloyd_accumulate_fused, ck.pq_encode_fused, ck.adc_scan_topk_fused)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = vq_tpu_torch.ProductQuantizer(corpus[:N_TRAIN], M, K, max_iters=10,
                                     device=corpus.device)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    index = vq_tpu_torch.PQIndex(pq, keep_corpus=True)
    t0 = time.perf_counter()
    index.add(corpus)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    ids, dist = index.search(queries, k=10)
    ids_r, dist_r = index.search(queries, k=10, rerank=100)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    log("main", f"launches in the main path: {launches}")
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"

    for name, (i, d) in (("search", (ids, dist)), ("search rerank=100", (ids_r, dist_r))):
        assert tuple(i.shape) == (N_QUERY, 10) and tuple(d.shape) == (N_QUERY, 10), name
        assert bool(torch.isfinite(d).all()), f"{name}: non-finite distances"
        assert bool(((i >= 0) & (i < N_CORPUS)).all()), f"{name}: ids out of range"
        assert bool((d[:, 1:] >= d[:, :-1]).all()), f"{name}: not ascending"

    codes_plain = ck.pq_encode_plain(corpus, pq.codebooks).to(torch.uint8)
    n_diff = int((codes_plain != index._codes).sum())
    assert n_diff == 0, f"{n_diff} codes of PQIndex.add differ from the plain encode"
    codes_t = index._codes.T.contiguous()
    tables = pq.adc_tables(queries)
    want = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 10), 10, True)
    _parity((ids, dist), want, "search")
    short = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 100), 100, True)[0]
    want_r = pq._rerank(queries, short, corpus, 10)
    _parity((ids_r, dist_r), want_r, "search rerank=100")

    gt = _ground_truth(corpus, queries)
    r_adc, r_rr = _recall(ids, gt), _recall(ids_r, gt)
    assert r_rr >= r_adc, (r_rr, r_adc)
    mse = float(((pq.decode(index._codes) - corpus) ** 2).mean())
    assert mse == mse and mse < float((corpus - corpus.mean(0)).square().mean()), mse
    log("main", f"trained {pq!r} in {t_train:.3f} s; add 1M in {t_add:.3f} s "
        f"(codes equal the plain encode); search and rerank=100 equal "
        f"the plain route; recall@10 ADC {r_adc:.4f}, rerank=100 {r_rr:.4f}; "
        f"reconstruction MSE of the 1M rows {mse:.9g} an element")
    return dict(pq=pq, index=index, t_train=t_train, t_add=t_add, launches=launches,
                recall=(r_adc, r_rr), gt=gt)


def phase_ivf_kernels(corpus, g):
    """K1 and K2 held to their plain versions at the IVF path's shapes."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cents = corpus[torch.randperm(N_CORPUS, generator=g, device=corpus.device)[:NLIST]]
    res = {"cents": cents, "k1_err": 0.0}
    for tag, x in (("f32", corpus), ("bf16", corpus.to(torch.bfloat16))):
        codes, dists = ck.assign_fused(x, cents)
        torch.cuda.synchronize()
        pc, pd = ck.assign_plain(x, cents)
        flips, gap = _near_ties(x.float(), cents, codes, pc)
        same = codes == pc
        err = float((dists - pd).abs()[same].max())
        assert err <= K1_DIST_RTOL * float(pd.abs().max()), f"K1 {tag}: distances off by {err}"
        res["k1_err"] = max(res["k1_err"], err)
        n_dist = int((dists.view(torch.int32) != pd.view(torch.int32)).sum())
        log("kernels", f"K1 assign {tag} {tuple(x.shape)} vs {NLIST} centroids: "
            f"{flips} of {codes.numel()} codes differ from the plain version, all float64 near "
            f"ties (max score gap {gap:.3g}); {n_dist} distances differ in their bits, max abs "
            f"err {err:.3g} where codes agree")
    x2 = corpus[:N_IVF_TRAIN]
    res["cents_rq"] = cents[:K]  # an RQ stage's k
    for tag, c in k2_shapes(res).items():
        got = ck.lloyd_accumulate_fused(x2, c)
        again = ck.lloyd_accumulate_fused(x2, c)
        torch.cuda.synchronize()
        want = ck.lloyd_accumulate_plain(x2, c)
        diffs = [int((a != b).sum()) for a, b in zip(got, want)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"K2 {tag}: {diffs} sums / counts / inertia differ from the plain version")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (
            f"K2 {tag} is not deterministic from run to run")
        assert int(got[1].sum()) == x2.shape[0]
        log("kernels", f"K2 lloyd_accumulate {tag}: sums, counts and inertia bit-identical to the "
            f"plain version and on a second run (clusters: largest {int(got[1].max())} rows, mean "
            f"{float(got[1].mean()):.1f}, empty {int((got[1] == 0).sum())})")
    res["k2_err"] = 0.0
    return res


def _check_search(name, ids, dist, descending=False):
    import torch

    assert tuple(ids.shape) == (N_QUERY, 10) and tuple(dist.shape) == (N_QUERY, 10), name
    assert bool(torch.isfinite(dist).all()), f"{name}: non-finite distances"
    assert bool(((ids >= 0) & (ids < N_CORPUS)).all()), f"{name}: ids out of range"
    lo, hi = (dist[:, 1:], dist[:, :-1]) if descending else (dist[:, :-1], dist[:, 1:])
    assert bool((hi >= lo).all()), f"{name}: not in order"


def phase_ivf_path(corpus, queries, gt):
    """IVFPQIndex train -> add -> search through the public entry points."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    index, t_train = cuda_once(lambda: vq_tpu_torch.IVFPQIndex.train(
        corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True))
    _, t_add = cuda_once(lambda: index.add(corpus))
    out, k7_by_nprobe = {}, {}
    for p in NPROBES:
        before = ck.ivf_probe_adc_fused.launches
        for r in RERANKS:
            out[(p, r)] = index.search(queries, k=10, nprobe=p, rerank=r)
        k7_by_nprobe[p] = ck.ivf_probe_adc_fused.launches - before
    torch.cuda.synchronize()
    launches = read_counts()
    log("ivf", f"launches in the ivf path: {launches}")
    on_path = ("assign_fused", "lloyd_accumulate_fused", "pq_lloyd_accumulate_fused",
               "pq_encode_fused", "ivf_probe_adc_fused")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    stats = index.bucket_stats()
    log("ivf", f"trained {index!r} in {t_train / 1e3:.4f} s, added {N_CORPUS} in {t_add / 1e3:.4f} s; "
        f"lists: min {stats['min']} mean {stats['mean']:.1f} max {stats['max']}, cap "
        f"{stats['cap']}, empty {stats['empty_lists']}")

    with plain_route():
        lists_p, _ = vq_tpu_torch.assign(corpus, index.coarse)
        lists = index._flat_lists
        flips, gap = _near_ties(corpus, index.coarse, lists, lists_p)
        enc_in = corpus - index.coarse[lists.long()]
        codes_p = index.pq.encode(enc_in)
        want = {key: index.search(queries, k=10, nprobe=key[0], rerank=key[1]) for key in out}
    codes = index._pool.to_flat()["codes"]
    n_codes = int((codes != codes_p).sum())
    assert n_codes == 0, f"{n_codes} residual codes differ from the plain encode"
    recall = {}
    for (p, r), (ids, dist) in out.items():
        name = f"ivf search nprobe={p} rerank={r}"
        _check_search(name, ids, dist)
        _parity((ids, dist), want[(p, r)], name)
        recall[(p, r)] = _recall(ids, gt)
    mse = float(((index.reconstruct(torch.arange(N_CORPUS, device=corpus.device)) - corpus) ** 2).mean())
    log("ivf", f"add: {flips} of {N_CORPUS} lists differ from the plain assign, all "
        f"float64 near ties (max gap {gap:.3g}); residual codes equal the plain encode; all "
        "searches equal the plain route; recall@10 " + ", ".join(
            f"nprobe={p} rerank={r}: {v:.4f}" for (p, r), v in recall.items())
        + f"; reconstruction MSE of the 1M rows {mse:.9g} an element")
    assert recall[(64, 500)] >= recall[(8, 0)], recall
    return dict(index=index, t_train=t_train, t_add=t_add, launches=launches, recall=recall,
                k7_by_nprobe=k7_by_nprobe)


def phase_k7(queries, ivf):
    """K7 held to its plain version over the built index's probed chains."""
    import torch

    from vq_tpu_torch.ivf import _probe_tables
    from vq_tpu_torch.ops import cuda_kernels as ck

    index = ivf["index"]
    pool = index._pool
    chains_s = pool.chains_search()
    cases = {}
    for p in NPROBES:
        probe, tables = _probe_tables(queries, index.coarse, index.pq.codebooks, p, True)
        args = (tables.reshape(N_QUERY * p, M, K), chains_s[probe].reshape(N_QUERY * p, -1),
                pool.data["codes"])
        got = ck.ivf_probe_adc_fused(*args, cap=pool.cap)
        torch.cuda.synchronize()
        want = ck.ivf_probe_adc_plain(*args, cap=pool.cap)
        assert torch.equal(got, want), f"K7 nprobe={p}: values differ from the plain version"
        cases[p] = args
        log("kernels", f"K7 ivf_probe_adc nprobe={p}: {args[0].shape[0]} (query, list) pairs x "
            f"{args[1].shape[1]} chunks of {pool.ch} rows (cap {pool.cap}): bit-identical")
    return cases


def phase_ivf_timings(smi, corpus, queries, kres, ivf, k7_cases):
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    cents, index = kres["cents"], ivf["index"]
    x2 = corpus[:N_IVF_TRAIN]
    t = {}
    k1_ms, k1_clock = clocked(lambda: cuda_ms(lambda: ck.assign_fused(corpus, cents), 5))
    t["K1"] = (k1_ms, cuda_ms(lambda: ck.assign_plain(corpus, cents), 1))
    xb = corpus.to(torch.bfloat16)
    k1b_ms, k1b_clock = clocked(lambda: cuda_ms(lambda: ck.assign_fused(xb, cents), 5))
    t["K1_bf16"] = (k1b_ms, None)
    log("time", f"K1 f32 timed at {k1_clock}; bf16 at {k1b_clock} | {smi}")
    for name, c in (("K2", cents), ("K2_rq_shape", kres["cents_rq"])):
        t[name] = (cuda_ms(lambda: ck.lloyd_accumulate_fused(x2, c), 10),
                   cuda_ms(lambda: ck.lloyd_accumulate_plain(x2, c), 2))
    cap = index._pool.cap
    for p, args in k7_cases.items():
        t[f"K7_nprobe{p}"] = (cuda_ms(lambda: ck.ivf_probe_adc_fused(*args, cap=cap), 20),
                              cuda_ms(lambda: ck.ivf_probe_adc_plain(*args, cap=cap), 3))
    for name, (ms, pms) in t.items():
        plain = "not measured" if pms is None else f"{pms:.4f} ms"
        log("time", f"{name}: kernel {ms:.4f} ms, plain {plain} | {smi}")
    sms, mhz = sm_rate()
    floor = 2.0 * N_CORPUS * NLIST * DIM / (sms * 128 * mhz * 1e6) * 1e3
    log("bound", f"K1's floor under its exact contract (a rounded multiply and a rounded add a "
        f"term, no FMA): 2 n k d = {2.0 * N_CORPUS * NLIST * DIM:.4g} FP32 instructions over "
        f"{sms} SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms; K1 f32 at {floor / t['K1'][0]:.3f} "
        f"of it, bf16 at {floor / t['K1_bf16'][0]:.3f} | {smi}")
    mm = cuda_ms(lambda: corpus @ cents.T, 5)
    log("time", f"cuBLAS fp32 corpus @ cents.T [{N_CORPUS}, {DIM}] x [{DIM}, {NLIST}], TF32 off "
        f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}): the product alone, with FMA, no "
        f"argmin; a yardstick for a tensor-core K1, not K1's library call: {mm:.4f} ms | {smi}")

    def add_fresh():
        fresh = vq_tpu_torch.IVFPQIndex(index.coarse, index.pq, keep_corpus=True)
        fresh.add(corpus)
        return fresh

    add_ms = cuda_once(add_fresh)[1]
    with plain_route():
        train_plain_ms = cuda_once(lambda: vq_tpu_torch.IVFPQIndex.train(
            corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True))[1]
        add_plain_ms = cuda_once(add_fresh)[1]
    log("time", f"IVF train 200k x 128, IVF{NLIST} + PQ 8x256, 10 iterations: "
        f"{ivf['t_train'] / 1e3:.4f} s (first call), plain route {train_plain_ms / 1e3:.4f} s | {smi}")
    log("time", f"IVF add 1M: {N_CORPUS / ivf['t_add'] * 1e3:.6g} vectors/s first call, "
        f"{N_CORPUS / add_ms * 1e3:.6g} vectors/s again; plain route "
        f"{N_CORPUS / add_plain_ms * 1e3:.6g} vectors/s | {smi}")
    search = {}
    for p in NPROBES:
        for r in RERANKS:
            ms = cuda_ms(lambda: index.search(queries, k=10, nprobe=p, rerank=r), 10)
            with plain_route():
                pms = cuda_ms(lambda: index.search(queries, k=10, nprobe=p, rerank=r), 3)
            search[(p, r)] = (ms, pms)
            log("time", f"IVF search 128 queries, nprobe={p} rerank={r}: {ms:.4f} ms per batch, "
                f"{N_QUERY / ms * 1e3:.6g} QPS; plain route {pms:.4f} ms, "
                f"{N_QUERY / pms * 1e3:.6g} QPS; recall@10 {ivf['recall'][(p, r)]:.4f} | {smi}")
    return t


def phase_k2_stages(smi, corpus, kres):
    """K2's stages at both of its shapes: a ``torch.profiler`` line of the
    device time a call of each kernel of ``vq_lloyd``, and the sums stage
    (the segment sums and their combine) beside its bytes bound and
    ``index_add_``: one PyTorch call that sums the rows by cluster, with
    float atomics whose order changes from run to run, a yardstick the
    port never calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    x2, reps = corpus[:N_IVF_TRAIN], 5
    cuda = torch.autograd.DeviceType.CUDA
    for tag, c in k2_shapes(kres).items():
        k, d = c.shape
        ck.lloyd_accumulate_fused(x2, c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.lloyd_accumulate_fused(x2, c)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == cuda]
        stages = stage_times(evts, calls=reps)
        total = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        log("profile", f"K2 {tag}, device ms a call by stage: " + ", ".join(
            f"{s} {ms:.4f}" + (f" x{n:g}" if n != 1 else "") for s, (ms, n) in stages.items())
            + f"; all device activity {total:.4f} ms | {smi}")
        idx = ck.assign_fused(x2, c)[0].long()
        lib = cuda_ms(lambda: torch.zeros(k, d, device=x2.device).index_add_(0, idx, x2), 20)
        b_ms, b_by = bound(x2.numel() * 4 + x2.shape[0] * 4 + k * d * 4, 1.0 * x2.numel(), PEAK_F32)
        if "sums" in stages and "combine" in stages:
            sums_ms = stages["sums"][0] + stages["combine"][0]
            stage = f"segment sums + combine {sums_ms:.4f} ms, {b_ms / sums_ms:.3f} of it"
        else:  # the profiler dropped the call's kernels
            stage = "segment sums + combine not measured"
        log("bound", f"K2 sums stage {tag}: x read once, the row ids read and the sums written "
            f"once, {b_ms:.4f} ms ({b_by}); {stage}; index_add_ (float atomics, the yardstick) "
            f"{lib:.4f} ms | {smi}")


def phase_k3_stages(smi, corpus, res):
    """K3 at 100k (PQ training) and 200k rows (IVF-PQ training) against
    the 8x256x16 codebooks: a ``torch.profiler`` line a shape of the device
    time a call of each of its launches (K4's scan, the labels and inertia
    partials, K2's sums stage, the inertia sum), and its sums stage (all
    but the scan) beside its bytes bound and ``index_add_`` of the same
    entries by the same labels (float atomics, a yardstick the port never
    calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, reps = res["cb"], 5
    s = DIM // M
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for n in (N_TRAIN, N_IVF_TRAIN):
        x = corpus[:n]
        ck.pq_lloyd_accumulate_fused(x, cb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.pq_lloyd_accumulate_fused(x, cb)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == cuda]
        stages = stage_times(evts, K3_STAGES, reps)
        total = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        log("profile", f"K3 {n} x {DIM} vs {M}x{K}x{s}, device ms a call by launch: " + ", ".join(
            f"{st} {ms:.4f}" + (f" x{c:g}" if c != 1 else "") for st, (ms, c) in stages.items())
            + f"; all device activity {total:.4f} ms | {smi}")
        labels = (ck.pq_encode_fused(x, cb).long() + torch.arange(M, device=x.device) * K).reshape(-1)
        xe = x.reshape(-1, s)
        lib = cuda_ms(lambda: torch.zeros(M * K, s, device=x.device).index_add_(0, labels, xe), 20)
        b_ms, b_by = bound(xe.numel() * 4 + 2 * labels.numel() * 4 + M * K * (s + 1) * 4 + 4,
                           2.0 * xe.numel(), PEAK_F32)
        if "pq scan" in stages and len(stages) > 2:
            stage_ms = sum(ms for st, (ms, _) in stages.items() if st != "pq scan")
            stage = f"sums stage (all but the scan) {stage_ms:.4f} ms, {b_ms / stage_ms:.3f} of it"
        else:  # the profiler dropped the call's kernels
            stage_ms, stage = None, "sums stage not measured"
        log("bound", f"K3 sums stage {n} x {M}x{K}x{s}: x, the codes and the minimum scores read "
            f"once, the sums, counts and inertia written once, {b_ms:.4f} ms ({b_by}); {stage}; "
            f"index_add_ of the {xe.shape[0]} entries by label (float atomics, the yardstick) "
            f"{lib:.4f} ms | {smi}")
        out[n] = dict(stage_ms=stage_ms, bound_ms=b_ms, index_add_ms=lib)
    return out


def phase_flat_path(corpus, queries, gt):
    """IVF-Flat and IVF-SQ train -> add -> search through the public entry
    points, with K6's operands recorded from each search."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    train = corpus[:N_IVF_TRAIN]
    flat, t_train = cuda_once(lambda: vq_tpu_torch.IVFFlatIndex.train(train, NLIST, max_iters=10))
    sq, t_train_sq = cuda_once(lambda: vq_tpu_torch.IVFSQIndex.train(train, NLIST, max_iters=10))
    trained = read_counts()
    assert trained["assign_fused"] > 0 and trained["lloyd_accumulate_fused"] > 0, trained
    indexes = {"flat_f32": flat, "sq": sq,
               "flat_bf16": vq_tpu_torch.IVFFlatIndex(flat.coarse, store_dtype="bfloat16"),
               "flat_dot": vq_tpu_torch.IVFFlatIndex(flat.coarse, metric="dot")}
    t_add = {}
    for name, idx in indexes.items():
        before = ck.assign_fused.launches
        t_add[name] = cuda_once(lambda: idx.add(corpus))[1]
        assert ck.assign_fused.launches > before, f"{name}: add launched no K1"
    searches = [(name, p) for name in FLAT_KINDS for p in NPROBES] + [("flat_dot", NPROBES[0])]
    out, operands = {}, {}
    for key in searches:
        before = ck.ivf_probe_matvec_fused.launches
        with recording("vq_tpu_torch.ivf_flat", "ivf_probe_matvec_fused") as calls:
            out[key] = indexes[key[0]].search(queries, k=10, nprobe=key[1])
        assert ck.ivf_probe_matvec_fused.launches == before + 1, f"{key}: K6 did not launch"
        operands[key] = calls[0]
    torch.cuda.synchronize()
    launches = read_counts()
    log("flat", f"launches in the ivf-flat path: {launches} (training alone: K1 "
        f"{trained['assign_fused']}, K2 {trained['lloyd_accumulate_fused']})")
    for name, idx in indexes.items():
        st = idx.bucket_stats()
        log("flat", f"{idx!r}: add 1M {t_add[name] / 1e3:.4f} s; lists min {st['min']} mean "
            f"{st['mean']:.1f} max {st['max']}, cap {st['cap']}")

    with plain_route():
        want = {key: indexes[key[0]].search(queries, k=10, nprobe=key[1]) for key in searches}
    recall = {}
    for key, (ids, dist) in out.items():
        name = f"{key[0]} search nprobe={key[1]}"
        _check_search(name, ids, dist, descending=key[0] == "flat_dot")
        _parity((ids, dist), want[key], name)
        recall[key] = _recall(ids, gt)
    log("flat", f"trained IVF-Flat in {t_train / 1e3:.4f} s and IVF-SQ in {t_train_sq / 1e3:.4f} s; "
        "every search equals the plain route; recall@10 " + ", ".join(
            f"{n} nprobe={p}: {v:.4f}" for (n, p), v in recall.items()))
    assert recall[("flat_f32", NPROBES[-1])] >= FLAT_MIN_RECALL, recall
    return dict(indexes=indexes, operands=operands, launches=launches, recall=recall,
                t_train=t_train, t_train_sq=t_train_sq, t_add=t_add, searches=searches)


def k6_bound(args, kw):
    """``(ms, by, note, instructions)``: K6's bound on one call's
    operands. Bytes: the rows of each chunk the probe table names (once,
    however many pairs probe it), the output, the left vectors and the
    table; operations: a multiply and an add a live (pair, row,
    dimension), over the fp32 peak. The last is that count of FP32
    instructions, K6's floor under its no-FMA contract."""
    import torch

    lhs, chains, payload = args
    (n_chunks, ch, d), cap = payload.shape, kw["cap"]
    width = chains.shape[1] * ch
    valid = chains[(chains >= 0) & (chains < n_chunks)]
    chunks = torch.unique(valid).numel()
    pos = torch.arange(width, device=chains.device)
    live = int((((chains >= 0) & (chains < n_chunks)).repeat_interleave(ch, dim=1) & (pos < cap)).sum())
    rows = chunks * ch * d * payload.element_size()
    out = lhs.shape[0] * width * 4
    ms, by = bound(rows + out + lhs.numel() * 4 + chains.numel() * 4, 2.0 * live * d, PEAK_F32)
    return ms, by, (f"{chunks} chunks x {ch} rows x {d} x {payload.element_size()} B "
                    f"= {rows / 1e6:.1f} MB read once, {out / 1e6:.1f} MB written, {live} live "
                    f"positions"), 2.0 * live * d


def phase_k6(flat):
    """K6 held to its plain version on the operands each of the seven
    searches gave it, with its work list held to the plain version's."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cases, err = {}, 0.0
    for key in flat["searches"]:
        args, kw = flat["operands"][key]
        got = ck.ivf_probe_matvec_fused(*args, **kw)
        torch.cuda.synchronize()
        want = ck.ivf_probe_matvec_plain(*args, **kw)
        err = max(err, float((got - want).abs().max()))
        assert torch.equal(got, want), f"K6 {key}: values differ from the plain version"
        lhs, chains, payload = args
        plan = ck.ivf_matvec_work_list(chains, payload.shape[0], payload.shape[1], kw["cap"])
        plain = ck.ivf_matvec_work_list_plain(chains, payload.shape[0], payload.shape[1], kw["cap"])
        assert all(torch.equal(a, b) for a, b in zip(plan, plain)), f"K6 {key}: work list differs"
        cases[key] = (args, kw, k6_bound(args, kw))
        per = (plan[0][1:] - plan[0][:-1]).long()
        per = per[per > 0]
        log("kernels", f"K6 ivf_probe_matvec {str(payload.dtype)[6:]} ({key[0]}) nprobe={key[1]}: "
            f"{lhs.shape[0]} (query, list) pairs x {chains.shape[1]} chunks of {payload.shape[1]} "
            f"rows x d {lhs.shape[1]} (cap {kw['cap']}), {plan[1].numel()} live (pair, chunk) "
            f"entries over {per.numel()} chunks (median {int(per.median())}, most "
            f"{int(per.max())} a chunk; {int(((per + 31) // 32).sum())} tasks of <= 32); "
            f"{cases[key][2][2]}: bit-identical, work list as the plain version's")
    return cases, err


def phase_flat_timings(smi, queries, flat, k6_cases):
    from vq_tpu_torch.ops import cuda_kernels as ck

    import torch
    from torch.profiler import ProfilerActivity, profile

    t, reps = {}, 5
    cuda = torch.autograd.DeviceType.CUDA
    sms, mhz = sm_rate()
    for (name, p), (args, kw, (b_ms, b_by, note, instr)) in k6_cases.items():
        tag = f"K6 {str(args[2].dtype)[6:]} ({name}) nprobe={p}"
        ms = cuda_ms(lambda: ck.ivf_probe_matvec_fused(*args, **kw), 20)
        pms = cuda_ms(lambda: ck.ivf_probe_matvec_plain(*args, **kw), 2)
        t[f"K6_{name}_nprobe{p}"] = (ms, pms)
        log("time", f"{tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms | {smi}")
        floor = instr / (sms * 128 * mhz * 1e6) * 1e3
        log("bound", f"{tag}: {ms:.4f} ms against a bound of {b_ms:.4f} ms ({b_by}: {note}), "
            f"{b_ms / ms:.3f} of it; floor under its no-FMA contract {instr:.4g} FP32 instructions "
            f"over {sms} SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms, {floor / ms:.3f} of it "
            f"| {smi}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.ivf_probe_matvec_fused(*args, **kw)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == cuda]
        stages = stage_times(evts, K6_STAGES, reps)
        kernels = [e.time_range for e in prof.events() if e.device_type == cuda]
        busy = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        span = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3 / reps
        # The host's side: the wrapper's calls queued back to back, then the
        # wait for the card; a queueing time above the device's busy time
        # means the host, not the kernels, sets the pace.
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(20):
            ck.ivf_probe_matvec_fused(*args, **kw)
        h1 = time.perf_counter()
        torch.cuda.synchronize()
        h2 = time.perf_counter()
        log("profile", f"{tag}, device ms a call by launch: " + ", ".join(
            f"{s} {v:.4f}" for s, (v, c) in stages.items())
            + f"; all device activity {busy:.4f}, first start to last end {span:.4f} ms a call; "
            f"host: {(h1 - h0) * 50:.4f} ms a call to queue, {(h2 - h0) * 50:.4f} to finish, "
            f"CUDA events again {cuda_ms(lambda: ck.ivf_probe_matvec_fused(*args, **kw), 20):.4f} "
            f"| {smi}")
    log("time", f"IVF-Flat train 200k x 128, IVF{NLIST}, 10 iterations: {flat['t_train'] / 1e3:.4f} s; "
        f"IVF-SQ train {flat['t_train_sq'] / 1e3:.4f} s (first calls) | {smi}")
    for name, ms in flat["t_add"].items():
        log("time", f"{name} add 1M: {N_CORPUS / ms * 1e3:.6g} vectors/s (first call) | {smi}")
    for name, p in flat["searches"]:
        idx = flat["indexes"][name]
        ms = cuda_ms(lambda: idx.search(queries, k=10, nprobe=p), 10)
        with plain_route():
            pms = cuda_ms(lambda: idx.search(queries, k=10, nprobe=p), 2)
        log("time", f"{name} search 128 queries, nprobe={p}: {ms:.4f} ms per batch, "
            f"{N_QUERY / ms * 1e3:.6g} QPS; plain route {pms:.4f} ms, "
            f"{N_QUERY / pms * 1e3:.6g} QPS; recall@10 {flat['recall'][(name, p)]:.4f} | {smi}")
    return t


def phase_timings(smi, corpus, queries, res, main):
    import torch

    from vq_tpu_torch.models.pq import _merge_candidates
    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, pq, index = res["cb"], main["pq"], main["index"]
    x3 = corpus[:N_TRAIN]
    t = {}
    t["K3"] = (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3, cb), 10),
               cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3, cb), 3))
    x3_ivf = corpus[:N_IVF_TRAIN]  # IVFPQIndex.train's K3 rows
    t["K3_200k"] = (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3_ivf, cb), 10),
                    cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3_ivf, cb), 2))
    t["K4"] = (cuda_ms(lambda: ck.pq_encode_fused(corpus, cb), 5),
               cuda_ms(lambda: ck.pq_encode_plain(corpus, cb), 2))
    tab, ct = res["tables"], res["codes_t"]
    t["K5"] = (cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, 10), 10),
               cuda_ms(lambda: ck.adc_scan_topk_plain(tab, ct, 10), 3))
    t["K5_fetch100"] = (cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, 100), 10),
                        cuda_ms(lambda: ck.adc_scan_topk_plain(tab, ct, 100), 3))
    codes_t = index._codes.T.contiguous()
    search_ms = cuda_ms(lambda: index.search(queries, k=10), 10)
    search_plain_ms = cuda_ms(lambda: _merge_candidates(
        *ck.adc_scan_topk_plain(pq.adc_tables(queries), codes_t, 10), 10, True), 3)
    rerank_ms = cuda_ms(lambda: index.search(queries, k=10, rerank=100), 10)
    for name, (ms, pms) in t.items():
        log("time", f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms | {smi}")
    # K5 keeps F = 32, 64 or 128 words a warp (the power of two >= fetch,
    # at least 32): its time at each width's edges, and on tie-heavy data.
    widths = {f: cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, f), 10) for f in (1, 32, 33, 64, 65, 128)}
    tied = {f: cuda_ms(lambda: ck.adc_scan_topk_fused(*res["k5_tied"], f), 10) for f in (10, 100)}
    log("time", "K5 by fetch: " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in widths.items())
        + "; tie-heavy " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in tied.items()) + f" | {smi}")
    sms, mhz = sm_rate()
    lookups = float(tab.shape[0]) * ct.shape[1] * ct.shape[0]
    floor = lookups / (sms * 32 * mhz * 1e6) * 1e3
    log("bound", f"K5's shared-memory lookup floor: Q n m = {lookups:.4g} 4-byte table lookups at "
        f"32 a clock an SM, {sms} SMs x {mhz:.0f} MHz = {floor:.4f} ms; K5 at "
        f"{floor / t['K5'][0]:.3f} of it (fetch 10), {floor / t['K5_fetch100'][0]:.3f} (fetch 100) "
        f"| {smi}")
    s = DIM // M
    for name, n in (("K4", N_CORPUS), ("K3", N_TRAIN), ("K3_200k", N_IVF_TRAIN)):
        instr = 2.0 * n * M * K * s
        floor = instr / (sms * 128 * mhz * 1e6) * 1e3
        log("bound", f"{name}'s floor under its exact contract (a rounded multiply and a rounded "
            f"add a term, no FMA): 2 n m k s = {instr:.4g} FP32 instructions at n = {n} over {sms} "
            f"SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms; {name} at {floor / t[name][0]:.3f} "
            f"of it | {smi}")
    log("time", f"PQ train 100k x 128, 8x256, 10 iterations: {main['t_train']:.4f} s, "
        f"{main['t_train'] / 10:.5f} s per Lloyd iteration (host clock) | {smi}")
    log("time", f"encode 1M x 128: kernel {N_CORPUS / t['K4'][0] * 1e3:.6g} vectors/s, plain "
        f"{N_CORPUS / t['K4'][1] * 1e3:.6g} vectors/s; PQIndex.add 1M {main['t_add']:.4f} s "
        f"(host clock, first call) | {smi}")
    log("time", f"search 128 queries over 1M, k=10: {search_ms:.4f} ms per batch, "
        f"{N_QUERY / search_ms * 1e3:.6g} QPS; plain route {search_plain_ms:.4f} ms, "
        f"{N_QUERY / search_plain_ms * 1e3:.6g} QPS; rerank=100 {rerank_ms:.4f} ms | {smi}")
    return t


def phase_lowp_kernels(corpus, res):
    """K4-bf16 and K4-bf16x3 (bf16 products on the tensor cores) held to
    their plain versions by the near-tie rule (``cuda_kernels.
    encode_parity``: at least MIN_MATCH of the codes equal, every other one
    a float64 near tie) at the main path's shapes with f32 and bf16 input,
    and bit for bit on small-integer operands (every partial sum exact) at
    the same shapes. Returns the largest float64 score gap a precision."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, exact = res["cb"], res["codes_t"].T
    gaps = {}
    for precision in ("bf16_fast", "bf16x3"):
        for tag, x in (("f32", corpus), ("bf16", corpus.to(torch.bfloat16))):
            got = ck.pq_encode_fused(x, cb, precision=precision)
            torch.cuda.synchronize()
            par = ck.encode_parity(x, cb, got, precision)
            assert par.ok, (
                f"K4 {precision} {tag}: {par.match} of the codes equal the plain version's (at least "
                f"{ck.MIN_MATCH}); {par.flips} differ, max float64 gap {par.max_gap}")
            gaps[precision] = max(gaps.get(precision, 0.0), par.max_gap)
            match = float((got.to(torch.uint8) == exact).float().mean())
            log("kernels", f"K4 pq_encode precision={precision} {tag} {tuple(x.shape)} vs 8x256x16: "
                f"{par.match:.7f} of the codes equal the plain version's, {par.flips} differ, all "
                f"float64 near ties (max gap {par.max_gap:.3g}); {match:.6f} equal the exact f32 "
                "encode's")
    g = torch.Generator(device=corpus.device).manual_seed(SEED)
    xi = torch.randint(-4, 5, tuple(corpus.shape), generator=g, device=corpus.device).float()
    cbi = torch.randint(-4, 5, tuple(cb.shape), generator=g, device=corpus.device).float()
    for precision in ("bf16_fast", "bf16x3"):
        for tag, x in (("f32", xi), ("bf16", xi.to(torch.bfloat16))):
            got = ck.pq_encode_fused(x, cbi, precision=precision)
            torch.cuda.synchronize()
            want = ck.pq_encode_plain(x, cbi, precision)
            assert torch.equal(got, want), (
                f"K4 {precision} {tag} on integers: {int((got != want).sum())} codes differ")
    log("kernels", f"K4-bf16 and K4-bf16x3 on integer operands in [-4, 4] {tuple(xi.shape)} vs "
        "8x256x16, f32 and bf16 x: bit-identical to their plain versions")
    return gaps


def phase_precision(corpus, queries, main):
    """The encode precision ladder and ADC distances through the public
    entry points, on the main phase's quantizer."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    pq, exact = main["pq"], main["index"]
    reset_counts()
    indexes, t_add = {}, {}
    for precision in ("high", "default"):
        indexes[precision] = vq_tpu_torch.PQIndex(pq)
        t_add[precision] = cuda_once(lambda: indexes[precision].add(corpus, precision=precision))[1]
    with recording("vq_tpu_torch.models.pq", "adc_lookup_fused") as k8_calls:
        dists, t_dist = cuda_once(lambda: pq.adc_distances(queries, exact._codes))
    out = {p: idx.search(queries, k=10) for p, idx in indexes.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    log("precision", f"launches in the precision path: {launches}")
    assert launches["pq_encode_fused[bf16x3]"] == 1 and launches["pq_encode_fused[bf16_fast]"] == 1, launches
    assert launches["adc_lookup_fused"] >= 1, launches
    assert tuple(dists.shape) == (N_QUERY, N_CORPUS) and bool(torch.isfinite(dists).all())

    with plain_route():
        codes_p = {p: pq.encode(corpus, precision=p) for p in indexes}
        dists_p = pq.adc_distances(queries, exact._codes)
        want = {p: idx.search(queries, k=10) for p, idx in indexes.items()}
    assert torch.equal(dists, dists_p), "adc_distances differ from the plain route"
    recall = {"highest": main["recall"][0]}
    for p, idx in indexes.items():
        kernel = {"high": "bf16x3", "default": "bf16_fast"}[p]
        par = ck.encode_parity(corpus, pq.codebooks, idx._codes, kernel, want=codes_p[p])
        assert par.ok, f"precision={p}: codes against the plain route: {par}"
        log("precision", f"PQIndex.add(precision={p!r}) codes: {par.match:.7f} equal the plain "
            f"route's, {par.flips} differ, all float64 near ties (max gap {par.max_gap:.3g}); the "
            "search below runs on the index's own codes in both routes")
        _check_search(f"precision={p} search", *out[p])
        _parity(out[p], want[p], f"precision={p} search")
        recall[p] = _recall(out[p][0], main["gt"])
        match = float((idx._codes == exact._codes).float().mean())
        log("precision", f"PQIndex.add(precision={p!r}) of 1M: {t_add[p]:.4f} ms, search equal "
            f"to the plain route's; {match:.6f} of the codes equal the exact encode's; "
            f"recall@10 {recall[p]:.4f} (exact index {recall['highest']:.4f})")
    args, _ = k8_calls[0]
    got = ck.adc_lookup_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.adc_lookup_plain(*args)), "K8: values differ from the plain version"
    log("kernels", f"K8 adc_lookup tables {tuple(args[0].shape)} x codes {tuple(args[1].shape)} "
        f"{str(args[1].dtype)[6:]} (adc_distances' operands): bit-identical")
    log("precision", f"ProductQuantizer.adc_distances [128, 1M]: {t_dist:.4f} ms (first call), "
        "equal to the plain route")
    return dict(launches=launches, t_add=t_add, t_dist=t_dist, recall=recall, k8_args=args,
                indexes=indexes, pq=pq, codes=exact._codes)


def _rq_near_ties(x, cbs, got, want):
    """Rows whose stage codes differ must be float64 near ties at the first
    stage they differ: the two prefixes' squared residuals within
    ``TIE_RTOL`` of ``||x||^2 + 1``. Returns ``(rows, max gap)``."""
    import torch

    from vq_tpu_torch.benchmarks.mpacked_encode import TIE_RTOL

    rows = torch.nonzero((got != want).any(1))[:, 0]
    if rows.numel() == 0:
        return 0, 0.0
    g, w = got[rows].long(), want[rows].long()
    first = (g != w).int().argmax(1)
    stage = torch.arange(cbs.shape[0], device=x.device)
    upto = (stage[None, :] <= first[:, None]).double()[..., None]
    xd, cd = x[rows].double(), cbs.double()
    cost_g = ((xd - (cd[stage[None, :], g] * upto).sum(1)) ** 2).sum(-1)
    cost_w = ((xd - (cd[stage[None, :], w] * upto).sum(1)) ** 2).sum(-1)
    gap = (cost_g - cost_w).abs()
    ties = gap <= TIE_RTOL * ((xd * xd).sum(-1) + 1.0)
    assert bool(ties.all()), f"{int((~ties).sum())} differing RQ codes are not near ties"
    return rows.numel(), float(gap.max())


def phase_rq_path(corpus, queries, gt):
    """ResidualQuantizer, RQIndex and IVFRQIndex train -> add -> search
    through the public entry points."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    train = corpus[:N_IVF_TRAIN]
    rq, t_train = cuda_once(lambda: vq_tpu_torch.ResidualQuantizer(
        train, RQ_STAGES, K, max_iters=RQ_ITERS, seed=1))
    trained = read_counts()
    indexes = {"l2": vq_tpu_torch.RQIndex(rq, keep_corpus=True),
               "cosine": vq_tpu_torch.RQIndex(rq, metric="cosine"),
               "dot": vq_tpu_torch.RQIndex(rq, metric="dot")}
    t_add = {name: cuda_once(lambda: idx.add(corpus))[1] for name, idx in indexes.items()}
    ivf, t_ivf_train = cuda_once(lambda: vq_tpu_torch.IVFRQIndex.train(
        train, NLIST, RQ_STAGES, K, max_iters=RQ_ITERS))
    t_ivf_add = cuda_once(lambda: ivf.add(corpus))[1]
    searches = {"rq": (indexes["l2"], dict(k=10)),
                f"rq rerank={RQ_RERANK}": (indexes["l2"], dict(k=10, rerank=RQ_RERANK)),
                "rq cosine": (indexes["cosine"], dict(k=10)), "rq dot": (indexes["dot"], dict(k=10))}
    searches.update({f"ivfrq nprobe={p}": (ivf, dict(k=10, nprobe=p)) for p in NPROBES})
    out, per_search = {}, {}
    with recording("vq_tpu_torch.models.pq", "adc_lookup_fused") as k8_calls:
        for name, (idx, kw) in searches.items():
            before = read_counts()
            out[name] = idx.search(queries, **kw)
            after = read_counts()
            per_search[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    torch.cuda.synchronize()
    launches = read_counts()
    log("rq", f"launches in the rq path: {launches} (training alone: K1 {trained['assign_fused']}, "
        f"K2 {trained['lloyd_accumulate_fused']}); by search: {per_search}")
    on_path = ("assign_fused", "lloyd_accumulate_fused", "adc_scan_topk_fused",
               "ivf_probe_adc_fused", "adc_lookup_fused")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    assert per_search[f"rq rerank={RQ_RERANK}"].get("adc_lookup_fused") == -(-N_CORPUS // RQ_CHUNK)
    assert per_search["rq"].get("adc_scan_topk_fused") == 1 and per_search["rq dot"].get(
        "adc_scan_topk_fused") == 1, per_search

    with plain_route():
        codes_p = rq.encode(corpus)
        lists_p, _ = vq_tpu_torch.assign(corpus, ivf.coarse)
        want = {name: idx.search(queries, **kw) for name, (idx, kw) in searches.items()}
    n_codes, gap_codes = _rq_near_ties(corpus, rq.codebooks, indexes["l2"]._codes, codes_p)
    lists = ivf._flat_lists
    flips, gap_lists = _near_ties(corpus, ivf.coarse, lists, lists_p)
    recall = {}
    for name, (ids, dist) in out.items():
        _check_search(name, ids, dist, descending=name == "rq dot")
        _parity((ids, dist), want[name], name)
        recall[name] = _recall(ids, gt)
    log("rq", f"trained {rq!r} in {t_train / 1e3:.4f} s; RQIndex add 1M {t_add['l2']:.4f} ms; "
        f"{n_codes} of {N_CORPUS} rows' codes differ from the plain encode, all float64 near ties "
        f"(max gap {gap_codes:.3g}); IVF-RQ trained in {t_ivf_train / 1e3:.4f} s, add 1M "
        f"{t_ivf_add:.4f} ms, {flips} lists differ from the plain assign, all near ties "
        f"(max gap {gap_lists:.3g}); every search equals the plain route; recall@10 " + ", ".join(
            f"{n}: {v:.4f}" for n, v in recall.items()))
    assert recall[f"rq rerank={RQ_RERANK}"] >= recall["rq"], recall
    assert recall[f"ivfrq nprobe={NPROBES[-1]}"] >= recall[f"ivfrq nprobe={NPROBES[0]}"] - 0.01, recall

    args, _ = k8_calls[0]
    got = ck.adc_lookup_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.adc_lookup_plain(*args)), "K8 (RQ chunk): values differ"
    log("kernels", f"K8 adc_lookup tables {tuple(args[0].shape)} x codes {tuple(args[1].shape)} "
        f"{str(args[1].dtype)[6:]} (one chunk of the RQ scan): bit-identical")
    return dict(rq=rq, indexes=indexes, ivf=ivf, searches=searches, launches=launches,
                recall=recall, t_train=t_train, t_add=t_add, t_ivf_train=t_ivf_train,
                t_ivf_add=t_ivf_add, k8_args=args)


def phase_new_timings(smi, corpus, queries, res, prec, rqres):
    """K4-bf16, K4-bf16x3 and K8 (with the library call) timed, and the
    precision and RQ paths' searches beside their plain routes."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, t = res["cb"], {}
    xb = corpus.to(torch.bfloat16)
    for p, name in (("bf16_fast", "K4_bf16"), ("bf16x3", "K4_bf16x3")):
        t[name] = (cuda_ms(lambda: ck.pq_encode_fused(corpus, cb, precision=p), 5),
                   cuda_ms(lambda: ck.pq_encode_plain(corpus, cb, p), 1), None)
    t["K4_bf16_bf16in"] = (cuda_ms(lambda: ck.pq_encode_fused(xb, cb, precision="bf16_fast"), 5),
                           None, None)
    for name, (tables, codes) in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"])):
        q, m, k = tables.shape
        weight = tables.permute(1, 2, 0).reshape(m * k, q).contiguous()
        index = (codes.long() + torch.arange(m, device=codes.device) * k).contiguous()
        lib = torch.nn.functional.embedding_bag(index, weight, mode="sum")
        err = float((lib.T - ck.adc_lookup_fused(tables, codes)).abs().max())
        t[name] = (cuda_ms(lambda: ck.adc_lookup_fused(tables, codes), 20),
                   cuda_ms(lambda: ck.adc_lookup_plain(tables, codes), 3),
                   cuda_ms(lambda: torch.nn.functional.embedding_bag(index, weight, mode="sum"), 20))
        log("time", f"{name}: embedding_bag (the library yardstick, [n, Q]) differs from K8 by at "
            f"most {err:.3g} (summation order) | {smi}")
    for name, (ms, pms, lms) in t.items():
        plain = "not measured" if pms is None else f"{pms:.4f} ms"
        lib = "" if lms is None else f", library call {lms:.4f} ms"
        log("time", f"{name}: kernel {ms:.4f} ms, plain {plain}{lib} | {smi}")
    k8 = {name: k8_floors(smi, name, *args, t[name][0])
          for name, args in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"]))}
    pq, codes = prec["pq"], prec["codes"]
    ms = cuda_ms(lambda: pq.adc_distances(queries, codes), 10)
    with plain_route():
        pms = cuda_ms(lambda: pq.adc_distances(queries, codes), 2)
    log("time", f"ProductQuantizer.adc_distances [128, 1M]: {ms:.4f} ms, plain route {pms:.4f} ms "
        f"| {smi}")
    for p, ms in prec["t_add"].items():
        log("time", f"PQIndex.add(precision={p!r}) 1M: {N_CORPUS / ms * 1e3:.6g} vectors/s "
            f"(first call) | {smi}")
    log("time", f"RQ train 200k x 128, 8x256, {RQ_ITERS} iterations a stage: "
        f"{rqres['t_train'] / 1e3:.4f} s; IVF-RQ train (IVF{NLIST} + RQ 8x256) "
        f"{rqres['t_ivf_train'] / 1e3:.4f} s (first calls) | {smi}")
    log("time", f"RQIndex add 1M: {N_CORPUS / rqres['t_add']['l2'] * 1e3:.6g} vectors/s; IVF-RQ add "
        f"1M: {N_CORPUS / rqres['t_ivf_add'] * 1e3:.6g} vectors/s (first calls) | {smi}")
    for name, (idx, kw) in rqres["searches"].items():
        ms = cuda_ms(lambda: idx.search(queries, **kw), 5)
        with plain_route():
            pms = cuda_ms(lambda: idx.search(queries, **kw), 2)
        log("time", f"{name} search 128 queries: {ms:.4f} ms per batch, {N_QUERY / ms * 1e3:.6g} QPS; "
            f"plain route {pms:.4f} ms; recall@10 {rqres['recall'][name]:.4f} | {smi}")
    return t, k8


def k8_wavefronts(codes, k: int) -> float:
    """Shared-memory wavefronts a quad's lookups take in K8 on ``codes
    [n, m]`` (16-byte entries, 4 rows a thread): a 16-byte load of a
    warp runs as 4 phases of 8 lanes, and a phase takes as many
    wavefronts as the most distinct entries that share one of the 8
    16-byte slots of a 128-byte row of banks (one entry read by several
    lanes is broadcast). Counted over this run's codes, whole warps of 128
    rows."""
    import torch

    n, m = codes.shape
    c = codes[:n // 128 * 128].long().view(-1, 4, 8, 4, m)  # warp, phase, lane, row, subspace
    c = c.permute(0, 1, 3, 4, 2).reshape(-1, 8)  # the 8 codes of one phase
    kp = k if codes.dtype == torch.uint8 and k >= 256 else k + 1  # csrc/adc_lookup.cu's kp
    sub = torch.arange(m, device=c.device).repeat(c.shape[0] // m)[:, None]
    entry = (c + sub * kp).sort(1).values
    distinct = torch.ones_like(entry)
    distinct[:, 1:] = (entry[:, 1:] != entry[:, :-1]).long()
    per_slot = torch.zeros_like(entry).scatter_add_(1, entry % 8, distinct)
    return float(per_slot.amax(1).sum()) * n / (n // 128 * 128)


def k8_floors(smi, name, tables, codes, ms):
    """K8 on codes that cost one shared-memory wavefront a phase, beside
    its 4-byte lookup floor (Q n m lookups at 32 a clock an SM) and the
    floor of its 16-byte design on this run's codes, on the same tables."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    q, m, k = tables.shape
    n = codes.shape[0]
    # The same tables over codes that cost one wavefront a phase: 8 lanes'
    # codes in 8 distinct slots, or all one code (broadcast).
    g = torch.Generator(device=codes.device).manual_seed(SEED)
    lanes = (torch.arange(n, device=codes.device) // 4 % 8)[:, None]
    spread = (lanes + 8 * torch.randint(0, k // 8, (n, m), generator=g, device=codes.device))
    calm = {"no bank conflicts": spread.to(codes.dtype), "one code": torch.zeros_like(codes)}
    calm_ms = {c: cuda_ms(lambda: ck.adc_lookup_fused(tables, v), 20) for c, v in calm.items()}
    log("time", f"{name} on codes that take one wavefront a phase: " + ", ".join(
        f"{c} {v:.4f} ms" for c, v in calm_ms.items()) + f"; on this run's codes {ms:.4f} ms | {smi}")
    sms, mhz = sm_rate()
    lookups = float(q) * n * m
    floor4 = lookups / (sms * 32 * mhz * 1e6) * 1e3
    waves = k8_wavefronts(codes, k) * -(-q // 4)
    floor16 = waves / (sms * mhz * 1e6) * 1e3
    log("bound", f"{name}'s shared-memory lookup floor: Q n m = {lookups:.4g} 4-byte table lookups "
        f"at 32 a clock an SM, {sms} SMs x {mhz:.0f} MHz = {floor4:.4f} ms; K8 at "
        f"{floor4 / ms:.3f} of it. Its 16-byte design on this run's codes: {waves:.4g} "
        f"wavefronts ({waves / (lookups / 32):.3f} a 32-lookup warp load) at one a clock an SM = "
        f"{floor16:.4f} ms; K8 at {floor16 / ms:.3f} of it | {smi}")
    return calm_ms


def profile_paths(smi, corpus, queries, main, prec, rqres, ivfpq, flat):
    """Each call of the precision, PQ search and RQ paths, the IVF
    trainers and adds that K1 dominates, and the IVF-Flat / IVF-SQ and
    IVF-PQ searches, once warm,
    then once under ``torch.profiler`` (up to three times, where it
    recorded no device activity): wall time (host clock to a
    synchronize), device time (the device activities' own time summed),
    busy share (device over wall, the profiler's host cost included), the
    three kernels that took most of it, K7's launches by stage and K8's
    time and share where they ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import vq_tpu_torch

    rq, ivf, pq, codes = rqres["rq"], rqres["ivf"], prec["pq"], prec["codes"]
    pqi, fl, sq = ivfpq["index"], flat["indexes"]["flat_f32"], flat["indexes"]["sq"]
    calls = {
        "ProductQuantizer train 100k, 10 iterations": lambda: vq_tpu_torch.ProductQuantizer(
            corpus[:N_TRAIN], M, K, max_iters=10, device=corpus.device),
        "PQIndex.add 1M (exact)": lambda: vq_tpu_torch.PQIndex(pq).add(corpus),
        "IVFPQIndex.train 200k": lambda: vq_tpu_torch.IVFPQIndex.train(
            corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True),
        "IVFPQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFPQIndex(
            pqi.coarse, pqi.pq, keep_corpus=True).add(corpus),
        "IVFFlatIndex.add 1M f32 (fresh index)": lambda: vq_tpu_torch.IVFFlatIndex(fl.coarse).add(corpus),
        "IVFFlatIndex.add 1M bf16 (fresh index)": lambda: vq_tpu_torch.IVFFlatIndex(
            fl.coarse, store_dtype="bfloat16").add(corpus),
        "IVFSQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFSQIndex(sq.coarse, sq.sq).add(corpus),
        "RQ train 200k, 8x256": lambda: vq_tpu_torch.ResidualQuantizer(
            corpus[:N_IVF_TRAIN], RQ_STAGES, K, max_iters=RQ_ITERS, seed=1),
        "RQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.RQIndex(rq).add(corpus),
        "IVFRQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFRQIndex(ivf.coarse, rq).add(corpus),
        "PQIndex.add precision=high 1M": lambda: vq_tpu_torch.PQIndex(pq).add(corpus, precision="high"),
        "PQIndex.add precision=default 1M": lambda: vq_tpu_torch.PQIndex(pq).add(
            corpus, precision="default"),
        "adc_distances [128, 1M]": lambda: pq.adc_distances(queries, codes),
        "PQIndex.search k=10": lambda: main["index"].search(queries, k=10),
        "PQIndex.search k=10 rerank=100": lambda: main["index"].search(queries, k=10, rerank=100),
    }
    for name, (idx, kw) in rqres["searches"].items():
        calls[f"{name} search"] = lambda idx=idx, kw=kw: idx.search(queries, **kw)
    for name, p in flat["searches"]:
        idx = flat["indexes"][name]
        calls[f"{name} search nprobe={p}"] = lambda idx=idx, p=p: idx.search(queries, k=10, nprobe=p)
    for p in NPROBES:
        calls[f"IVFPQIndex.search nprobe={p}"] = lambda p=p: pqi.search(queries, k=10, nprobe=p)
    cuda = torch.autograd.DeviceType.CUDA
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler now and then records no device activity: again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            evts = [e for e in prof.key_averages() if e.device_type == cuda]
            if evts:
                break
        dev = sum(e.self_device_time_total for e in evts) / 1e3
        top = sorted(evts, key=lambda e: -e.self_device_time_total)[:3]
        stages = stage_times(evts)
        k2 = ("; K2's sums stage: " + ", ".join(
            f"{s} {stages[s][0]:.3f} ms x{stages[s][1]:g}" for s in ("sums", "combine") if s in stages)
            if "sums" in stages else "")
        k8 = [e for e in evts if "adc_lookup_kernel" in e.key]
        k8_ms = sum(e.self_device_time_total for e in k8) / 1e3
        k8 = (f"; K8 {k8_ms:.3f} ms x{sum(e.count for e in k8)}, {k8_ms / dev:.2f} of the device time"
              if k8 else "")
        k7 = (stage_times(evts, K7_STAGES) if any("ivf_probe_kernel" in e.key for e in evts)
              else {})
        k7 = ("; K7: " + ", ".join(f"{s} {ms:.4f} ms x{n:g}" for s, (ms, n) in k7.items())
              if k7 else "")
        log("profile", f"{name}: wall {wall:.3f} ms, device {dev:.3f} ms, busy {dev / wall:.2f}; "
            + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
            + k2 + k7 + k8 + f" | {smi}")


def make_bench_data(device):
    """The benchmark twins' operands, seeded uniform data on the card."""
    import torch

    from vq_tpu_torch.benchmarks.mpacked_encode import build_w

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.rand(N_CORPUS, DIM, generator=g, device=device)
    cb = torch.rand(M, K, DIM // M, generator=g, device=device)
    w, cc = build_w(cb)
    tables = torch.rand(N_QUERY, M, K, generator=g, device=device)
    codes = torch.randint(0, K, (N_CORPUS, M), generator=g, device=device,
                          dtype=torch.int32).to(torch.uint8)
    return dict(x=x, cb=cb, w=w, cc=cc, tables=tables, codes=codes, codes_t=codes.T.contiguous(),
                weights=torch.rand(N_IVF_TRAIN, generator=g, device=device) * 1.5 + 0.25)


def phase_bench_kernels(bd, corpus, kres):
    """B1-B4 held to their plain versions (and B1 to K4, B2 and B3 to K8)
    on the card; K2 with weights at both of its shapes twice and against
    its plain version, bit for bit."""
    import torch

    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, w, cc = bd["cb"], bd["w"], bd["cc"]
    x = bd["x"][:B1_ROWS]
    par = mp.kernel_parity(x, w, cc, mp.mpacked_encode(x, w, cc, "highest"), "highest")
    assert par.ok, f"B1 highest: {par.flips} codes differ from the plain version"
    # On build_w's operands the products are K4's times the exact -2, in
    # K4's order, and the zero entries add exactly: K4's codes, at the
    # main path's 1M rows.
    full, k4 = mp.mpacked_encode(bd["x"], w, cc, "highest"), ck.pq_encode_fused(bd["x"], cb)
    assert torch.equal(full, k4), f"B1 highest: {int((full != k4).sum())} codes differ from K4's"
    log("kernels", f"B1 mpacked_encode highest {tuple(x.shape)} x W {tuple(w.shape)}: bit-identical "
        f"to the plain version; at {tuple(bd['x'].shape)} bit-identical to K4")
    errs = {"highest": par.max_gap}
    del full, k4
    for tag, xx, ww in (("f32", x, w), ("bf16-resident", x.to(torch.bfloat16), w.to(torch.bfloat16))):
        got = mp.mpacked_encode(xx, ww, cc, "default")
        par = mp.kernel_parity(xx, ww, cc, got, "default")
        assert par.ok, (
            f"B1 default {tag}: {par.match} of the codes equal the plain version's (at least "
            f"{mp.MIN_MATCH}); {par.flips} differ, max float64 gap {par.max_gap}")
        errs["default"] = max(errs.get("default", 0.0), par.max_gap)
        k4b = ck.pq_encode_fused(xx, cb, precision="bf16_fast")
        log("kernels", f"B1 mpacked_encode default {tag} {tuple(xx.shape)}: {par.match:.6f} of the "
            f"codes equal the plain version's, {par.flips} differ, all float64 near ties (max gap "
            f"{par.max_gap:.3g}); {float((got == k4b).float().mean()):.6f} equal K4-bf16's")

    tables, codes, codes_t = bd["tables"], bd["codes"], bd["codes_t"]
    k8 = ck.adc_lookup_fused(tables, codes)
    outs = {"adc_kt": av.adc_kt(tables, codes_t), "adc_gather": av.adc_gather(tables, codes_t),
            "adc_floor": av.adc_floor(tables, codes_t),
            "adc_gather(only=1)": av.adc_gather(tables, codes_t, only=1)}
    torch.cuda.synchronize()
    plains = {"adc_kt": av.adc_kt_plain(tables, codes_t),
              "adc_gather": av.adc_gather_plain(tables, codes_t),
              "adc_floor": av.adc_floor_plain(tables, codes_t),
              "adc_gather(only=1)": av.adc_gather_plain(tables, codes_t, only=1)}
    for name, out in outs.items():
        assert torch.equal(out, plains[name]), f"{name}: values differ from the plain version"
    for name in ("adc_kt", "adc_gather"):
        assert torch.equal(outs[name], k8), f"{name}: values differ from K8's"
    log("kernels", f"B2 adc_kt, B3 adc_gather (all subspaces and only=1), B4 adc_floor: tables "
        f"{tuple(tables.shape)} x codes_t {tuple(codes_t.shape)} u8: bit-identical to their plain "
        "versions; B2 and B3 bit-identical to K8 on the same codes")
    del outs, plains, k8

    x2, wt = corpus[:N_IVF_TRAIN], bd["weights"]
    for tag, cents in k2_shapes(kres).items():
        first = ck.lloyd_accumulate_fused(x2, cents, wt)
        again = ck.lloyd_accumulate_fused(x2, cents, wt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), (
            f"weighted K2 {tag} is not deterministic")
        want = ck.lloyd_accumulate_plain(x2, cents, wt)
        diffs = [int((a != b).sum()) for a, b in zip(first, want)]
        assert all(torch.equal(a, b) for a, b in zip(first, want)), (
            f"weighted K2 {tag}: {diffs} sums / counts / inertia differ from the plain version")
        log("kernels", f"K2 lloyd_accumulate with weights {tag}: bit-identical to the weighted plain "
            "version and on a second run")
    return errs


def phase_bench_path():
    """The twins' ``main()`` at their default sizes, in this process: the
    slice's main path. Returns the launch counts of that run."""
    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp

    reset_counts()
    lines = []
    for name, mod in (("mpacked_encode", mp), ("adc_vmem_bench", av)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main([]) == 0, name
        for text in buf.getvalue().splitlines():
            rec = json.loads(text)
            log("bench", f"{name}: {text}")
            assert rec.get("parity", True) is True, f"{name}: parity failed in {text}"
            lines.append(rec)
    launches = read_counts()
    on_path = ("mpacked_encode[highest]", "mpacked_encode[default]", "adc_kt", "adc_gather", "adc_floor")
    log("bench", f"launches in the twins' run: {launches}")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    return launches


def phase_bench_timings(smi, bd):
    """B1 beside K4 / K4-bf16 / K4-bf16x3 at 1M; B2, B3, B4 beside K8 and
    ``embedding_bag`` at [128, 1M]; plain versions at their checks' sizes."""
    import torch

    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    x, cb, w, cc = bd["x"], bd["cb"], bd["w"], bd["cc"]
    xh, wh, xs = x.to(torch.bfloat16), w.to(torch.bfloat16), x[:B1_ROWS]
    t = {
        "B1_highest": (cuda_ms(lambda: mp.mpacked_encode(x, w, cc, "highest"), 3),
                       cuda_ms(lambda: mp.mpacked_encode_plain(xs, w, cc, "highest"), 1)),
        "B1_default": (cuda_ms(lambda: mp.mpacked_encode(x, w, cc, "default"), 10),
                       cuda_ms(lambda: mp.mpacked_encode_plain(xs, w, cc, "default"), 1)),
        "B1_bf16resident": (cuda_ms(lambda: mp.mpacked_encode(xh, wh, cc, "default"), 10), None),
        "K4@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb), 5), None),
        "K4_bf16@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb, precision="bf16_fast"), 5), None),
        "K4_bf16x3@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb, precision="bf16x3"), 3), None),
    }
    for name, (ms, pms) in t.items():
        plain = "" if pms is None else f", plain {pms:.4f} ms on {B1_ROWS} rows"
        log("time", f"{name} {N_CORPUS} x {DIM} vs {M}x{K}: kernel {ms:.4f} ms{plain} | {smi}")
    tables, codes, codes_t = bd["tables"], bd["codes"], bd["codes_t"]
    q, m, k = tables.shape
    weight = tables.permute(1, 2, 0).reshape(m * k, q).contiguous()
    index = (codes.long() + torch.arange(m, device=codes.device) * k).contiguous()
    lib = cuda_ms(lambda: torch.nn.functional.embedding_bag(index, weight, mode="sum"), 20)
    adc = {
        "K8@bench": (lambda: ck.adc_lookup_fused(tables, codes), lambda: ck.adc_lookup_plain(tables, codes)),
        "B2_adc_kt": (lambda: av.adc_kt(tables, codes_t), lambda: av.adc_kt_plain(tables, codes_t)),
        "B3_adc_gather": (lambda: av.adc_gather(tables, codes_t),
                          lambda: av.adc_gather_plain(tables, codes_t)),
        "B4_adc_floor": (lambda: av.adc_floor(tables, codes_t),
                         lambda: av.adc_floor_plain(tables, codes_t)),
    }
    for name, (fn, plain_fn) in adc.items():
        t[name] = (cuda_ms(fn, 20), cuda_ms(plain_fn, 2), lib)
        log("time", f"{name} [{q}, {N_CORPUS}] from {m}x{k} tables: kernel {t[name][0]:.4f} ms, plain "
            f"{t[name][1]:.4f} ms, embedding_bag {lib:.4f} ms | {smi}")
    return t


EVAL_CLIS = ("bq", "sq", "pq", "tsvq")


def _eval_rows(mod, argv):
    """``(rows, wall s)`` of one harness ``main(argv)``, its stdout parsed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()], time.perf_counter() - t0


def phase_eval_path(smi):
    """The four harnesses' ``main()`` at the reference grid's width (1M x
    384, every other flag at its default, plus ``--recall``): rows parsed
    and finite, K3's and K4's launches read from ``eval_pq``'s run, and
    their operands there recorded."""
    import importlib as il
    import math

    argv = ["--sizes", str(EVAL_ROWS), "--dim", str(EVAL_DIM), "--recall"]
    out = {"rows": {}, "wall": {}, "launches": {}}
    reset_counts()
    with recording("vq_tpu_torch.ops.kmeans", "pq_lloyd_accumulate_fused") as k3_calls, \
            recording("vq_tpu_torch.models.pq", "pq_encode_fused") as k4_calls:
        for name in EVAL_CLIS:
            before = read_counts()
            (rec,), wall = _eval_rows(il.import_module(f"vq_tpu_torch.cli.eval_{name}"), argv)
            log("eval", f"eval_{name}: {json.dumps(rec)}")
            assert rec["num_samples"] == EVAL_ROWS and rec["dim"] == EVAL_DIM, rec
            assert math.isfinite(rec["mse"]) and math.isfinite(rec["recall_at_k"]), rec
            out["rows"][name], out["wall"][name] = rec, wall
            out["launches"][name] = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
            log("time", f"eval_{name} {EVAL_ROWS} x {EVAL_DIM}: main() {wall:.3f} s, train "
                f"{rec['train_ms']:.3f} ms, encode {rec['encode_ms']:.3f} ms, encode by CUDA events "
                f"{rec.get('encode_ms_device')} ms, mse {rec['mse']:.9g}, recall@10 "
                f"{rec['recall_at_k']:.4f}; launches {out['launches'][name]} | {smi}")
        out["k3_args"], out["k4_args"] = k3_calls[-1][0], k4_calls[-1][0]
    on_path = out["launches"]["pq"]
    assert on_path.get("pq_lloyd_accumulate_fused", 0) > 0, on_path
    assert on_path.get("pq_encode_fused[highest]", 0) > 0, on_path
    assert not any(out["launches"][n] for n in ("bq", "sq", "tsvq")), out["launches"]
    return out


def phase_eval_checks(smi, ev):
    """K3 (on 100k of the eval rows) and K4 (on all 1M) at the eval's
    16x256x24 against their plain versions, bit for bit; BQ codes, words
    and a [128, 1M] Hamming block against the CPU copies; TSVQ leaf ids of
    100k rows against the CPU run (near ties counted), and the device
    build against the CPU's (bit for bit) and the host recursion's (every
    differing split a float near tie)."""
    import numpy as np
    import torch

    from vq_tpu_torch.cli.common import generate_synthetic_data
    from vq_tpu_torch.models import bq as tbq
    from vq_tpu_torch.models import tsvq as tt
    from vq_tpu_torch.ops import cuda_kernels as ck

    x, cb = ev["k4_args"][:2]
    k4 = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(k4, ck.pq_encode_plain(x, cb)), "K4 at the eval shape differs from its plain version"
    x3, cb3 = ev["k3_args"][0][:EVAL_K3_ROWS], ev["k3_args"][1]
    got = ck.pq_lloyd_accumulate_fused(x3, cb3)
    torch.cuda.synchronize()
    want = ck.pq_lloyd_accumulate_plain(x3, cb3)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "K3 at the eval shape differs"
    m, k, s = cb.shape
    log("kernels", f"K4 {tuple(x.shape)} x {m}x{k}x{s} (eval_pq's codebooks) and K3 on {EVAL_K3_ROWS} of "
        "its rows: bit-identical to their plain versions")
    out = {"k3": (x3, cb3), "k4": (x, cb)}
    del k4, got, want

    data = generate_synthetic_data(EVAL_ROWS, EVAL_DIM, 66)  # eval_bq's corpus
    q = tbq.BinaryQuantizer(0.5)
    host = data.cpu()
    codes, packed = q.quantize(data), q.quantize_packed(data)
    assert torch.equal(codes.cpu(), q.quantize(host)), "BQ codes differ from the CPU's"
    assert torch.equal(packed.cpu(), q.quantize_packed(host)), "BQ words differ from the CPU's"
    ham, ham_ms = cuda_once(lambda: tbq.hamming_distance(packed[:EVAL_QUERIES], packed))
    t0 = time.perf_counter()
    ham_cpu = tbq.hamming_distance(packed[:EVAL_QUERIES].cpu(), packed.cpu())
    cpu_s = time.perf_counter() - t0
    assert torch.equal(ham.cpu(), ham_cpu), "the Hamming block differs from the CPU's"
    log("eval", f"BQ {tuple(data.shape)}: codes, uint32 words {tuple(packed.shape)} and the Hamming "
        f"block {tuple(ham.shape)} equal the CPU's bit for bit; Hamming block {ham_ms:.3f} ms on the "
        f"card (first call), {cpu_s:.2f} s on the CPU | {smi}")
    del data, host, codes, packed, ham, ham_cpu

    rows = generate_synthetic_data(EVAL_TSVQ_ROWS, EVAL_DIM, 66, device=False)
    t0 = time.perf_counter()
    host_tree = tt.tsvq_build(rows, 5, device="cpu")
    host_s = time.perf_counter() - t0
    card = ev["k4_args"][0].device
    rows_card = torch.from_numpy(rows).to(card)
    dev_tree, dev_ms = cuda_once(lambda: tt.tsvq_build_batched(rows_card, 5))
    t0 = time.perf_counter()
    cpu_tree = tt.tsvq_build_batched(rows, 5, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = (torch.equal(dev_tree.left.cpu(), cpu_tree.left) and torch.equal(dev_tree.right.cpu(), cpu_tree.right)
            and torch.equal(dev_tree.centroids.cpu(), cpu_tree.centroids))
    assert same, "the card's device build differs from the same build on the CPU"
    diffs = tt.split_differences(rows, host_tree, dev_tree)
    for node, da, db, va, vb in diffs:
        log("eval", f"TSVQ split of host node {node}: dim {da} (summed deviation {va:.9g}) against "
            f"dim {db} ({vb:.9g}), relative gap {abs(va - vb) / max(va, vb):.3g}")
        assert abs(va - vb) <= TSVQ_TIE_RTOL * max(va, vb), "a differing split that is no near tie"
    topo = (torch.equal(dev_tree.left.cpu(), host_tree.left)
            and torch.equal(dev_tree.right.cpu(), host_tree.right))
    cgap = (float((dev_tree.centroids.cpu() - host_tree.centroids).abs().max()) if topo else None)
    log("eval", f"TSVQ device build {tuple(rows.shape)} depth 5: {dev_tree.num_nodes} nodes, bit-identical to "
        f"the same build on the CPU; against the host recursion {len(diffs)} differing splits, topology "
        f"{'equal' if topo else 'differs'}, centroids within {cgap}")
    log("time", f"TSVQ build {tuple(rows.shape)} depth 5: device build {dev_ms:.3f} ms on the card (CUDA "
        f"events, first call), {cpu_s:.3f} s on the CPU; host recursion {host_s:.3f} s | {smi}")
    xe = generate_synthetic_data(EVAL_TSVQ_ENCODE, EVAL_DIM, 67)
    card_q = tt.TSVQ(tree=host_tree.to(card))
    leaves = card_q.encode(xe).cpu()
    want = tt.TSVQ(tree=host_tree).encode(xe.cpu())
    gaps = tt.descent_gaps(host_tree, xe.cpu(), leaves, want)
    for gap in gaps:
        log("eval", f"TSVQ leaf differs from the CPU's at a relative distance gap of {gap:.3g}")
    assert (gaps <= TSVQ_TIE_RTOL).all(), f"TSVQ leaves differ beyond a near tie: {gaps}"
    log("eval", f"TSVQ encode {tuple(xe.shape)} on the card: {int(gaps.size)} of {xe.shape[0]} leaf ids "
        f"differ from the CPU run's, all float near ties (max gap {float(gaps.max(initial=0.0)):.3g})")
    out["tsvq_build_ms"], out["tsvq_host_s"] = dev_ms, host_s
    return out


def phase_eval_timings(smi, checks):
    """K3 and K4 at the eval's 16x256x24 beside their plain versions, with
    their floors; then a ``torch.profiler`` line a harness (one more
    ``main()`` each)."""
    import importlib as il

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    (x3, cb3), (x4, cb4) = checks["k3"], checks["k4"]
    t = {"K3_eval": (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3, cb3), 10),
                     cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3, cb3), 2)),
         "K4_eval": (cuda_ms(lambda: ck.pq_encode_fused(x4, cb4), 5),
                     cuda_ms(lambda: ck.pq_encode_plain(x4, cb4), 1))}
    m, k, s = cb4.shape
    sms, mhz = sm_rate()
    for name, n in (("K3_eval", x3.shape[0]), ("K4_eval", x4.shape[0])):
        floor = 2.0 * n * m * k * s / (sms * 128 * mhz * 1e6) * 1e3
        log("time", f"{name} {n} x {m}x{k}x{s}: kernel {t[name][0]:.4f} ms, plain {t[name][1]:.4f} ms; "
            f"floor under its exact contract {floor:.4f} ms, {floor / t[name][0]:.3f} of it | {smi}")
    argv = ["--sizes", str(EVAL_ROWS), "--dim", str(EVAL_DIM), "--recall"]
    cuda = torch.autograd.DeviceType.CUDA
    for name in EVAL_CLIS:
        mod = il.import_module(f"vq_tpu_torch.cli.eval_{name}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = _eval_rows(mod, argv)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == cuda]
        dev = sum(e.self_device_time_total for e in evts) / 1e3
        top = sorted(evts, key=lambda e: -e.self_device_time_total)[:3]
        log("profile", f"eval_{name} main() {EVAL_ROWS} x {EVAL_DIM} --recall: wall {wall * 1e3:.1f} ms, "
            f"device {dev:.3f} ms, busy {dev / (wall * 1e3):.3f}; "
            + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
            + f" | {smi}")
    return t


def eval_fields(key, t_eval, bounds, rows):
    """Extra fields of the K3 / K4 rows: their time, plain time and bound
    at the eval harness's shape."""
    return {"eval_shape": f"{rows} x {EVAL_DIM}, {'x'.join(map(str, PQ_EVAL))}",
            "ms_eval": t_eval[key][0], "plain_ms_eval": t_eval[key][1],
            "bound_ms_eval": bounds[key][0], "bound_by_eval": bounds[key][1]}


def bench_bounds():
    """``{kernel: (bound ms, "bytes" or "operations")}`` of B1-B4 at the
    twins' shapes, as :func:`kernel_bounds` reckons them, and B2's own
    design floor (its one-hot products at the bf16 peak)."""
    x_bytes, codes_out = N_CORPUS * DIM * 4, N_CORPUS * M * 4
    w_bytes = DIM * M * K * 4 + M * K * 4
    ops = 2.0 * N_CORPUS * DIM * M * K
    out_bytes = N_QUERY * N_CORPUS * 4
    lookup = bound(out_bytes + N_CORPUS * M + N_QUERY * M * K * 4, 1.0 * N_QUERY * N_CORPUS * M, PEAK_F32)
    return {
        "B1_highest": bound(x_bytes + w_bytes + codes_out, ops, PEAK_F32),
        "B1_default": bound(x_bytes + w_bytes + codes_out, ops, PEAK_BF16),
        "B2": lookup,
        "B3": lookup,
        "B4": bound(out_bytes + N_CORPUS + 4, 1.0 * N_QUERY * N_CORPUS, PEAK_F32),
        "B2_design_floor": 3 * 2.0 * N_QUERY * K * N_CORPUS * M / PEAK_BF16 * 1e3,
    }


def kernel_bounds(res, kres, ivf, k7_cases, k6_cases, prec, rqres):
    """``{kernel: (bound ms, "bytes" or "operations")}`` at the shapes this
    run gave each kernel: each input read once, each output written once,
    the operations over the fp32 (CUDA cores) or bf16 (tensor cores) peak."""
    import torch

    d, s = DIM, DIM // M
    pq_ops = 2.0 * N_CORPUS * M * K * s
    x_bytes = N_CORPUS * d * 4
    out = {
        "K1": bound(x_bytes + NLIST * d * 4 + N_CORPUS * 8, 2.0 * N_CORPUS * NLIST * d, PEAK_F32),
        "K2": bound(N_IVF_TRAIN * d * 4 + 2 * NLIST * d * 4 + NLIST * 8,
                    2.0 * N_IVF_TRAIN * NLIST * d, PEAK_F32),
        "K3": bound(N_TRAIN * d * 4 + 2 * M * K * s * 4 + M * K * 4, 2.0 * N_TRAIN * M * K * s, PEAK_F32),
        "K4": bound(x_bytes + M * K * s * 4 + N_CORPUS * M * 4, pq_ops, PEAK_F32),
        "K4_bf16": bound(x_bytes + M * K * s * 4 + N_CORPUS * M * 4, pq_ops, PEAK_BF16),
        "K4_bf16x3": bound(x_bytes + 2 * M * K * s * 4 + N_CORPUS * M * 4, 3 * pq_ops, PEAK_BF16),
    }
    tiles = -(-N_CORPUS // 2048)
    out["K5"] = bound(N_CORPUS * M + N_QUERY * M * K * 4 + N_QUERY * tiles * 128 * 8,
                      1.0 * N_QUERY * N_CORPUS * M, PEAK_F32)
    # K7 and K6 read the rows of the chunks probed (each chunk once, however
    # many pairs probe it) and do their arithmetic on every live position.
    for p in NPROBES:
        tables, chains, codes = k7_cases[p]
        pairs, m, kk = tables.shape
        ch, cap = codes.shape[1], ivf["index"]._pool.cap
        pos = torch.arange(chains.shape[1] * ch, device=chains.device)
        live = int(((chains >= 0).repeat_interleave(ch, dim=1) & (pos < cap)).sum())
        chunks = torch.unique(chains[chains >= 0]).numel()
        out["K7" if p == NPROBES[0] else f"K7_nprobe{p}"] = bound(
            chunks * ch * m + pairs * m * kk * 4 + pairs * pos.numel() * 4 + chains.numel() * 4,
            1.0 * live * m, PEAK_F32)
    out["K6"] = k6_cases[("flat_f32", NPROBES[0])][2][:2]
    for name, (tables8, codes8) in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"])):
        q8, m8, k8 = tables8.shape
        n8 = codes8.shape[0]
        out[name] = bound(q8 * n8 * 4 + n8 * m8 * codes8.element_size() + q8 * m8 * k8 * 4,
                          1.0 * q8 * n8 * m8, PEAK_F32)
    return out


def main() -> None:
    import torch

    smi = phase_device()
    build_s = phase_build()
    corpus, queries, g = make_data("cuda")
    log("data", f"Gaussian mixture on the card: corpus {tuple(corpus.shape)}, "
        f"queries {tuple(queries.shape)}, {N_CLUSTERS} clusters of rank-{LATENT} "
        f"covariance, seed {SEED}")
    res = phase_kernels(corpus, queries, g)
    lowp_gap = phase_lowp_kernels(corpus, res)
    kres = phase_ivf_kernels(corpus, g)
    main_res = phase_main_path(corpus, queries)
    ivf = phase_ivf_path(corpus, queries, main_res["gt"])
    k7_cases = phase_k7(queries, ivf)
    t = phase_timings(smi, corpus, queries, res, main_res)
    t.update(phase_ivf_timings(smi, corpus, queries, kres, ivf, k7_cases))
    phase_k2_stages(smi, corpus, kres)
    k3_stages = phase_k3_stages(smi, corpus, res)
    flat = phase_flat_path(corpus, queries, main_res["gt"])
    k6_cases, k6_err = phase_k6(flat)
    t.update(phase_flat_timings(smi, queries, flat, k6_cases))
    prec = phase_precision(corpus, queries, main_res)
    rqres = phase_rq_path(corpus, queries, main_res["gt"])
    t_new, k8 = phase_new_timings(smi, corpus, queries, res, prec, rqres)
    profile_paths(smi, corpus, queries, main_res, prec, rqres, ivf, flat)
    bd = make_bench_data("cuda")
    b_err = phase_bench_kernels(bd, corpus, kres)
    bl = phase_bench_path()
    t_bench = phase_bench_timings(smi, bd)
    del bd
    ev = phase_eval_path(smi)
    ev_checks = phase_eval_checks(smi, ev)
    t_eval = phase_eval_timings(smi, ev_checks)
    del ev_checks
    log("time", f"kernel build {build_s:.2f} s | {smi}")

    launches = dict(main_res["launches"])
    for name in ("assign_fused", "lloyd_accumulate_fused", "ivf_probe_adc_fused"):
        launches[name] = ivf["launches"][name]
    launches["ivf_probe_matvec_fused"] = flat["launches"]["ivf_probe_matvec_fused"]
    pl, rl = prec["launches"], rqres["launches"]
    k3_paths = {"pq": launches["pq_lloyd_accumulate_fused"],
                "ivf_pq": ivf["launches"]["pq_lloyd_accumulate_fused"],
                "eval_pq": ev["launches"]["pq"]["pq_lloyd_accumulate_fused"]}
    k4_paths = {"pq": launches["pq_encode_fused"], "ivf_pq": ivf["launches"]["pq_encode_fused[highest]"],
                "eval_pq": ev["launches"]["pq"]["pq_encode_fused[highest]"]}
    bounds = kernel_bounds(res, kres, ivf, k7_cases, k6_cases, prec, rqres)
    e_m, e_k, e_s = PQ_EVAL
    e_ops = 2.0 * e_m * e_k * e_s
    bounds["K3_eval"] = bound(EVAL_K3_ROWS * EVAL_DIM * 4 + 2 * e_m * e_k * e_s * 4 + e_m * e_k * 4,
                              e_ops * EVAL_K3_ROWS, PEAK_F32)
    bounds["K4_eval"] = bound(EVAL_ROWS * EVAL_DIM * 4 + e_m * e_k * e_s * 4 + EVAL_ROWS * e_m * 4,
                              e_ops * EVAL_ROWS, PEAK_F32)
    bbounds = bench_bounds()
    bounds.update({k: v for k, v in bbounds.items() if k != "B2_design_floor"})
    src = "vq_tpu_torch/csrc/"
    tpu = "vq_tpu/ops/pallas_kernels.py:"

    def row(name, source, replaces, n, err, key, times, extra=None):
        ms, pms = times[:2]
        b_ms, b_by = bounds[key]
        entry = {"name": name, "route": "cuda", "source": src + source,
                 "replaces": replaces if ":" in replaces else tpu + replaces,
                 "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": times[2] if len(times) > 2 else None}
        entry.update(extra or {})
        return entry

    kernels = [
        row("pq_lloyd_accumulate_fused", "pq_lloyd.cu", "569", sum(k3_paths.values()),
            res["k3_err"], "K3", t["K3"], {
                "launches_by_path": k3_paths, "ms_200k": t["K3_200k"][0],
                "plain_ms_200k": t["K3_200k"][1],
                "sums_stage_by_rows": {str(n): v for n, v in k3_stages.items()},
                **eval_fields("K3_eval", t_eval, bounds, EVAL_K3_ROWS)}),
        row("pq_encode_fused", "pq_encode.cu", "379", sum(k4_paths.values()), res["k4_err"],
            "K4", t["K4"], {"launches_by_path": k4_paths,
                            **eval_fields("K4_eval", t_eval, bounds, EVAL_ROWS)}),
        row("adc_scan_topk_fused", "adc_topk.cu", "802", launches["adc_scan_topk_fused"],
            res["k5_err"], "K5", t["K5"]),
        row("assign_fused", "assign.cu", "137", launches["assign_fused"], kres["k1_err"], "K1", t["K1"],
            {"bf16_ms": t["K1_bf16"][0]}),
        row("lloyd_accumulate_fused", "lloyd.cu", "1473", launches["lloyd_accumulate_fused"],
            kres["k2_err"], "K2", t["K2"], {"rq_shape_ms": t["K2_rq_shape"][0]}),
        row("ivf_probe_adc_fused", "ivf_probe.cu", "1189", launches["ivf_probe_adc_fused"], 0.0,
            "K7", t["K7_nprobe8"], {
                "also_replaces": tpu + "1147", "ms_nprobe64": t["K7_nprobe64"][0],
                "plain_ms_nprobe64": t["K7_nprobe64"][1], "bound_ms_nprobe64": bounds["K7_nprobe64"][0],
                "bound_by_nprobe64": bounds["K7_nprobe64"][1],
                "launches_by_nprobe": ivf["k7_by_nprobe"]}),
        row("ivf_probe_matvec_fused", "ivf_matvec.cu", "1356", launches["ivf_probe_matvec_fused"],
            k6_err, "K6", t["K6_flat_f32_nprobe8"], {
                "ms_by_case": {f"{n} nprobe={p}": t[f"K6_{n}_nprobe{p}"][0] for n, p in k6_cases},
                "bound_ms_by_case": {f"{n} nprobe={p}": c[2][0] for (n, p), c in k6_cases.items()}}),
        row("pq_encode_fused[bf16_fast]", "pq_encode.cu", "404", pl["pq_encode_fused[bf16_fast]"],
            lowp_gap["bf16_fast"], "K4_bf16", t_new["K4_bf16"],
            {"bf16_x_ms": t_new["K4_bf16_bf16in"][0]}),
        row("pq_encode_fused[bf16x3]", "pq_encode.cu", "420", pl["pq_encode_fused[bf16x3]"],
            lowp_gap["bf16x3"], "K4_bf16x3", t_new["K4_bf16x3"]),
        row("adc_lookup_fused", "adc_lookup.cu", "727", pl["adc_lookup_fused"] + rl["adc_lookup_fused"],
            0.0, "K8", t_new["K8"], {
                "launches_by_path": {"precision": pl["adc_lookup_fused"], "rq": rl["adc_lookup_fused"]},
                "ms_rq_chunk": t_new["K8_rq_chunk"][0], "plain_ms_rq_chunk": t_new["K8_rq_chunk"][1],
                "library_ms_rq_chunk": t_new["K8_rq_chunk"][2],
                "bound_ms_rq_chunk": bounds["K8_rq_chunk"][0], "bound_by_rq_chunk": bounds["K8_rq_chunk"][1],
                "calm_ms": k8["K8"], "calm_ms_rq_chunk": k8["K8_rq_chunk"]}),
        row("mpacked_encode[highest]", "mpacked_encode.cu", "benchmarks/mpacked_encode.py:46",
            bl["mpacked_encode[highest]"], b_err["highest"], "B1_highest", t_bench["B1_highest"]),
        row("mpacked_encode[default]", "mpacked_encode.cu", "benchmarks/mpacked_encode.py:46",
            bl["mpacked_encode[default]"], b_err["default"], "B1_default", t_bench["B1_default"],
            {"bf16_resident_ms": t_bench["B1_bf16resident"][0]}),
        row("adc_kt", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:55", bl["adc_kt"], 0.0, "B2",
            t_bench["B2_adc_kt"]),
        row("adc_gather", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:99", bl["adc_gather"], 0.0,
            "B3", t_bench["B3_adc_gather"]),
        row("adc_floor", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:156", bl["adc_floor"], 0.0,
            "B4", t_bench["B4_adc_floor"][:2]),
    ]
    for k in kernels:
        log("bound", f"{k['name']}: {k['ms']:.4f} ms against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), {k['bound_ms'] / k['ms']:.3f} of it | {smi}")
    b8, ms8 = bounds["K8_rq_chunk"], t_new["K8_rq_chunk"][0]
    log("bound", f"adc_lookup_fused on one RQ chunk {tuple(rqres['k8_args'][1].shape)}: {ms8:.4f} ms "
        f"against a bound of {b8[0]:.4f} ms ({b8[1]}), {b8[0] / ms8:.3f} of it | {smi}")
    floor, kt_ms = bbounds["B2_design_floor"], t_bench["B2_adc_kt"][0]
    log("bound", f"adc_kt's own design floor, its three one-hot bf16 products at the tensor-core "
        f"peak: {floor:.4f} ms, {floor / kt_ms:.3f} of its time | {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
