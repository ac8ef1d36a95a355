#!/usr/bin/env python3
"""On-card smoke run of vq_tpu_torch, the PyTorch / CUDA port of vq_tpu.

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, one line each (any failure exits non-zero with no result line):

1. device — the card's ``nvidia-smi`` name and power limit, TF32 off;
2. build — nvcc builds ``vq_tpu_torch/csrc`` for sm_90a under ``build/``;
3. kernels — K3, K4 and K5 each held to its plain PyTorch version on the
   card at the main path's shapes (1M x 128 corpus, 8x256x16 codebooks,
   128-query batches);
4. main path — ``ProductQuantizer`` trained on 100k rows, ``PQIndex.add``
   of the 1M corpus, ``search(k=10)`` and ``search(k=10, rerank=100)``
   through the public entry points, with the launch counters of all three
   kernels checked, results held to the plain route on the same card and
   recall@10 against exact brute force;
5. ivf kernels — K1 (assign) at 1M x 1024 x 128 in f32 and bf16 and K2
   (Lloyd accumulate) at 200k x 1024 x 128, each held to its plain
   version on the card;
6. ivf path — ``IVFPQIndex.train`` (IVF1024, PQ 8x256 on residuals) on
   200k rows, ``add`` of the 1M corpus, ``search(k=10)`` at nprobe 8 and
   64 with rerank 0 and 500, through the public entry points: launch
   counts of K1, K2, K3, K4 and K7 read from that run, lists, codes and
   search results held to the plain route (every kernel wrapper swapped
   for its plain version) on the same card, recall@10 against the exact
   ground truth; then K7 held to its plain version over the built
   index's probed chains at nprobe 8 and 64;
7. timings — CUDA events, kernel beside plain version, each line stamped
   with the card's name and power limit.

Before the last line it prints a JSON line of per-kernel results and the
``nvidia-smi`` line; the last line is the run's verdict,
``{"ok": true, "device": {...}}``. The data is a seeded Gaussian mixture
made on the card; the weights are trained from it.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time

N_CORPUS, DIM, N_QUERY = 1_000_000, 128, 128
N_TRAIN, M, K = 100_000, 8, 256
N_CLUSTERS, LATENT, SEED = 1024, 24, 0
# K3: counts exact; sums within 1e-5 of the largest sum plus 1e-5
# relative, inertia within 1e-5 relative (fp32 summation order only).
K3_RTOL = 1e-5
# K4: a code may differ from the plain version's only where the two
# candidates' scores, recomputed in float64, are within this relative gap.
K4_TIE_RTOL = 1e-5
# IVF path, the width of the repo's IVF benchmark (benchmarks/ivf_bench.py).
NLIST, N_IVF_TRAIN, NPROBES, RERANKS = 1024, 200_000, (8, 64), (0, 500)
# K1: codes exact but for float64-verified near ties (K4_TIE_RTOL), and
# distances equal where codes are. K2: counts exact, sums and inertia as
# K3 (fp32 summation order). K7: bit-identical.
# Every kernel wrapper the paths call, and the modules that call it.
KERNEL_CALLERS = (
    ("vq_tpu_torch.ops.kmeans", ("assign_fused", "lloyd_accumulate_fused",
                                 "pq_lloyd_accumulate_fused")),
    ("vq_tpu_torch.models.pq", ("pq_encode_fused", "adc_scan_topk_fused")),
    ("vq_tpu_torch.ivf", ("ivf_probe_adc_fused",)),
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def all_kernels():
    from vq_tpu_torch.ops import cuda_kernels as ck

    return (ck.assign_fused, ck.lloyd_accumulate_fused, ck.pq_lloyd_accumulate_fused,
            ck.pq_encode_fused, ck.adc_scan_topk_fused, ck.ivf_probe_adc_fused)


@contextlib.contextmanager
def plain_route():
    """The paths with every kernel wrapper swapped for its plain version
    (on the same card), for holding the paths' results to them; checks
    that no kernel launched meanwhile."""
    from vq_tpu_torch.ops import cuda_kernels as ck

    before = [fn.launches for fn in all_kernels()]
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
    assert [fn.launches for fn in all_kernels()] == before, "a kernel ran on the plain route"


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


def _near_ties(x, cents, got, want, rows):
    """Max float64 score gap of the rows where two assignments differ;
    fails unless every one is a near tie."""
    import torch

    if rows.numel() == 0:
        return 0.0
    xd = x[rows].double()
    cd = cents.double()

    def score(idx):
        c = cd[idx.long()]
        return (c * c).sum(-1) - 2.0 * (xd * c).sum(-1)

    sg, sw = score(got[rows]), score(want[rows])
    gap = (sg - sw).abs()
    ties = gap <= K4_TIE_RTOL * torch.clamp(sw.abs(), min=1.0)
    assert bool(ties.all()), f"{int((~ties).sum())} differing codes are not near ties"
    return float(gap.max())


def _k4_check(x, cb, tag):
    """K4 against its plain version; mismatches must be float64 near ties."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    got = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    want = ck.pq_encode_plain(x, cb)
    rows, subs = torch.nonzero(got != want, as_tuple=True)
    err = 0.0
    if rows.numel():
        s = cb.shape[2]
        xs = x[rows].double().reshape(-1, cb.shape[0], s)[torch.arange(rows.numel()), subs]
        cbd = cb.double()

        def score(codes):
            c = cbd[subs, codes.long()]
            return (c * c).sum(-1) - 2.0 * (xs * c).sum(-1)

        sg, sw = score(got[rows, subs]), score(want[rows, subs])
        gap = (sg - sw).abs()
        err = float(gap.max())
        ties = gap <= K4_TIE_RTOL * torch.clamp(sw.abs(), min=1.0)
        assert bool(ties.all()), f"K4 {tag}: {int((~ties).sum())} mismatches are not near ties"
    log("kernels", f"K4 pq_encode {tag} {tuple(x.shape)} vs 8x256x16: "
        f"{rows.numel()} mismatched codes of {got.numel()}, all float64 near ties "
        f"(max score gap {err:.3g})")
    return got, err


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

    codes, err_f32 = _k4_check(corpus, cb, "f32")
    _, err_bf16 = _k4_check(corpus.to(torch.bfloat16), cb, "bf16")
    res["k4_err"] = max(err_f32, err_bf16)

    x3 = corpus[:N_TRAIN]
    sums, counts, inertia = ck.pq_lloyd_accumulate_fused(x3, cb)
    again = ck.pq_lloyd_accumulate_fused(x3, cb)
    torch.cuda.synchronize()
    ps, pc, pi = ck.pq_lloyd_accumulate_plain(x3, cb)
    assert torch.equal(counts, pc), "K3 counts differ from the plain version"
    assert int(counts.sum()) == N_TRAIN * M
    bound = K3_RTOL * ps.abs() + K3_RTOL * float(ps.abs().max())
    err3 = float((sums - ps).abs().max())
    assert bool(((sums - ps).abs() <= bound).all()), f"K3 sums off by {err3}"
    assert abs(float(inertia) - float(pi)) <= K3_RTOL * abs(float(pi)), (float(inertia), float(pi))
    det = all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again))
    assert det, "K3 is not deterministic from run to run"
    res["k3_err"] = err3
    log("kernels", f"K3 pq_lloyd_accumulate {tuple(x3.shape)}: counts exact, sums max "
        f"abs err {err3:.3g}, inertia {float(inertia):.6g} vs {float(pi):.6g}, "
        "bit-identical on a second run")

    codes_t = codes.to(torch.uint8).T.contiguous()
    tables = _adc_tables(queries, cb, Metric.SQUARED_EUCLIDEAN)
    cb16 = cb[:, :16].contiguous()
    codes16 = pack_codes(ck.pq_encode_fused(corpus, cb16), 4).T.contiguous()
    tables16 = _adc_tables(queries, cb16, Metric.SQUARED_EUCLIDEAN)
    cases = [
        ("u8 8x256 fetch=10", tables, codes_t, 10, {}),
        ("u8 8x256 fetch=100", tables, codes_t, 100, {}),
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
        torch.cuda.synchronize()
        pv, pidx = ck.adc_scan_topk_plain(tab, ct, fetch, **kw)
        fin = torch.isfinite(pv)
        err5 = max(err5, float(torch.where(fin, (v - pv).abs(), 0.0).max()))
        assert torch.equal(i, pidx), f"K5 {name}: ids differ"
        assert torch.equal(v, pv), f"K5 {name}: values differ"
        log("kernels", f"K5 adc_scan_topk {name} Q={tab.shape[0]} n={ct.shape[1]}: "
            "values and ids bit-identical")
    res.update(codes_t=codes_t, tables=tables, k5_err=err5)
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
    from vq_tpu_torch.ops.distance import Metric

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
    codes_t = index._codes.T.contiguous()
    tables = pq.adc_tables(queries)
    want = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 10), 10, Metric.EUCLIDEAN)
    _parity((ids, dist), want, "search")
    short = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 100), 100, Metric.EUCLIDEAN)[0]
    want_r = pq._rerank(queries, short, corpus, 10)
    _parity((ids_r, dist_r), want_r, "search rerank=100")

    gt = _ground_truth(corpus, queries)
    r_adc, r_rr = _recall(ids, gt), _recall(ids_r, gt)
    assert r_rr >= r_adc, (r_rr, r_adc)
    log("main", f"trained {pq!r} in {t_train:.3f} s; add 1M in {t_add:.3f} s "
        f"({n_diff} codes differ from the plain encode); search and rerank=100 equal "
        f"the plain route; recall@10 ADC {r_adc:.4f}, rerank=100 {r_rr:.4f}")
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
        rows = torch.nonzero(codes != pc)[:, 0]
        gap = _near_ties(x.float(), cents, codes, pc, rows)
        same = codes == pc
        err = float((dists - pd).abs()[same].max())
        assert err <= K3_RTOL * float(pd.abs().max()), f"K1 {tag}: distances off by {err}"
        res["k1_err"] = max(res["k1_err"], err)
        log("kernels", f"K1 assign {tag} {tuple(x.shape)} vs {NLIST} centroids: "
            f"{rows.numel()} of {codes.numel()} codes differ, all float64 near ties "
            f"(max score gap {gap:.3g}); distances max abs err {err:.3g} where codes agree")
    x2 = corpus[:N_IVF_TRAIN]
    sums, counts, inertia = ck.lloyd_accumulate_fused(x2, cents)
    again = ck.lloyd_accumulate_fused(x2, cents)
    torch.cuda.synchronize()
    ps, pc, pi = ck.lloyd_accumulate_plain(x2, cents)
    assert torch.equal(counts, pc), "K2 counts differ from the plain version"
    assert int(counts.sum()) == x2.shape[0]
    err = float((sums - ps).abs().max())
    bound = K3_RTOL * ps.abs() + K3_RTOL * float(ps.abs().max())
    assert bool(((sums - ps).abs() <= bound).all()), f"K2 sums off by {err}"
    assert abs(float(inertia) - float(pi)) <= K3_RTOL * abs(float(pi)), (float(inertia), float(pi))
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again)), (
        "K2 is not deterministic from run to run")
    res["k2_err"] = err
    log("kernels", f"K2 lloyd_accumulate {tuple(x2.shape)} vs {NLIST} centroids: counts exact, "
        f"sums max abs err {err:.3g}, inertia {float(inertia):.6g} vs {float(pi):.6g}, "
        "bit-identical on a second run")
    return res


def _check_search(name, ids, dist):
    import torch

    assert tuple(ids.shape) == (N_QUERY, 10) and tuple(dist.shape) == (N_QUERY, 10), name
    assert bool(torch.isfinite(dist).all()), f"{name}: non-finite distances"
    assert bool(((ids >= 0) & (ids < N_CORPUS)).all()), f"{name}: ids out of range"
    assert bool((dist[:, 1:] >= dist[:, :-1]).all()), f"{name}: not ascending"


def phase_ivf_path(corpus, queries, gt):
    """IVFPQIndex train -> add -> search through the public entry points."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    for fn in all_kernels():
        fn.launches = 0
    index, t_train = cuda_once(lambda: vq_tpu_torch.IVFPQIndex.train(
        corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True))
    _, t_add = cuda_once(lambda: index.add(corpus))
    out = {(p, r): index.search(queries, k=10, nprobe=p, rerank=r)
           for p in NPROBES for r in RERANKS}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
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
        rows = torch.nonzero(lists != lists_p)[:, 0]
        gap = _near_ties(corpus, index.coarse, lists, lists_p, rows)
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
    log("ivf", f"add: {rows.numel()} of {N_CORPUS} lists differ from the plain assign, all "
        f"float64 near ties (max gap {gap:.3g}); residual codes equal the plain encode; all "
        "searches equal the plain route; recall@10 " + ", ".join(
            f"nprobe={p} rerank={r}: {v:.4f}" for (p, r), v in recall.items()))
    assert recall[(64, 500)] >= recall[(8, 0)], recall
    return dict(index=index, t_train=t_train, t_add=t_add, launches=launches, recall=recall)


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
    t["K1"] = (cuda_ms(lambda: ck.assign_fused(corpus, cents), 5),
               cuda_ms(lambda: ck.assign_plain(corpus, cents), 1))
    xb = corpus.to(torch.bfloat16)
    t["K1_bf16"] = (cuda_ms(lambda: ck.assign_fused(xb, cents), 5), None)
    t["K2"] = (cuda_ms(lambda: ck.lloyd_accumulate_fused(x2, cents), 10),
               cuda_ms(lambda: ck.lloyd_accumulate_plain(x2, cents), 2))
    cap = index._pool.cap
    for p, args in k7_cases.items():
        t[f"K7_nprobe{p}"] = (cuda_ms(lambda: ck.ivf_probe_adc_fused(*args, cap=cap), 20),
                              cuda_ms(lambda: ck.ivf_probe_adc_plain(*args, cap=cap), 3))
    for name, (ms, pms) in t.items():
        plain = "not measured" if pms is None else f"{pms:.4f} ms"
        log("time", f"{name}: kernel {ms:.4f} ms, plain {plain} | {smi}")

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


def phase_timings(smi, corpus, queries, res, main):
    import torch

    from vq_tpu_torch.models.pq import _merge_candidates
    from vq_tpu_torch.ops import cuda_kernels as ck
    from vq_tpu_torch.ops.distance import Metric

    cb, pq, index = res["cb"], main["pq"], main["index"]
    x3 = corpus[:N_TRAIN]
    t = {}
    t["K3"] = (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3, cb), 10),
               cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3, cb), 3))
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
        *ck.adc_scan_topk_plain(pq.adc_tables(queries), codes_t, 10), 10, Metric.EUCLIDEAN), 3)
    rerank_ms = cuda_ms(lambda: index.search(queries, k=10, rerank=100), 10)
    for name, (ms, pms) in t.items():
        log("time", f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms | {smi}")
    log("time", f"PQ train 100k x 128, 8x256, 10 iterations: {main['t_train']:.4f} s, "
        f"{main['t_train'] / 10:.5f} s per Lloyd iteration (host clock) | {smi}")
    log("time", f"encode 1M x 128: kernel {N_CORPUS / t['K4'][0] * 1e3:.6g} vectors/s, plain "
        f"{N_CORPUS / t['K4'][1] * 1e3:.6g} vectors/s; PQIndex.add 1M {main['t_add']:.4f} s "
        f"(host clock, first call) | {smi}")
    log("time", f"search 128 queries over 1M, k=10: {search_ms:.4f} ms per batch, "
        f"{N_QUERY / search_ms * 1e3:.6g} QPS; plain route {search_plain_ms:.4f} ms, "
        f"{N_QUERY / search_plain_ms * 1e3:.6g} QPS; rerank=100 {rerank_ms:.4f} ms | {smi}")
    return t


def main() -> None:
    import torch

    smi = phase_device()
    build_s = phase_build()
    corpus, queries, g = make_data("cuda")
    log("data", f"Gaussian mixture on the card: corpus {tuple(corpus.shape)}, "
        f"queries {tuple(queries.shape)}, {N_CLUSTERS} clusters of rank-{LATENT} "
        f"covariance, seed {SEED}")
    res = phase_kernels(corpus, queries, g)
    kres = phase_ivf_kernels(corpus, g)
    main_res = phase_main_path(corpus, queries)
    ivf = phase_ivf_path(corpus, queries, main_res["gt"])
    k7_cases = phase_k7(queries, ivf)
    t = phase_timings(smi, corpus, queries, res, main_res)
    t.update(phase_ivf_timings(smi, corpus, queries, kres, ivf, k7_cases))
    log("time", f"kernel build {build_s:.2f} s | {smi}")

    launches = dict(main_res["launches"])
    for name in ("assign_fused", "lloyd_accumulate_fused", "ivf_probe_adc_fused"):
        launches[name] = ivf["launches"][name]
    src = "vq_tpu_torch/csrc/"
    tpu = "vq_tpu/ops/pallas_kernels.py:"
    kernels = [
        {"name": "pq_lloyd_accumulate_fused", "route": "cuda", "source": src + "pq_lloyd.cu",
         "replaces": tpu + "569", "launches": launches["pq_lloyd_accumulate_fused"],
         "max_abs_err": res["k3_err"], "ms": t["K3"][0], "plain_ms": t["K3"][1]},
        {"name": "pq_encode_fused", "route": "cuda", "source": src + "pq_encode.cu",
         "replaces": tpu + "379", "launches": launches["pq_encode_fused"],
         "max_abs_err": res["k4_err"], "ms": t["K4"][0], "plain_ms": t["K4"][1]},
        {"name": "adc_scan_topk_fused", "route": "cuda", "source": src + "adc_topk.cu",
         "replaces": tpu + "802", "launches": launches["adc_scan_topk_fused"],
         "max_abs_err": res["k5_err"], "ms": t["K5"][0], "plain_ms": t["K5"][1]},
        {"name": "assign_fused", "route": "cuda", "source": src + "assign.cu",
         "replaces": tpu + "137", "launches": launches["assign_fused"],
         "max_abs_err": kres["k1_err"], "ms": t["K1"][0], "plain_ms": t["K1"][1]},
        {"name": "lloyd_accumulate_fused", "route": "cuda", "source": src + "lloyd.cu",
         "replaces": tpu + "1473", "launches": launches["lloyd_accumulate_fused"],
         "max_abs_err": kres["k2_err"], "ms": t["K2"][0], "plain_ms": t["K2"][1]},
        {"name": "ivf_probe_adc_fused", "route": "cuda", "source": src + "ivf_probe.cu",
         "replaces": tpu + "1189", "also_replaces": tpu + "1147",
         "launches": launches["ivf_probe_adc_fused"], "max_abs_err": 0.0,
         "ms": t["K7_nprobe8"][0], "plain_ms": t["K7_nprobe8"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
