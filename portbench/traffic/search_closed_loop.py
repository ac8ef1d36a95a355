"""Closed-loop search: one client sends a batch of queries, waits for the
ids on the host, and sends the next.

Traffic parameters: ``batch`` queries a call, drawn in a seeded order
(whole seeded permutations of the query pool, one after another),
``k``, ``nprobe``, ``warmup_calls`` calls of the same shapes in the
set-up, and ``check_calls`` calls drawn from the seed (the last, and a
seeded reservoir sample of the others) whose answers the reference
judges; the others' answers are dropped as they come.

End-to-end: ``qps`` (queries answered over the window's whole time) and
``batch_p95_ms`` (the nearest-rank 95th percentile over all calls, each
from submission to its ids and distances on the host).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from portbench import ivf_cell, profiling, stats
from portbench.reference import ivfpq as ref


def _batches(b, pool: torch.Tensor, batch: int, count: int):
    """``count`` host batches ``(rows, queries)`` in the seeded order."""
    g = torch.Generator().manual_seed(b.seed & 0x7FFFFFFFFFFF)
    need = count * batch
    order = torch.cat([torch.randperm(pool.shape[0], generator=g)
                       for _ in range(-(-need // pool.shape[0]))])
    return [(order[i * batch:(i + 1) * batch],
             pool[order[i * batch:(i + 1) * batch]].contiguous()) for i in range(count)]


def run(b) -> dict:
    tr = b.traffic
    batch, k, nprobe = int(tr["batch"]), int(tr["k"]), int(tr["nprobe"])
    with ivf_cell.device_scope(b):
        idx, base, queries, train, starts, paths = ivf_cell.build(b)
        pool = queries.cpu()
        batches = _batches(b, pool, batch, int(tr["distinct_batches"]))

        def call(qb):
            with profiling.span(b.trace, "portbench.search"):
                ids, d = idx.search(qb, k=k, nprobe=nprobe)
                return ids.cpu(), d.cpu()

        for i in range(int(tr["warmup_calls"])):
            call(batches[i % len(batches)][1])
        ivf_cell.sync(b)
        # The set-up's objects leave the collector's generations, so that a
        # collection in the window costs what the window allocates.
        gc.collect()
        gc.freeze()
        b.setup_done()

        n_keep = max(int(tr["check_calls"]) - 1, 0)
        pick = random.Random(b.seed ^ 0x5EED)
        kept, ends, lat = [], [], []
        with profiling.traced(b.trace, b.device) as box:
            with profiling.span(b.trace, profiling.WINDOW):
                t_start = time.perf_counter()
                while True:
                    i = len(lat)
                    j = i % len(batches)
                    t0 = time.perf_counter()
                    out = (j,) + call(batches[j][1])
                    t1 = time.perf_counter()
                    lat.append(t1 - t0)
                    ends.append(t1)
                    if t1 - t_start >= b.seconds:
                        break
                    if i < n_keep:  # reservoir sampling, seeded
                        kept.append(out)
                    elif n_keep and (r := pick.randrange(i + 1)) < n_keep:
                        kept[r] = out
        window_s = t1 - t_start
        calls = len(lat)
        kept.append(out)  # the last call's answers are always judged
        peak = torch.cuda.max_memory_allocated() if b.device == "cuda" else 0
        e2e = {"qps": stats.rate(calls * batch, window_s),
               "batch_p95_ms": stats.percentile(lat, 95.0) * 1e3}
        b.log(f"window: {calls} calls of {batch} queries in {window_s:.3f} s; median call "
              f"{stats.percentile(lat, 50.0) * 1e3:.3f} ms; queries/s by quarter of the window "
              + " ".join(f"{q:.1f}" for q in stats.quarter_rates(ends, t_start, batch)))

        prog = ivf_cell.program_side(idx, paths, base.shape[0])
        del idx
        if b.device == "cuda":
            torch.cuda.empty_cache()

        dev = base.device
        q = torch.cat([batches[j][1] for j, _, _ in kept]).to(dev)
        lim = b.limits

        def judged(side, ids, dists):
            checks, enc = ivf_cell.index_checks(b, side, base, train)
            dist_gap, miss_gap, bad = ref.search_gaps(q, ids, dists, enc, side.coarse, nprobe,
                                                      k, stored=side.recon)
            return checks + [("dist_gap", dist_gap, lim["dist_gap"]),
                             ("miss_gap", miss_gap, lim["miss_gap"]),
                             ("bad_ids", float(bad), 0.0)], enc

        ids = torch.cat([o[1] for o in kept]).to(dev)
        checks, enc = judged(prog, ids, torch.cat([o[2] for o in kept]).to(dev))
        ivf_cell.report_quality(b, q, ids, base, enc, prog.coarse, k, nprobe)

        control = []
        if b.control:
            side, enc_c = ivf_cell.control_side(b, base, train, starts)
            with ivf_cell.tf32():
                ids_c, d_c = ref.search(q, enc_c, side.coarse, nprobe, k, dtype=torch.float32)
            del enc_c
            control, _ = judged(side, ids_c, d_c)

        ranks = []
        if b.trace:
            t = box[0]
            sent = [(qb, len(range(j, calls, len(batches)))) for j, (_, qb) in enumerate(batches)]
            t.counters.update(ivf_cell.probe_counters(sent, enc, prog.coarse, nprobe,
                                                       prog.codebooks))
            t.counters["calls"] = calls
            ranks.append({"metrics": b.layer_metrics(t), "busy_s": t.busy_s(),
                          "window_s": t.window_s, "breakdown": t.breakdown()})
    return {"attempted": calls * batch, "failed": 0, "e2e": e2e, "checks": checks,
            "memory_peak_bytes": peak, "ranks": ranks, "control": control}
