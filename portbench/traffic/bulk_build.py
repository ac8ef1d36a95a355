"""Repeated bulk builds: each step empties the index (a fresh
``IVFPQIndex`` over the trained coarse centroids and PQ) and adds the
base rows in the configuration's ``add_blocks`` blocks, then waits for
the card.

Traffic parameters: ``warmup_builds`` builds in the set-up (the set-up's
own build is the first). End-to-end: ``add_rows_per_s``, every row added
over the window's whole time, the emptying included.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import ivf_cell, profiling, stats


def run(b) -> dict:
    from vq_tpu_torch import IVFPQIndex

    cfg = b.config
    with ivf_cell.device_scope(b):
        idx, base, _, train, starts, paths = ivf_cell.build(b)
        coarse, pq = idx.coarse, idx.pq
        n = base.shape[0]

        def step():
            with profiling.span(b.trace, "portbench.build"):
                new = IVFPQIndex(coarse, pq)
                ivf_cell.add_blocks(new, base, cfg["add_blocks"])
                ivf_cell.sync(b)
            return new

        for _ in range(int(b.traffic["warmup_builds"])):
            idx = step()
        gc.collect()
        gc.freeze()
        b.setup_done()

        ends = []
        with profiling.traced(b.trace, b.device) as box:
            with profiling.span(b.trace, profiling.WINDOW):
                t_start = time.perf_counter()
                while True:
                    idx = None
                    idx = step()
                    t1 = time.perf_counter()
                    ends.append(t1)
                    if t1 - t_start >= b.seconds:
                        break
        window_s = t1 - t_start
        builds = len(ends)
        peak = torch.cuda.max_memory_allocated() if b.device == "cuda" else 0
        e2e = {"add_rows_per_s": stats.rate(builds * n, window_s)}
        b.log(f"window: {builds} builds of {n} rows in {window_s:.3f} s; rows/s by quarter of "
              "the window " + " ".join(f"{r:.0f}" for r in stats.quarter_rates(ends, t_start, n)))

        prog = ivf_cell.program_side(idx, paths, n)
        codebooks = prog.codebooks
        del idx, pq, coarse
        if b.device == "cuda":
            torch.cuda.empty_cache()
        checks, enc = ivf_cell.index_checks(b, prog, base, train)
        mx, fac = ivf_cell.imbalance(enc.lists, prog.coarse.shape[0])
        b.log(f"list sizes max/mean {mx:.3f}, imbalance factor {fac:.4f}")
        control = []
        if b.control:
            side, _ = ivf_cell.control_side(b, base, train, starts)
            control, _ = ivf_cell.index_checks(b, side, base, train)

        ranks = []
        if b.trace:
            t = box[0]
            m, kk, s = codebooks.shape
            t.counters.update({"rows": float(builds * n), "nlist": prog.coarse.shape[0],
                               "dim": prog.coarse.shape[1], "pq.m": m, "pq.k": kk, "pq.s": s,
                               "calls": builds})
            ranks.append({"metrics": b.layer_metrics(t), "busy_s": t.busy_s(),
                          "window_s": t.window_s, "breakdown": t.breakdown()})
    return {"attempted": builds, "failed": 0, "e2e": e2e, "checks": checks,
            "memory_peak_bytes": peak, "ranks": ranks, "control": control}
