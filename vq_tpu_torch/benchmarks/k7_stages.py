"""K7 (the IVF-PQ / IVF-RQ probe ADC sums) of this checkout beside other
checkouts', by device time, on one card.

    python3 -m vq_tpu_torch.benchmarks.k7_stages [DIR ...]

Each ``DIR`` is another checkout of the repository (a parent commit from
``git archive``, or a copy of the package with one kernel changed),
loaded as ``pq_scan_ab --against`` loads it: its own kernel library,
built from its own sources. On ``pq_scan_ab``'s seeded mixture and its
IVF-PQ index (IVF1024, PQ 8x256 on residuals, the 1M rows added, 128
queries) at nprobe 8 and 64, each checkout in turn, two rounds, gives:

* K7's device time a call by launch (``torch.profiler`` over 10 calls:
  the pairs' bins, K6's work list over them, the quads' records, the
  sums; a checkout before the list-major design has the sums alone);
* its host enqueue time a call (50 calls on the host clock, no sync
  between them);
* the device time of one ``IVFPQIndex.search(k=10)`` with that
  checkout's K7 in place of this one's.

``pq_scan_ab`` times calls back to back by CUDA events, so where a call's
enqueue outlasts its device time (K7 at nprobe 8) it times the host; this
script keeps the two apart. One JSON line a (round, checkout, nprobe);
the last line is the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

import torch

from vq_tpu_torch.benchmarks import pq_scan_ab as ab

STAGES = (("keys", "pair_key_kernel"), ("memset", "Memset"), ("entry pass", "entry_pass_kernel"),
          ("scan", "bin_scan_kernel"), ("cursor", "bin_cursor_kernel"),
          ("scatter", "entry_scatter_kernel"), ("records", "quad_info_kernel"),
          ("sums", "ivf_probe_kernel"))
CALLS, ENQUEUE_CALLS = 10, 50


def device_ms(fn, calls: int, key: str = "") -> dict:
    """``{kernel name: device ms a call}`` of ``calls`` calls of ``fn``
    (after a warm-up), profiled again (up to 3 times) where no kernel
    holding ``key`` was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        out = {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
               if e.device_type == cuda}
        if any(key in k for k in out):
            return out
    return out


def main(argv: Sequence[str] = ()) -> int:
    import vq_tpu_torch
    import vq_tpu_torch.ivf as ivf
    from vq_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        raise SystemExit("k7_stages: needs an NVIDIA GPU")
    mods = {"this": ck}
    for root in argv:
        mods[root] = ab.other_kernels(Path(root).resolve())
    x, _ = ab.make_operands("cuda")
    queries = ab._queries(x)
    index = vq_tpu_torch.IVFPQIndex.train(x[:ab.IVF_TRAIN], ab.NLIST, ab.M, ab.K, max_iters=10)
    index.add(x)
    ops = ab._recorded(ivf, "ivf_probe_adc_fused", {"": index}, queries, "K7")
    kernel = ivf.ivf_probe_adc_fused
    for rnd in range(2):
        for tag, mod in mods.items():
            for (name, (a, kw)), p in zip(ops.items(), ab.NPROBES):
                k7 = device_ms(lambda: mod.ivf_probe_adc_fused(*a, **kw), CALLS, "ivf_probe_kernel")
                stages = {s: sum(v for k, v in k7.items() if key in k) for s, key in STAGES}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ENQUEUE_CALLS):
                    mod.ivf_probe_adc_fused(*a, **kw)
                enqueue = (time.perf_counter() - t0) / ENQUEUE_CALLS * 1e3
                torch.cuda.synchronize()
                ivf.ivf_probe_adc_fused = mod.ivf_probe_adc_fused
                try:
                    search = device_ms(lambda: index.search(queries, k=10, nprobe=p), 3,
                                       "ivf_probe_kernel")
                finally:
                    ivf.ivf_probe_adc_fused = kernel
                print(json.dumps({"round": rnd, "checkout": tag, "case": name,
                                  "k7_device_ms": sum(stages.values()),
                                  "stages_ms": {s: v for s, v in stages.items() if v},
                                  "enqueue_ms": enqueue,
                                  "search_device_ms": sum(search.values())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
