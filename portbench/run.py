"""The benchmark of ``vq_tpu_torch`` on NVIDIA cards.

Run from the root of a checkout::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's data from ``--seed`` on the card, sets the program up
(timed as ``setup_s``), drives the cell's traffic for ``--seconds``, and
then holds what the window produced to the plain reference under
``portbench/reference``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from
``torch.profiler`` over the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
The same numbers are the last lines of standard error.

Options for the CPU tests and the chip's control runs, which the
benchmark's own runs never pass: ``--device cpu`` runs on the CPU with
the plain versions of the kernels; ``--tiny`` takes the cell's small test
sizes; ``--control 1`` judges the control in the program's place (the
reference at the precision below the configuration's, from the same data
and starts): its numbers take the place of the program's in ``checks``,
so a control that the limits catch reads ``correct: false``;
``--fault <name>`` plants a fault in the timed path; ``--data-seed <n>``
draws the data and the trainers' starts from ``n`` in place of the
configuration's ``data_seed`` (the runs that read a limit's lower end on
other indexes).

A cell reports its end-to-end metric ``<quantity>.<suffix>`` as the
quantity its driver measures (``qps.batch`` is the driver's ``qps``), so
that cells with bounds of their own share a driver.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vq_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "nv_compute_cache"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; no JAX behind a library."""
    for var, sub in CACHE_DIRS.items():
        path = root / "build" / "portbench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Bench:
    """What a traffic driver is given: the cell, its configuration, the
    run's options, a log on standard error and the set-up clock."""

    def __init__(self, args, workload: dict, config: dict, bench: dict):
        self.name = args.workload
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.device = args.device
        self.tiny = bool(args.tiny)
        self.control = bool(int(args.control))
        self.fault = args.fault
        self.workload = workload
        self.traffic = workload["traffic"]
        self.limits = workload["limits"]
        self.config = config
        self.chips = int(workload["chips"])
        self.benchmark = bench
        self.process_start = PROCESS_START
        self.setup_s = None

    def log(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> float:
        """Marks the start of the first timed operation."""
        self.setup_s = time.time() - PROCESS_START
        return self.setup_s

    def layer_metrics(self, trace) -> dict:
        """``{name: value}`` of the cell's per-layer metrics that find
        something to read in ``trace``."""
        from portbench import spec

        reported = [m["name"] for m in spec.cell_metrics(self.benchmark, self.name, "end_to_end")]
        out = {}
        for m in spec.cell_metrics(self.benchmark, self.name, "per_layer", reported):
            v = spec.load_metric(m["name"]).read(trace)
            if v is not None:
                out[m["name"]] = float(v)
        return out


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--data-seed", type=int, default=None)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def aggregate(ranks: list) -> tuple:
    """Per-layer values, busy and window seconds: the mean over the ranks
    that read each."""
    names = sorted({n for r in ranks for n in r["metrics"]})
    values = {n: sum(v) / len(v) for n in names
              for v in [[r["metrics"][n] for r in ranks if n in r["metrics"]]]}
    busy = sum(r["busy_s"] for r in ranks) / len(ranks)
    window = sum(r["window_s"] for r in ranks) / len(ranks)
    return values, busy, window


def main(argv=None) -> int:
    args = parse(argv)
    here = Path(__file__).resolve().parent
    root = here.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    set_environment(root)
    from portbench import spec

    bench = spec.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    workload, config = spec.load_cell(args.workload, tiny=args.tiny)
    if args.data_seed is not None:
        config = {**config, "generator": {**config["generator"], "data_seed": args.data_seed}}

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: no CUDA device (torch.cuda.is_available() is false)",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < int(workload["chips"]):
            print(f"portbench: the cell needs {workload['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 3
    torch.set_num_threads(4)
    b = Bench(args, workload, config, bench)
    res = spec.load_driver(workload["driver"]).run(b)
    res["e2e"]["setup_s"] = b.setup_s

    checks = res["control"] if b.control else res["checks"]
    correct = (res["attempted"] > 0 and res["failed"] == 0
               and all(v <= lim for _, v, lim in checks))
    unit = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if b.trace:
        values, busy, window = aggregate(res["ranks"])
    else:
        names = [m["name"] for m in spec.cell_metrics(bench, b.name, "end_to_end")]
        values = {n: res["e2e"][n.split(".")[0]] for n in names}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
              "count": b.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if b.trace:
        device.update(busy_s=busy, window_s=window)
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]),
           "metrics": {n: {"value": v, "unit": unit[n]} for n, v in values.items()},
           "device": device}
    if b.trace:
        out["breakdown"] = res["ranks"][0]["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    if args.device == "cuda":
        b.log(f"card: {card_line()}")
    if b.control:
        b.log("the checks below are the control's, in the program's place")
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
