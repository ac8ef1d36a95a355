"""Finds a cell's files by name.

``BENCHMARK.json`` (at the checkout's root) names the metrics and cells.
Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own under this folder:

* ``configs/<config>.json`` -- the configuration: source, sizes,
  ``reduced``, ``assumed`` and the data generator's parameters;
* ``workloads/<cell>.json`` -- the cell: its configuration, chips, the
  traffic driver's name, the traffic's parameters and the limits of the
  comparison that decides ``correct``;
* ``traffic/<driver>.py`` -- a traffic driver, found by name;
* ``metrics/<metric>.py`` -- one reader a per-layer metric.

A new cell, configuration or metric is new files and new entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _find(kind: str, name: str, suffix: str, dirs: Optional[Iterable[Path]] = None) -> Path:
    for d in list(dirs or []) + [HERE / kind]:
        p = Path(d) / f"{name}{suffix}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {kind[:-1]} named {name!r} under {HERE / kind}")


def load_json(kind: str, name: str, dirs=None) -> dict:
    with open(_find(kind, name, ".json", dirs)) as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, dirs=None, tiny: bool = False):
    """``(workload, config)`` of the cell ``name``; ``tiny`` applies both
    files' ``tiny`` overrides (the CPU tests' sizes)."""
    wl = load_json("workloads", name, dirs)
    cfg = load_json("configs", wl["config"], dirs)
    if tiny:
        wl = {**wl, "traffic": {**wl["traffic"], **wl.get("tiny", {})}}
        cfg = {**cfg, **cfg.get("tiny", {})}
    return wl, cfg


def load_driver(name: str):
    return importlib.import_module(f"portbench.traffic.{name}")


def load_metric(name: str, dirs=None):
    """The reader module of per-layer metric ``name`` (``read(trace)``)."""
    path = _find("metrics", name, ".py", dirs)
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported: Iterable[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell_metrics(bench: dict, cell: str, section: str, reported=()) -> List[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those whose ``workloads`` name it, or, without that key,
    all end-to-end metrics and the per-layer ones that move an end-to-end
    metric the cell reports."""
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return [m for m in bench[section] if _applies(m, cell, reported)]
