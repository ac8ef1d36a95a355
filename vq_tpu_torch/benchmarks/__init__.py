"""Twins of the repo's benchmark scripts that hold TPU kernels, on the
card: :mod:`.mpacked_encode` (``benchmarks/mpacked_encode.py``, B1) and
:mod:`.adc_vmem_bench` (``benchmarks/adc_vmem_bench.py``, B2-B4). Each
keeps its script's flags and JSON lines, holds its kernels beside their
plain PyTorch versions, and runs as ``python3 -m
vq_tpu_torch.benchmarks.<name>`` on the card (``--device cpu`` runs the
plain versions and reports no times).

The scripts under ``benchmarks/`` stay as they are; nothing here imports
them or JAX. :mod:`.pq_scan_ab` is not a twin: it runs K2, K3, K4 (at
each precision) and K6 beside another checkout's on one card
(``--against DIR``), whether they agree, and timed in alternating rounds.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Optional

import torch

__all__ = ["Emitter", "cuda_ms", "device_name", "timed"]


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds a call by CUDA events, after one warm-up call."""
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


def device_name(device: torch.device) -> str:
    """The card's name, or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class Emitter:
    """Writes one JSON object a line to stdout (``"-"``) or appends to a
    file, each stamped with the device it ran on."""

    def __init__(self, output: str, device: torch.device):
        self.out = sys.stdout if output == "-" else open(output, "a")
        self.device = device_name(device)

    def __call__(self, **fields) -> None:
        self.out.write(json.dumps({**fields, "device": self.device}) + "\n")
        self.out.flush()

    def close(self) -> None:
        if self.out is not sys.stdout:
            self.out.close()


def timed(device: torch.device, fn: Callable[[], object], reps: int) -> Optional[float]:
    """CUDA-event milliseconds on the card; ``None`` elsewhere (a host
    clock on the CPU is no device time)."""
    return cuda_ms(fn, reps) if device.type == "cuda" else None
