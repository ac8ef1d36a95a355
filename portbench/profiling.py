"""The traced window: ``torch.profiler`` over the window, its device
operations and the benchmark's own spans on one clock, and the breakdown
the result line carries.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``
that the traffic drivers open around their calls into the program; the
window itself is the span ``portbench.window``.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench import stats

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


@dataclass
class Trace:
    """One rank's traced window. Times are seconds on the profiler's clock.

    ``ops``: device operations ``(name, start, end, kind)``; ``spans``:
    the benchmark's spans ``(name, start, end)``; ``host``: the host's
    top-level operators ``(name, start, end)``; ``counters``: what the
    driver counted in the window (calls, rows) and the inputs of the
    kernels' bounds."""

    ops: List[Tuple[str, float, float, str]]
    spans: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    counters: Dict[str, float] = field(default_factory=dict)
    _busy: Optional[List[Tuple[float, float]]] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        if self._busy is None:
            lo, hi = self.window
            self._busy = stats.union((max(a, lo), min(b, hi)) for _, a, b, _ in self.ops)
        return self._busy

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def op_time(self, keys, kind: Optional[str] = "kernel") -> Tuple[float, int]:
        """``(seconds, launches)`` of the operations whose names hold one of
        ``keys``."""
        t, n = 0.0, 0
        for name, a, b, k in self.ops:
            if (kind is None or k == kind) and any(key in name for key in keys):
                t += b - a
                n += 1
        return t, n

    def span_list(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for s, a, b in self.spans if s == name]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing at each gap's middle."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, a, b, _ in self.ops:
            by_op[name[:120]] += b - a
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in stats.gaps(self.busy(), *self.window):
            mid = 0.5 * (a + b)
            label = "no host operator"
            # the latest-started operator still running at the gap's middle
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                name, s, e = host[i]
                if e >= mid:
                    label = name[:120]
                    break
                if mid - s > 0.5:
                    break
            idle[label] += b - a

        def best(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": best(by_op), "idle_gaps": best(idle)}


def span(enabled: bool, name: str):
    """A ``portbench.*`` span around a call into the program, recorded only
    in a traced run."""
    if enabled:
        import torch

        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def traced(enabled: bool, device_type: str):
    """Profiles the block when ``enabled``; yields a list that receives the
    :class:`Trace` once the block has ended (empty when not enabled)."""
    box: list = []
    if not enabled:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        yield box
    box.append(_parse(prof, torch))


def _kind(e, device) -> str:
    """The activity kind of a profiler event: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``gpu_user_annotation``, ``user_annotation`` or
    ``cpu_op`` (read from its name where the event has no kind)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if e.device_type() == device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "gpu_user_annotation" if name.startswith("portbench.") else "kernel"
    return "user_annotation" if name.startswith("portbench.") else "cpu_op"


def _parse(prof, torch) -> Trace:
    ops, spans, host, window = [], [], [], None
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    device = torch.autograd.DeviceType.CUDA
    for e in events:
        name, kind = e.name(), _kind(e, device)
        a = (e.start_ns() - base) * 1e-9
        b = a + e.duration_ns() * 1e-9
        if kind in DEVICE_KINDS:
            ops.append((name, a, b, kind))
        elif kind == "user_annotation" and name.startswith("portbench."):
            if name == WINDOW:
                window = (a, b)
            else:
                spans.append((name, a, b))
        elif kind == "cpu_op":
            host.append((name, a, b))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    return Trace(ops, spans, host, window)
