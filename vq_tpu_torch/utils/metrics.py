"""Structured metrics and profiler spans — the port of
``vq_tpu.utils.metrics``.

* :class:`MetricsLogger`: an append-only JSONL event stream (a file,
  stdout or a callback), each event stamped with ``event`` and
  ``t_wall``.
* :func:`trace`: a named span on the ``torch.profiler`` timeline
  (``torch.profiler.record_function``), where the JAX package opens a
  ``jax.profiler.TraceAnnotation``.

>>> events = []
>>> log = MetricsLogger(events.append)
>>> log.log("train", iters=3)
>>> events[0]["event"], events[0]["iters"]
('train', 3)
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import IO, Any, Callable, Dict, Optional

__all__ = ["MetricsLogger", "trace"]


class MetricsLogger:
    """Append-only JSONL event logger. ``sink`` is a path (appended to),
    a file object, ``"-"`` (stdout) or a callable taking each event
    dict."""

    def __init__(self, sink: "str | IO[str] | Callable[[Dict], None]" = "-"):
        self._own = False
        self._fn: Optional[Callable[[Dict], None]] = None
        self._fh = None
        if callable(sink):
            self._fn = sink
        elif sink == "-":
            self._fh = sys.stdout
        elif isinstance(sink, str):
            self._fh = open(sink, "a")
            self._own = True
        else:
            self._fh = sink
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t_wall": round(time.perf_counter() - self._t0, 6)}
        rec.update(fields)
        if self._fn is not None:
            self._fn(rec)
        else:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._own and self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def trace(name: str):
    """A span named ``name`` on the ``torch.profiler`` timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
