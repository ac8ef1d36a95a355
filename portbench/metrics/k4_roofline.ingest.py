"""``k4_roofline.ingest``: K4's least time over its time in the window's
``add`` calls, in percent. K4 (``csrc/pq_encode.cu``: the exact scans
``pq_scan_*``, or the tensor-core encode ``pq_encode_mma``) codes each
added row's residual: 2·n·m·k·s operations at the fp32 peak, or its
bytes (:func:`portbench.peaks.k4_encode`)."""

from portbench import peaks

KERNELS = ("pq_scan_", "pq_encode_mma")


def read(t):
    c = t.counters
    secs, launches = t.op_time(KERNELS)
    if not launches or secs <= 0 or "rows" not in c:
        return None
    return 100.0 * peaks.k4_encode(c["rows"], c["pq.m"], c["pq.k"], c["pq.s"]) / secs
