"""``k1_roofline.ingest``: K1's least time over its time in the window's
``add`` calls, in percent. K1 (``csrc/assign.cu``, ``assign_kernel``)
finds each added row's list: 2·n·nlist·d operations at the fp32 peak, or
its bytes, whichever is longer (:func:`portbench.peaks.k1_assign`)."""

from portbench import peaks

KERNELS = ("assign_kernel",)


def read(t):
    c = t.counters
    secs, launches = t.op_time(KERNELS)
    if not launches or secs <= 0 or "rows" not in c:
        return None
    return 100.0 * peaks.k1_assign(c["rows"], c["nlist"], c["dim"]) / secs
