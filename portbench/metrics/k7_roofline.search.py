"""``k7_roofline.search``: K7's least time over its time, in percent.

K7 (``csrc/ivf_probe.cu``) is its launches as the profiler names them:
the pairs' keys, the work list over them, the quads' records, and the
sums. Its least time (:func:`portbench.peaks.k7_probe`) counts, summed
over the window's calls, the codes of the live rows of the lists each
call probes, the tables of its (query, list) pairs and one f32 sum a
live row of a pair: what these inputs need, not the padded width."""

from portbench import peaks

KERNELS = ("pair_key_kernel", "entry_pass_kernel", "bin_scan_kernel", "bin_cursor_kernel",
           "entry_scatter_kernel", "quad_info_kernel", "ivf_probe_kernel")


def read(t):
    c = t.counters
    secs, launches = t.op_time(KERNELS)
    if not launches or secs <= 0 or "k7.pairs" not in c:
        return None
    least = peaks.k7_probe(c["k7.code_rows"], c["k7.pair_rows"], c["k7.pairs"], c["pq.m"],
                           c["pq.k"])
    return 100.0 * least / secs
