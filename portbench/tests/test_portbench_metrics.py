"""Each per-layer reader on a synthetic trace, and silent where it finds
nothing to read."""

import pytest

from portbench import peaks, spec
from portbench.profiling import Trace


def search_trace():
    ops = [("void ivf_probe_kernel<8>", 0.001, 0.003, "kernel"),
           ("pair_key_kernel", 0.0, 0.0005, "kernel"),
           ("cub::DeviceSegmentedRadixSortKernel", 0.003, 0.006, "kernel"),
           ("Memcpy DtoH (Device -> Pageable)", 0.0065, 0.007, "gpu_memcpy"),
           ("void ivf_probe_kernel<8>", 0.011, 0.013, "kernel")]
    spans = [("portbench.search", 0.0, 0.008), ("portbench.search", 0.010, 0.016)]
    t = Trace(ops, spans, [], (0.0, 0.016))
    t.counters.update({"k7.code_rows": 1e5, "k7.pair_rows": 4e5, "k7.pairs": 256.0,
                       "pq.m": 8, "pq.k": 256})
    return t


SEARCH = ("host_ms_per_batch", "launches_per_batch", "sort_share", "k7_roofline", "device_idle")


def test_search_readers():
    t = search_trace()
    read = {n: spec.load_metric(f"{n}.search").read(t) for n in SEARCH}
    busy = 0.0005 + 0.005 + 0.0005 + 0.002  # the probe and the sort overlap nothing else
    assert read["device_idle"] == pytest.approx(1 - busy / 0.016)
    # (8 ms - 6 ms busy) and (6 ms - 2 ms busy) over two calls
    assert read["host_ms_per_batch"] == pytest.approx(3.0)
    assert read["launches_per_batch"] == 2.0
    assert read["sort_share"] == pytest.approx(0.003 / 0.008)
    least = peaks.k7_probe(1e5, 4e5, 256, 8, 256)
    assert read["k7_roofline"] == pytest.approx(100 * least / 0.0045)


@pytest.mark.parametrize("name", SEARCH)
def test_the_batch_cells_readers_read_as_the_search_cells(name):
    t = search_trace()
    assert spec.load_metric(f"{name}.batch").read(t) == spec.load_metric(f"{name}.search").read(t)


@pytest.mark.parametrize("name", ["k7_roofline.search", "k1_roofline.ingest",
                                  "k4_roofline.ingest", "sort_share.search",
                                  "host_ms_per_batch.search", "device_idle.ingest",
                                  "k7_roofline.batch", "sort_share.batch"])
def test_silent_without_the_kernels(name):
    t = Trace([], [], [], (0.0, 1.0))
    assert spec.load_metric(name).read(t) is None
