"""The arithmetic of the window on synthetic timelines."""

import pytest

from portbench import peaks, stats
from portbench.profiling import Trace


def test_union_of_overlapping_intervals():
    got = stats.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5), (9, 9)])
    assert got == [(0, 4), (5, 7)]


def test_covered_and_gaps():
    merged = stats.union([(0, 2), (1, 3), (5, 7)])
    assert stats.covered(merged, 1, 6) == pytest.approx(3.0)
    assert stats.gaps(merged, -1, 8) == [(-1, 0), (3, 5), (7, 8)]


def test_percentile_is_nearest_rank_over_all_samples():
    vals = [1.0] * 95 + [50.0] * 5
    assert stats.percentile(vals, 95) == 1.0
    assert stats.percentile(vals + [50.0], 95) == 50.0
    assert stats.percentile([3.0], 95) == 3.0


def test_a_stall_moves_the_tail_and_the_rate():
    """100 calls of 10 ms; a 2 s stall inside the window on six of them
    moves the 95th percentile and the rate over the window's whole time."""
    steady = [0.010] * 100
    stalled = [0.010] * 94 + [0.010 + 2.0 / 6] * 6
    assert stats.percentile(steady, 95) == pytest.approx(0.010)
    assert stats.percentile(stalled, 95) > 0.3
    assert stats.rate(100 * 128, sum(steady)) == pytest.approx(12800 / 1.0)
    assert stats.rate(100 * 128, sum(stalled)) == pytest.approx(12800 / 3.0)


def test_quarter_rates_show_a_slow_stretch():
    """Four calls over a 4 s window, then one that takes 2 s: the window is
    6 s, its quarters 1.5 s, and each call counts once, in the quarter in
    which it ends."""
    assert stats.quarter_rates([0.9, 1.9, 2.9, 4.0], 0.0, 128) == pytest.approx([128.0] * 4)
    ends = [1.0, 2.0, 3.0, 4.0]
    slow = stats.quarter_rates(ends + [6.0], 0.0, 128)
    assert slow == pytest.approx([128 / 1.5, 128 / 1.5, 256 / 1.5, 128 / 1.5])
    assert stats.quarter_rates([], 0.0) == []


def test_trace_idle_busy_and_kernel_time():
    ops = [("ivf_probe_kernel", 0.0, 1.0, "kernel"), ("DeviceRadixSort", 0.5, 2.0, "kernel"),
           ("Memcpy DtoH", 3.0, 3.5, "gpu_memcpy"), ("ivf_probe_kernel", 9.0, 11.0, "kernel")]
    t = Trace(ops, [("portbench.search", 0.0, 4.0), ("portbench.search", 4.0, 10.0)],
              [("aten::sort", 4.0, 8.5)], (0.0, 10.0))
    assert t.busy() == [(0.0, 2.0), (3.0, 3.5), (9.0, 10.0)]
    assert t.busy_s() == pytest.approx(3.5)
    assert t.op_time(("Sort",)) == (1.5, 1)
    assert t.op_time(("ivf_probe",)) == (3.0, 2)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["ivf_probe_kernel", 3.0]
    assert bd["idle_gaps"] == [["aten::sort", 5.5], ["no host operator", 1.0]]


def test_bounds():
    assert peaks.bound(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound(0.0, 67e12) == pytest.approx(1.0)
    # K1 on 1M x 1024 x 128 is bound by its operations: 2nkd / 67 TFLOP/s
    assert peaks.k1_assign(10**6, 1024, 128) == pytest.approx(2.0 * 10**6 * 1024 * 128 / 67e12)
    # K7 is bound by its bytes: codes, tables and sums
    k7 = peaks.k7_probe(10**6, 8 * 10**6, 8192, 8, 256)
    assert k7 == pytest.approx((10**6 * 8 + 8192 * 8 * 256 * 4 + 8 * 10**6 * 4) / 3.35e12)


class _Event:
    """A profiler event of a torch whose events carry no activity kind."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


@pytest.mark.parametrize("name,on_device,kind", [
    ("ivf_probe_kernel", True, "kernel"), ("Memcpy DtoH (Device -> Pageable)", True, "gpu_memcpy"),
    ("Memset (Device)", True, "gpu_memset"), ("portbench.search", True, "gpu_user_annotation"),
    ("portbench.search", False, "user_annotation"), ("aten::sort", False, "cpu_op")])
def test_event_kind_from_its_name(name, on_device, kind):
    import torch

    from portbench.profiling import _kind

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    assert _kind(_Event(name, cuda if on_device else cpu), cuda) == kind
