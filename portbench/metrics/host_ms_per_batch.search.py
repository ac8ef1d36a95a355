"""``host_ms_per_batch.search``: the mean over the window's search calls of
each call's wall time (the benchmark's ``portbench.search`` span, from
submission to the answers on the host) less the time inside it in which
the card was busy: what the host alone adds to a call."""

from portbench import stats

SPAN = "portbench.search"


def read(t):
    spans = t.span_list(SPAN)
    if not spans or not t.ops:
        return None
    busy = t.busy()
    return 1e3 * sum((b - a) - stats.covered(busy, a, b) for a, b in spans) / len(spans)
