"""``launches_per_batch.search``: the kernels the profiler records in the
window over the window's search calls. A count: it repeats exactly for a
fixed program and traffic."""

SPAN = "portbench.search"


def read(t):
    calls = len(t.span_list(SPAN))
    kernels = sum(1 for _, _, _, kind in t.ops if kind == "kernel")
    if not calls or not kernels:
        return None
    return kernels / calls
