"""``sort_share.search``: the device time of the sort kernels (the stable
sorts of the top-k merges, by kernel name) over all device time in the
window."""

KERNELS = ("Sort", "sort")


def read(t):
    total = sum(b - a for _, a, b, _ in t.ops)
    if total <= 0:
        return None
    return t.op_time(KERNELS)[0] / total
