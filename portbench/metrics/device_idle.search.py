"""``device_idle.search``: one minus the share of the traced window in which
some operation ran on the card (the union of the kernels', copies' and
memsets' intervals), on each rank."""


def read(t):
    if t.window_s <= 0 or not t.ops:
        return None
    return 1.0 - t.busy_s() / t.window_s
