"""``device_idle.batch``: ``device_idle.search`` in the cells that report
``qps.batch``, which it moves."""

from portbench import spec

read = spec.load_metric("device_idle.search").read
