"""``host_ms_per_batch.batch``: ``host_ms_per_batch.search`` in the cells that report
``qps.batch``, which it moves."""

from portbench import spec

read = spec.load_metric("host_ms_per_batch.search").read
