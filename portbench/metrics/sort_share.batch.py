"""``sort_share.batch``: ``sort_share.search`` in the cells that report
``qps.batch``, which it moves."""

from portbench import spec

read = spec.load_metric("sort_share.search").read
