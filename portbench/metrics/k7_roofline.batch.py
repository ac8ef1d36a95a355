"""``k7_roofline.batch``: ``k7_roofline.search`` in the cells that report
``qps.batch``, which it moves."""

from portbench import spec

read = spec.load_metric("k7_roofline.search").read
