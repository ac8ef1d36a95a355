"""Sharded training, encoding and serving on ``torch.distributed`` — the
port of ``vq_tpu.parallel``: one process a device, a ``(data, sub)``
``DeviceMesh``, the corpus row-sharded as DTensors, and the JAX package's
``psum`` / ``all_gather`` merges as ``dist.all_reduce`` /
``dist.all_gather`` on the mesh's groups. Serving shards the flat
indexes' rows, the IVF indexes' lists (:func:`sharded_ivf_search`,
:func:`sharded_ivf_scan_search`) and a graph search's queries
(:func:`sharded_graph_search`), and :func:`sharded_refine_search`
re-scores any of them with a replicated refiner.
"""

from vq_tpu_torch.parallel.data import sharded_from_callback, sharded_synthetic_corpus
from vq_tpu_torch.parallel.encode import sharded_pq_encode, sharded_quantize
from vq_tpu_torch.parallel.flat import sharded_flat_search, sharded_flat_search_core
from vq_tpu_torch.parallel.graph import sharded_graph_search, sharded_graph_search_core
from vq_tpu_torch.parallel.ivf import shard_buckets, sharded_ivf_search, sharded_ivf_search_core
from vq_tpu_torch.parallel.ivf_scan import sharded_ivf_scan_search, sharded_scan_search_core
from vq_tpu_torch.parallel.kmeans import ShardedKMeansResult, sharded_lloyd, sharded_pq_train
from vq_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SUBSPACE_AXIS,
    gather_global,
    init_distributed,
    make_mesh,
    mesh_device,
    replicate,
    shard_rows,
)
from vq_tpu_torch.parallel.opq import sharded_opq_train
from vq_tpu_torch.parallel.refine import sharded_refine_search, sharded_refine_search_core
from vq_tpu_torch.parallel.stream import sharded_pq_minibatch_update

__all__ = [
    "DATA_AXIS",
    "SUBSPACE_AXIS",
    "make_mesh",
    "init_distributed",
    "replicate",
    "shard_rows",
    "mesh_device",
    "gather_global",
    "ShardedKMeansResult",
    "sharded_lloyd",
    "sharded_pq_train",
    "sharded_opq_train",
    "sharded_pq_minibatch_update",
    "sharded_from_callback",
    "sharded_synthetic_corpus",
    "sharded_pq_encode",
    "sharded_quantize",
    "sharded_ivf_search",
    "sharded_ivf_search_core",
    "sharded_scan_search_core",
    "sharded_ivf_scan_search",
    "sharded_graph_search",
    "sharded_graph_search_core",
    "sharded_flat_search",
    "sharded_flat_search_core",
    "sharded_refine_search",
    "sharded_refine_search_core",
    "shard_buckets",
]
