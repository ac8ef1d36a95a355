"""Utilities: save / load in the JAX package's npz format, metrics
logging and profiler spans, and the texmex dataset readers."""

from vq_tpu_torch.utils.datasets import load_dataset, read_bvecs, read_fvecs, read_ivecs
from vq_tpu_torch.utils.metrics import MetricsLogger, trace
from vq_tpu_torch.utils.serialize import (
    KMeansCheckpoint,
    load,
    load_kmeans_state,
    save,
    save_kmeans_state,
)

__all__ = ["save", "load", "KMeansCheckpoint", "save_kmeans_state", "load_kmeans_state",
           "MetricsLogger", "trace", "read_fvecs", "read_bvecs", "read_ivecs", "load_dataset"]
