"""Utilities: save / load in the JAX package's npz format, metrics
logging and profiler spans, and the texmex dataset readers."""

from vq_tpu_torch.utils.datasets import load_dataset, read_bvecs, read_fvecs, read_ivecs
from vq_tpu_torch.utils.metrics import MetricsLogger, trace
from vq_tpu_torch.utils.serialize import load, save

__all__ = ["save", "load", "MetricsLogger", "trace", "read_fvecs", "read_bvecs", "read_ivecs",
           "load_dataset"]
