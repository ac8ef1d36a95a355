"""vq_tpu_torch — the PyTorch / CUDA port of vq_tpu, for NVIDIA Hopper.

Two paths are ported so far. The product-quantization main path: train
a :class:`ProductQuantizer`, build a :class:`PQIndex` and ``add`` a
corpus (which encodes it), then ``search`` query batches with the flat
ADC top-k. And IVF-PQ: :meth:`IVFPQIndex.train` (k-means with
:func:`lloyd`, then PQ on the residuals), ``add`` (coarse
:func:`assign`, residual encode) and probed ``search``. Their six
kernels — assign, Lloyd accumulate, PQ Lloyd accumulate, exact PQ
encode, the ADC scan with per-tile top-k and the IVF probe — are CUDA
C++ for ``sm_90a`` in ``vq_tpu_torch/csrc``, built with nvcc on first
use. On CPU tensors the same functions run their plain PyTorch
versions.

fp32 products run in full fp32: TF32 is switched off for matmuls and
cuDNN on import, because TF32 keeps about three decimal digits and would
move codes and neighbours away from the JAX reference.

>>> import numpy as np
>>> import vq_tpu_torch
>>> data = np.tile(
...     np.array([[0., 0., 1., 1.], [1., 1., 0., 0.]], np.float32), (8, 1)
... )
>>> pq = vq_tpu_torch.ProductQuantizer(data, num_subspaces=2, num_centroids=2)
>>> codes = pq.encode(data)
>>> tuple(codes.shape), codes.dtype
((16, 2), torch.uint8)
>>> bool(np.allclose(pq.decode(codes).numpy(), data))
True
"""

import torch

from vq_tpu_torch.errors import (
    DimensionMismatch,
    EmptyInput,
    InvalidData,
    InvalidParameter,
    VqError,
)
from vq_tpu_torch.ivf import IVFPQIndex
from vq_tpu_torch.models.base import Quantizer
from vq_tpu_torch.models.pq import ProductQuantizer, pq_decode, pq_encode, pq_train
from vq_tpu_torch.ops.distance import Metric, pairwise
from vq_tpu_torch.ops.kmeans import KMeansResult, assign, kmeans_plusplus_init_device, lloyd
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.search import PQIndex
from vq_tpu_torch.utils.serialize import load, save

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "VqError",
    "DimensionMismatch",
    "EmptyInput",
    "InvalidParameter",
    "InvalidData",
    "Quantizer",
    "ProductQuantizer",
    "pq_train",
    "pq_encode",
    "pq_decode",
    "Metric",
    "pairwise",
    "bits_for",
    "pack_codes",
    "unpack_codes",
    "PQIndex",
    "IVFPQIndex",
    "KMeansResult",
    "assign",
    "lloyd",
    "kmeans_plusplus_init_device",
    "save",
    "load",
]
