"""vq_tpu_torch — the PyTorch / CUDA port of vq_tpu, for NVIDIA Hopper.

Ported so far: the four quantizers of the source library — binary
(:class:`BinaryQuantizer`, with sign bits packed 32 to a word and their
Hamming distance), scalar, product and tree-structured (:class:`TSVQ`,
built by the host recursion or level by level on the card) — with the
distances (:func:`distance`, :func:`pairwise`, :func:`nearest`,
:func:`rowwise`, :class:`Distance`) and the four eval harnesses
(``python -m vq_tpu_torch.cli.eval_{bq,sq,pq,tsvq}``); the
product-quantization main path — train a
:class:`ProductQuantizer`, build a :class:`PQIndex` and ``add`` a corpus
(which encodes it, exactly or at the bf16 precisions), then ``search``
query batches with the flat ADC top-k; residual quantization
(:class:`ResidualQuantizer`, greedy or beam encode, joint refinement) and
its flat :class:`RQIndex`; and the IVF ladder's IVF-Flat, IVF-SQ, IVF-PQ
and IVF-RQ indexes: ``train`` (k-means with :func:`lloyd`; then
per-dimension SQ ranges, PQ or RQ codebooks on the residuals), ``add``
(coarse :func:`assign`, then the raw row or its SQ, PQ or RQ code) and
probed ``search``. Their kernels — assign, Lloyd accumulate, PQ Lloyd
accumulate, PQ encode (exact, bf16 and bf16x3), the ADC scan with
per-tile top-k, the IVF probe matvec, the IVF ADC probe and the dense ADC
table sum — are CUDA C++ for ``sm_90a`` in ``vq_tpu_torch/csrc``, built
with nvcc on first use. BQ, TSVQ and the distances reach no TPU kernel:
they are plain PyTorch on every device.

Entry points run on the card: input that is not a tensor lands on
``cuda`` unless a ``device`` is given (or :func:`default_device` names
another). On CPU tensors the same functions run their plain PyTorch
versions, the arithmetic each kernel is held to.

fp32 products run in full fp32: TF32 is switched off for matmuls and
cuDNN on import, because TF32 keeps about three decimal digits and would
move codes and neighbours away from the JAX reference.

>>> import numpy as np
>>> import vq_tpu_torch
>>> data = np.tile(
...     np.array([[0., 0., 1., 1.], [1., 1., 0., 0.]], np.float32), (8, 1)
... )
>>> pq = vq_tpu_torch.ProductQuantizer(data, num_subspaces=2, num_centroids=2,
...                                    device="cpu")
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
from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
from vq_tpu_torch.models.base import Quantizer, default_device
from vq_tpu_torch.models.bq import (
    BinaryQuantizer,
    hamming_distance,
    pack_bits,
    packed_width,
    unpack_bits,
)
from vq_tpu_torch.models.pq import ProductQuantizer, pq_decode, pq_encode, pq_train
from vq_tpu_torch.models.rq import (
    ResidualQuantizer,
    rq_decode,
    rq_encode,
    rq_refine_joint,
    rq_train,
)
from vq_tpu_torch.models.sq import PerDimScalarQuantizer, ScalarQuantizer
from vq_tpu_torch.models.tsvq import TSVQ, TSVQTree, tsvq_build
from vq_tpu_torch.ops.distance import Distance, Metric, distance, nearest, pairwise, rowwise
from vq_tpu_torch.ops.kmeans import KMeansResult, assign, kmeans_plusplus_init_device, lloyd
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.search import PQIndex, RQIndex
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
    "BinaryQuantizer",
    "packed_width",
    "pack_bits",
    "unpack_bits",
    "hamming_distance",
    "TSVQ",
    "TSVQTree",
    "tsvq_build",
    "ProductQuantizer",
    "ScalarQuantizer",
    "PerDimScalarQuantizer",
    "pq_train",
    "pq_encode",
    "pq_decode",
    "ResidualQuantizer",
    "rq_train",
    "rq_encode",
    "rq_decode",
    "rq_refine_joint",
    "Metric",
    "Distance",
    "distance",
    "pairwise",
    "nearest",
    "rowwise",
    "bits_for",
    "pack_codes",
    "unpack_codes",
    "PQIndex",
    "RQIndex",
    "IVFPQIndex",
    "IVFFlatIndex",
    "IVFSQIndex",
    "IVFRQIndex",
    "KMeansResult",
    "assign",
    "lloyd",
    "kmeans_plusplus_init_device",
    "default_device",
    "save",
    "load",
]
