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
its flat :class:`RQIndex`; the rest of the flat serving layer — the exact
:class:`FlatIndex` (five metrics, f32 / bf16 / f16 rows), :class:`SQIndex`
(per-dimension SQ codes, sub-byte packed at 16 levels and fewer) and
:class:`BinaryIndex` (sign bits by Hamming count) beside PQ and RQ, every
flat index with ``range_search`` and, where the JAX package has them,
``search_and_reconstruct``, ``_search_core`` and ``_reconstruct_core`` —
and the exact :func:`knn_graph` over it; score-aware quantization for
maximum-inner-product search (:func:`lloyd_anisotropic`,
:class:`AnisotropicProductQuantizer` with its ``mips_search``) and OPQ
(:class:`OPQQuantizer`, a learned rotation before PQ); and the IVF
ladder's IVF-Flat, IVF-SQ, IVF-PQ (L2, or dot with anisotropic codes),
IVF-RQ and IVF-Binary indexes: ``train`` (k-means with :func:`lloyd`;
then per-dimension SQ ranges, PQ or RQ codebooks on the residuals),
``add`` (coarse :func:`assign`, then the raw row or its SQ, PQ, RQ or
packed sign code), probed ``search`` and ``range_search``, and their
maintenance on the chunk pool (``remove_ids``, ``merge_from``,
``rebalance``); the layer users put around those indexes —
the faiss-style :class:`Kmeans` trainer, the vector transforms
(:class:`PCATransform`, :class:`RotationTransform` with
:func:`itq_train`, :class:`NormalizeTransform`,
:class:`CenteringTransform`) ahead of any index in a
:class:`TransformedIndex`, :class:`RefineIndex` (exact re-ranking from a
flat, SQ8 or residual PQ code), :class:`IdMapIndex` and
:func:`load_index`, and multi-batch serving (:class:`BatchPipeline`,
:func:`pipelined_search`); the navigable graph :class:`GraphIndex`
(Vamana-style build, batched beam search, ``add`` / ``remove_ids``), the
faiss-style :func:`index_factory`, runtime-parameter tuning
(:func:`tune`, :func:`sweep`, :func:`pareto`, :func:`exact_neighbors`,
:func:`recall_at`) and the k-means variants :func:`lloyd_stepped`
(logged, checkpointed, resumable) and :func:`lloyd_minibatch`
(streaming) — all of which run the kernels below under new callers. Their kernels — assign, Lloyd accumulate, PQ Lloyd
accumulate, PQ encode (exact, bf16 and bf16x3), the ADC scan with
per-tile top-k, the IVF probe matvec, the IVF ADC probe and the dense ADC
table sum — are CUDA C++ for ``sm_90a`` in ``vq_tpu_torch/csrc``, built
with nvcc on first use. BQ, TSVQ, the distances and the Flat, SQ and
Binary scans reach no TPU kernel (the JAX package's are XLA products and
``lax.top_k``): they are plain PyTorch on every device.

The rest of the JAX package's surface: the sharded layer
(:mod:`vq_tpu_torch.parallel`: training, encoding, and flat, IVF, graph
and refine serving on ``torch.distributed``), the native C++ oracle
(:mod:`vq_tpu_torch.native`), :func:`get_backend`, and the ``pyvq``
compatibility classes over the port (:mod:`vq_tpu_torch.pyvq`).

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
    NativeLibraryError,
    VqError,
)
from vq_tpu_torch.clustering import Kmeans
from vq_tpu_torch.factory import IdMapIndex, index_factory, load_index
from vq_tpu_torch.graph import GraphIndex
from vq_tpu_torch.ivf import IVFPQIndex
from vq_tpu_torch.ivf_binary import IVFBinaryIndex
from vq_tpu_torch.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
from vq_tpu_torch.models.base import Quantizer, default_device
from vq_tpu_torch.models.bq import (
    BinaryQuantizer,
    hamming_distance,
    pack_bits,
    packed_width,
    unpack_bits,
)
from vq_tpu_torch.models.opq import OPQQuantizer, opq_train
from vq_tpu_torch.models.pq import ProductQuantizer, pq_decode, pq_encode, pq_train
from vq_tpu_torch.models.pq_anisotropic import (
    AnisotropicProductQuantizer,
    anisotropic_pq_loss,
    mips_adc_search,
    pq_encode_anisotropic,
    pq_refine_anisotropic,
    pq_train_anisotropic,
)
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
from vq_tpu_torch.ops.kmeans import (
    KMeansResult,
    assign,
    kmeans_plusplus_init_device,
    lloyd,
    lloyd_batched,
)
from vq_tpu_torch.ops.kmeans_stepped import lloyd_stepped
from vq_tpu_torch.ops.kmeans_stream import lloyd_minibatch
from vq_tpu_torch.ops.kmeans_anisotropic import (
    anisotropic_assign,
    anisotropic_eta,
    lloyd_anisotropic,
)
from vq_tpu_torch.ops.knn import knn_graph
from vq_tpu_torch.ops.packing import bits_for, pack_codes, unpack_codes
from vq_tpu_torch.refine import RefineIndex
from vq_tpu_torch.search import BinaryIndex, FlatIndex, PQIndex, RQIndex, SQIndex
from vq_tpu_torch.serving import BatchPipeline, pipelined_search
from vq_tpu_torch.tune import (
    OperatingPoint,
    exact_neighbors,
    pareto,
    recall_at,
    sweep,
    tune,
)
from vq_tpu_torch.transforms import (
    CenteringTransform,
    NormalizeTransform,
    PCATransform,
    RotationTransform,
    TransformedIndex,
    VectorTransform,
    itq_train,
)
from vq_tpu_torch.utils.serialize import load, save

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def get_backend() -> str:
    """The device the port's entry points run on by default:
    ``"CUDA (<device name>)"`` with a card, else ``"CPU"`` — the JAX
    package's ``get_backend`` format with the card in the TPU's place (the
    reference's ``get_simd_backend``)."""
    if torch.cuda.is_available():
        return f"CUDA ({torch.cuda.get_device_name()})"
    return "CPU"


# pyvq exposes the same function under this name.
get_simd_backend = get_backend

__all__ = [
    "VqError",
    "DimensionMismatch",
    "EmptyInput",
    "InvalidParameter",
    "InvalidData",
    "NativeLibraryError",
    "get_backend",
    "get_simd_backend",
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
    "AnisotropicProductQuantizer",
    "pq_train_anisotropic",
    "pq_encode_anisotropic",
    "pq_refine_anisotropic",
    "anisotropic_pq_loss",
    "mips_adc_search",
    "OPQQuantizer",
    "opq_train",
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
    "FlatIndex",
    "PQIndex",
    "BinaryIndex",
    "SQIndex",
    "RQIndex",
    "knn_graph",
    "IVFPQIndex",
    "IVFFlatIndex",
    "IVFSQIndex",
    "IVFRQIndex",
    "IVFBinaryIndex",
    "KMeansResult",
    "assign",
    "lloyd",
    "lloyd_batched",
    "lloyd_stepped",
    "lloyd_minibatch",
    "kmeans_plusplus_init_device",
    "lloyd_anisotropic",
    "anisotropic_assign",
    "anisotropic_eta",
    "Kmeans",
    "VectorTransform",
    "PCATransform",
    "RotationTransform",
    "NormalizeTransform",
    "CenteringTransform",
    "TransformedIndex",
    "itq_train",
    "RefineIndex",
    "IdMapIndex",
    "load_index",
    "index_factory",
    "GraphIndex",
    "OperatingPoint",
    "exact_neighbors",
    "recall_at",
    "sweep",
    "pareto",
    "tune",
    "BatchPipeline",
    "pipelined_search",
    "default_device",
    "save",
    "load",
]
