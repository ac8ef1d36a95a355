"""Vector transforms and pre-transformed indexes — the port of
``vq_tpu.transforms`` (faiss ``VectorTransform`` / ``IndexPreTransform``
analogs):

* :class:`PCATransform` — PCA fitted on the data's device (mean, one
  ``[d, n] x [n, d]`` fp32 product for the covariance, ``eigh``),
  optional whitening and output-dimension reduction.
* :class:`RotationTransform` — fixed orthonormal map (seeded random, or a
  learned one such as ITQ's or OPQ's).
* :class:`NormalizeTransform` — row L2 normalization.
* :class:`CenteringTransform` — mean subtraction.
* :func:`itq_train` — Iterative Quantization: PCA then a rotation that
  minimizes the binarization error, for sign-bit indexes.
* :class:`TransformedIndex` — chains transforms in front of any index.

No TPU kernel reaches this layer: the JAX package runs it as XLA
products, ``eigh``, QR and SVDs, and so the port runs it as PyTorch
calls on the card. Products are full fp32 (TF32 is off package-wide, as
the JAX package asks ``Precision.HIGHEST``).

``eigh`` eigenvectors are unique only up to sign, and LAPACK, XLA and
cuSOLVER choose differently; no sign convention is added here, as the
JAX package has none. Seeded rotations draw from a ``torch.Generator``
on the device (they do not replay threefry), so a seeded rotation is
held by orthonormality, and equal to the JAX package's only when its
matrix is carried across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidData, InvalidParameter
from vq_tpu_torch.models.base import as_tensor, resolve_device
from vq_tpu_torch.models.opq import _procrustes
from vq_tpu_torch.ops.distance import COSINE_NORM_EPS
from vq_tpu_torch.ops.kmeans import _generator
from vq_tpu_torch.utils.serialize import load, save

__all__ = [
    "VectorTransform",
    "PCATransform",
    "RotationTransform",
    "NormalizeTransform",
    "CenteringTransform",
    "TransformedIndex",
    "itq_train",
]


def _check_2d(x, d_in: int, name: str = "x", device=None) -> torch.Tensor:
    x = as_tensor(x, device).to(torch.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise InvalidParameter(name, f"must be 1-D or 2-D, got {x.ndim}-D")
    if x.shape[1] != d_in:
        raise DimensionMismatch(expected=d_in, found=x.shape[1])
    return x


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class VectorTransform:
    """Base class: a (possibly fitted) map from ``d_in`` to ``d_out``.
    A fitted transform's state lives on one device, and input moves
    there."""

    d_in: int
    d_out: int
    device: Optional[torch.device] = None

    @property
    def is_fitted(self) -> bool:
        return True

    def fit(self, data) -> "VectorTransform":
        """Fit from data (no-op for parameter-free transforms)."""
        return self

    def apply(self, x) -> torch.Tensor:
        raise NotImplementedError

    def reverse(self, y) -> torch.Tensor:
        """Inverse map (exact or pseudo-inverse); raises
        :class:`InvalidData` for non-invertible transforms."""
        raise InvalidData(f"{type(self).__name__} has no inverse")

    # -- serialization hooks (TransformedIndex's checkpoint) -----------------
    def _state(self) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
        raise NotImplementedError

    @staticmethod
    def _from_state(kind: str, config: Dict[str, Any], arrays: Dict[str, np.ndarray],
                    device=None) -> "VectorTransform":
        cls = _TRANSFORM_KINDS.get(kind)
        if cls is None:
            raise InvalidData(f"unknown transform kind {kind!r}")
        return cls._restore(config, arrays, resolve_device(device))


class CenteringTransform(VectorTransform):
    """Subtract the (fitted) mean; exactly invertible."""

    def __init__(self, dim: int, mean=None, *, device=None):
        self.d_in = self.d_out = int(dim)
        self._mean: Optional[torch.Tensor] = None
        if mean is not None:
            self._mean = as_tensor(mean, device).to(torch.float32)
            if tuple(self._mean.shape) != (self.d_in,):
                raise DimensionMismatch(expected=self.d_in, found=self._mean.shape[-1])
            self.device = self._mean.device

    @property
    def is_fitted(self) -> bool:
        return self._mean is not None

    def fit(self, data) -> "CenteringTransform":
        x = _check_2d(data, self.d_in, "data")
        if x.shape[0] == 0:
            raise EmptyInput("cannot fit on an empty batch")
        self._mean = x.mean(0)
        self.device = x.device
        return self

    def apply(self, x) -> torch.Tensor:
        if self._mean is None:
            raise InvalidData("CenteringTransform is not fitted")
        return _check_2d(x, self.d_in, device=self.device) - self._mean[None, :]

    def reverse(self, y) -> torch.Tensor:
        if self._mean is None:
            raise InvalidData("CenteringTransform is not fitted")
        return _check_2d(y, self.d_out, device=self.device) + self._mean[None, :]

    def _state(self):
        return "center", {"dim": self.d_in}, {"mean": _np(self._mean)}

    @classmethod
    def _restore(cls, config, arrays, device):
        return cls(config["dim"], mean=np.array(arrays["mean"], np.float32), device=device)

    def __repr__(self) -> str:
        return f"CenteringTransform(dim={self.d_in}, fitted={self.is_fitted})"


class NormalizeTransform(VectorTransform):
    """Row L2 normalization (rows with a norm below ``COSINE_NORM_EPS``
    pass through unchanged, the cosine metric's zero-norm guard). Not
    invertible. It has no state, so input stays on its device."""

    def __init__(self, dim: int):
        self.d_in = self.d_out = int(dim)

    def apply(self, x) -> torch.Tensor:
        x = _check_2d(x, self.d_in)
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return torch.where(n < COSINE_NORM_EPS, x, x / n)

    def _state(self):
        return "l2norm", {"dim": self.d_in}, {}

    @classmethod
    def _restore(cls, config, arrays, device):
        return cls(config["dim"])

    def __repr__(self) -> str:
        return f"NormalizeTransform(dim={self.d_in})"


class RotationTransform(VectorTransform):
    """Fixed orthonormal map ``x @ R`` (``R: [d_in, d_out]``, orthonormal
    columns). Exactly invertible when square (``y @ R.T``); a column-
    orthonormal reduction reverses by projection (pseudo-inverse)."""

    def __init__(self, matrix, *, device=None):
        r = as_tensor(matrix, device).to(torch.float32)
        if r.ndim != 2:
            raise InvalidParameter("matrix", "must be a 2-D array")
        self._r = r.contiguous()
        self.device = r.device
        self.d_in, self.d_out = int(r.shape[0]), int(r.shape[1])

    @classmethod
    def random(cls, dim: int, seed: int = 42, d_out: Optional[int] = None, *,
               device=None) -> "RotationTransform":
        """Seeded random orthonormal rotation on ``device`` (QR of a
        Gaussian, each column's sign fixed by ``diag(R)``); ``d_out < dim``
        keeps the first columns, a random orthonormal projection (the faiss
        ``RandomRotationMatrix`` used by LSH)."""
        dim = int(dim)
        d_out = dim if d_out is None else int(d_out)
        if not 1 <= d_out <= dim:
            raise InvalidParameter("d_out", "must be in [1, dim]")
        dev = resolve_device(device)
        g = torch.randn(dim, dim, generator=_generator(seed, dev), device=dev)
        q, r = torch.linalg.qr(g)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        return cls(q[:, :d_out])

    @property
    def matrix(self) -> torch.Tensor:
        return self._r

    def apply(self, x) -> torch.Tensor:
        return _check_2d(x, self.d_in, device=self.device) @ self._r

    def reverse(self, y) -> torch.Tensor:
        return _check_2d(y, self.d_out, device=self.device) @ self._r.T

    def _state(self):
        return "rotation", {}, {"matrix": _np(self._r)}

    @classmethod
    def _restore(cls, config, arrays, device):
        return cls(np.array(arrays["matrix"], np.float32), device=device)

    def __repr__(self) -> str:
        return f"RotationTransform({self.d_in} -> {self.d_out})"


def _itq_rotation(v: torch.Tensor, r0: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """ITQ's alternation on PCA-projected data ``v [n, b]`` from ``r0``:
    fix the sign codes (``z >= 0`` -> +1), solve the orthogonal Procrustes
    problem for the rotation (SVD of ``v.T @ sign(v r)``), repeat."""
    r = r0
    for _ in range(int(iters)):
        b = torch.where(v @ r >= 0, 1.0, -1.0)
        r = _procrustes(v, b)
    return r


def itq_train(data, d_out: Optional[int] = None, *, iters: int = 50, seed: int = 42,
              device=None) -> List[VectorTransform]:
    """Iterative Quantization (ITQ), the faiss ``ITQMatrix`` analog.

    Fits ``[PCATransform(d -> d_out), RotationTransform]`` on the data's
    device, where the rotation minimizes the binarization error
    ``||sign(VR) - VR||^2`` by alternating sign codes with an
    orthogonal-Procrustes solve (Gong & Lazebnik), from a seeded random
    rotation. Put the chain in front of a
    :class:`~vq_tpu_torch.search.BinaryIndex`."""
    chain, _ = _itq_fit(data, d_out, iters=iters, seed=seed, device=device)
    return chain


def _itq_fit(data, d_out, *, iters, seed, device=None):
    """ITQ fit -> ``(chain, projected_data)``."""
    x = as_tensor(data, device).to(torch.float32)
    if x.ndim != 2 or x.shape[0] == 0:
        raise InvalidParameter("data", "expected a non-empty [n, d] matrix")
    d = int(x.shape[1])
    d_out = d if d_out is None else int(d_out)
    if not 1 <= d_out <= d:
        raise InvalidParameter("d_out", "must be in [1, dim]")
    if int(iters) < 1:
        raise InvalidParameter("iters", "must be >= 1")
    pca = PCATransform(d, d_out).fit(x)
    v = pca.apply(x)
    r0 = RotationTransform.random(d_out, seed=seed, device=x.device).matrix
    return [pca, RotationTransform(_itq_rotation(v, r0, int(iters)))], v


class PCATransform(VectorTransform):
    """PCA projection fitted on the data's device: mean, covariance (one
    fp32 ``[d, n] x [n, d]`` product) and ``torch.linalg.eigh``.

    ``d_out < d_in`` keeps the top-variance components; ``whiten=True``
    rescales each component to unit variance (the faiss ``PCAW``
    behaviour). ``reverse`` maps back through the component basis (exact
    for full-rank unwhitened PCA; the least-squares reconstruction
    otherwise)."""

    def __init__(self, d_in: int, d_out: Optional[int] = None, *, whiten: bool = False,
                 eps: float = 1e-8):
        self.d_in = int(d_in)
        self.d_out = int(d_out) if d_out is not None else self.d_in
        if not 1 <= self.d_out <= self.d_in:
            raise InvalidParameter("d_out", f"must be in [1, {self.d_in}]")
        self.whiten = bool(whiten)
        self.eps = float(eps)
        self._mean: Optional[torch.Tensor] = None  # [d_in]
        self._components: Optional[torch.Tensor] = None  # [d_in, d_out]
        self._eigvals: Optional[torch.Tensor] = None  # [d_out] descending

    @property
    def is_fitted(self) -> bool:
        return self._components is not None

    def fit(self, data) -> "PCATransform":
        x = _check_2d(data, self.d_in, "data")
        n = x.shape[0]
        if n < 2:
            raise InvalidData("PCA needs at least 2 rows")
        self._mean = x.mean(0)
        xc = x - self._mean[None, :]
        cov = (xc.T @ xc) / (n - 1)
        w, v = torch.linalg.eigh(cov)  # ascending
        order = torch.argsort(-w, stable=True)[: self.d_out]
        self._eigvals = w[order].clamp_min(0.0)
        self._components = v[:, order].contiguous()
        self.device = x.device
        return self

    def _require_fit(self):
        if self._components is None:
            raise InvalidData("PCATransform is not fitted — call fit(data)")

    @property
    def explained_variance(self) -> torch.Tensor:
        self._require_fit()
        return self._eigvals

    def apply(self, x) -> torch.Tensor:
        self._require_fit()
        y = (_check_2d(x, self.d_in, device=self.device) - self._mean[None, :]) @ self._components
        if self.whiten:
            y = y / torch.sqrt(self._eigvals + self.eps)[None, :]
        return y

    def reverse(self, y) -> torch.Tensor:
        self._require_fit()
        y = _check_2d(y, self.d_out, device=self.device)
        if self.whiten:
            y = y * torch.sqrt(self._eigvals + self.eps)[None, :]
        return y @ self._components.T + self._mean[None, :]

    def _state(self):
        self._require_fit()
        return (
            "pca",
            {"d_in": self.d_in, "d_out": self.d_out, "whiten": self.whiten, "eps": self.eps},
            {"mean": _np(self._mean), "components": _np(self._components),
             "eigvals": _np(self._eigvals)},
        )

    @classmethod
    def _restore(cls, config, arrays, device):
        t = cls(config["d_in"], config["d_out"], whiten=config["whiten"], eps=config["eps"])
        t._mean, t._components, t._eigvals = (
            torch.as_tensor(np.array(arrays[k], np.float32), device=device)
            for k in ("mean", "components", "eigvals"))
        t.device = device
        return t

    def __repr__(self) -> str:
        return (
            f"PCATransform({self.d_in} -> {self.d_out}, "
            f"whiten={self.whiten}, fitted={self.is_fitted})"
        )


_TRANSFORM_KINDS = {
    "center": CenteringTransform,
    "l2norm": NormalizeTransform,
    "rotation": RotationTransform,
    "pca": PCATransform,
}


class TransformedIndex:
    """An index behind a chain of vector transforms (faiss
    ``IndexPreTransform`` analog).

    ``add`` / ``search`` / ``range_search`` map inputs through the chain
    in order before the base index; ``reconstruct`` maps the base's
    reconstruction back through each transform's ``reverse`` in reverse
    order (:class:`InvalidData` if a stage is not invertible).

    ``save`` / ``load`` write the chain into the main checkpoint and the
    base index into a sibling ``<path>.base.npz``, loaded back through
    :func:`vq_tpu_torch.factory.load_index` (the JAX package's layout).
    """

    def __init__(self, transforms: Sequence[VectorTransform], base):
        ts = list(transforms)
        if not ts:
            raise InvalidParameter("transforms", "need at least one")
        for a, b in zip(ts, ts[1:]):
            if a.d_out != b.d_in:
                raise DimensionMismatch(expected=a.d_out, found=b.d_in)
        base_dim = getattr(base, "dim", None)
        if base_dim is not None and ts[-1].d_out != base_dim:
            raise DimensionMismatch(expected=ts[-1].d_out, found=base_dim)
        self.transforms: List[VectorTransform] = ts
        self.base = base

    @property
    def dim(self) -> int:
        return self.transforms[0].d_in

    @property
    def ntotal(self) -> int:
        return self.base.ntotal

    @property
    def device(self) -> Optional[torch.device]:
        return getattr(self.base, "device", None)

    def _chain(self, x) -> torch.Tensor:
        y = x
        for t in self.transforms:
            y = t.apply(y)
        return y

    def fit_transforms(self, data) -> "TransformedIndex":
        """Fit every transform in order, each on the previous stage's
        output."""
        y = as_tensor(data, self.device).to(torch.float32)
        for t in self.transforms:
            t.fit(y)
            y = t.apply(y)
        return self

    def add(self, vectors) -> None:
        self.base.add(self._chain(vectors))

    def search(self, queries, k: int = 10, **kw):
        return self.base.search(self._chain(queries), k, **kw)

    def _search_core(self, k: int, **kw):
        """The base's search core with the transform chain applied to each
        query batch first: ``fn(q, *arrays)`` is :meth:`search`."""
        base_fn, arrays = self.base._search_core(int(k), **kw)
        chain = self._chain

        def fn(q, *arrs):
            return base_fn(chain(q), *arrs)

        return fn, arrays

    def range_search(self, queries, radius: float, **kw):
        if not hasattr(self.base, "range_search"):
            raise InvalidData(f"{type(self.base).__name__} does not support range_search")
        return self.base.range_search(self._chain(queries), radius, **kw)

    def remove_ids(self, ids) -> int:
        return self.base.remove_ids(ids)

    def reconstruct(self, ids) -> torch.Tensor:
        y = self.base.reconstruct(ids)
        for t in reversed(self.transforms):
            y = t.reverse(y)
        return y

    def search_and_reconstruct(self, queries, k: int = 10, **kw):
        """Search in the transformed space, reconstruct hits back in the
        input space (transforms reversed) -> ``(ids, values,
        vectors [Q, k, d_in])``."""
        if not hasattr(self.base, "search_and_reconstruct"):
            raise InvalidData(
                f"{type(self.base).__name__} does not support search_and_reconstruct")
        ids, vals, rec = self.base.search_and_reconstruct(self._chain(queries), k, **kw)
        y = rec.reshape(-1, rec.shape[-1])
        for t in reversed(self.transforms):
            y = t.reverse(y)
        return ids, vals, y.reshape(*rec.shape[:-1], y.shape[-1])

    def merge_from(self, other: "TransformedIndex") -> int:
        """Move every vector of ``other.base`` into this pipeline's base.
        Requires identical fitted transforms (kinds, configs and fitted
        arrays): otherwise the two bases hold vectors from different
        spaces."""
        if type(other) is not TransformedIndex or len(self.transforms) != len(other.transforms):
            raise InvalidParameter("other", "can only merge an identical TransformedIndex chain")
        for a, b in zip(self.transforms, other.transforms):
            ka, ca, aa = a._state()
            kb, cb, ab = b._state()
            if ka != kb or ca != cb or set(aa) != set(ab) or any(
                not np.array_equal(aa[k], ab[k]) for k in aa
            ):
                raise InvalidData("cannot merge: fitted transforms differ")
        return self.base.merge_from(other.base)

    def save(self, path: str) -> str:
        """Write the chain as a ``transformed_index`` ``.npz`` and the base
        beside it as ``<path>.base.npz``; returns the main path."""
        return save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "TransformedIndex":
        """Load a ``transformed_index`` (and its base) saved by either
        package onto ``device``."""
        return load(path, device, expect="transformed_index")

    def __repr__(self) -> str:
        chain = " -> ".join(type(t).__name__ for t in self.transforms)
        return f"TransformedIndex({chain} -> {self.base!r})"


def _transformed_state(idx: TransformedIndex):
    """``(config, arrays)`` of a :class:`TransformedIndex` without its
    base: each transform's kind and config, its arrays under ``t<i>_``."""
    specs, arrays = [], {}
    for i, t in enumerate(idx.transforms):
        kind, config, arrs = t._state()
        specs.append({"kind": kind, "config": config})
        arrays.update({f"t{i}_{k}": v for k, v in arrs.items()})
    return {"transforms": specs}, arrays


def _transformed_from(config, arrays, device, base) -> TransformedIndex:
    ts = []
    for i, spec in enumerate(config["transforms"]):
        prefix = f"t{i}_"
        arrs = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}
        ts.append(VectorTransform._from_state(spec["kind"], spec["config"], arrs, device))
    return TransformedIndex(ts, base)
