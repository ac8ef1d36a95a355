"""Device meshes on ``torch.distributed`` — the port of
``vq_tpu.parallel.mesh``.

The JAX package lays a ``jax.sharding.Mesh`` over every device, shards
the corpus along the vector axis and merges per-iteration accumulators
with ``psum``. The port does the same with one process a device: a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, the corpus row-sharded as a
:class:`~torch.distributed.tensor.DTensor`, and the merges
``dist.all_reduce`` / ``dist.all_gather`` on the mesh's groups.

Two mesh axes, as in the JAX package:

* ``"data"`` (:data:`DATA_AXIS`) — the corpus axis N; every collective of
  the k-means reduction runs on this axis's group;
* ``"sub"`` (:data:`SUBSPACE_AXIS`) — PQ's subspace axis m; each group of
  ranks along it owns a slice of the m codebooks.

A mesh of ``world`` ranks is ``(world // sub, sub)``, laid out row-major
as the JAX package reshapes its device list: rank r sits at
``(r // sub, r % sub)``. Each rank works on one device: on the card,
``cuda:LOCAL_RANK`` (modulo the visible cards); on the CPU only when the
caller asks for it (``device_type="cpu"``, or
``vq_tpu_torch.default_device("cpu")``). With no card and no such
request, :func:`make_mesh` raises as the rest of the port does.

Collectives run on NCCL for ``cuda`` and gloo for ``cpu``, as
:func:`init_distributed` chooses; a caller may ask for gloo on the card
(ranks that share one card: NCCL refuses two ranks on one device). The
backend is never changed behind the caller's back, and a failed
collective raises.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from vq_tpu_torch.errors import EmptyInput, InvalidParameter
from vq_tpu_torch.models.base import resolve_device
from vq_tpu_torch.models.pq import _smallest

DATA_AXIS = "data"
SUBSPACE_AXIS = "sub"

__all__ = [
    "DATA_AXIS",
    "SUBSPACE_AXIS",
    "init_distributed",
    "make_mesh",
    "mesh_device",
    "shard_rows",
    "replicate",
    "gather_global",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# A launcher (torchrun, or a script that sets the env:// variables) has
# said how to reach the other ranks.
_LAUNCHER_ENV = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID")


def _device_type(device_type=None) -> str:
    """``"cuda"`` or ``"cpu"``: the one given, else the port's default
    (the card, or what ``default_device`` set); raises without a card
    unless the CPU was asked for."""
    t = resolve_device().type if device_type is None else torch.device(device_type).type
    if t not in _BACKENDS:
        raise InvalidParameter("device_type", f"expected 'cuda' or 'cpu', got {t!r}")
    if t == "cuda" and not torch.cuda.is_available():
        raise InvalidParameter("device_type",
                               "no CUDA device: pass device_type='cpu' to run on the CPU")
    return t


def _seconds(timeout) -> Optional[datetime.timedelta]:
    if timeout is None or isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def init_distributed(
    init_method: Optional[str] = None,
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: Optional[str] = None,
    timeout=None,
) -> int:
    """Initialize the default process group and return this process's rank.

    A thin wrapper over ``dist.init_process_group`` so pipelines have one
    import. Exactly two cases are benign no-ops:

    * already initialized — idempotent re-entry;
    * called with no ``init_method`` / ``world_size`` / ``rank`` and no
      launcher environment (``MASTER_ADDR``, torchrun's
      ``TORCHELASTIC_RUN_ID``) — a world of one on a local store, the
      "just works on one device" path.

    Everything else raises: a ``rank`` outside ``[0, world_size)``, an
    explicit but unreachable ``init_method`` (after ``timeout``, seconds
    or a ``timedelta``), a launcher environment that names no reachable
    store. So a broken multi-process launch fails loudly instead of going
    on as a single-process run (the JAX package's round-2 weak #3).

    ``backend`` defaults to NCCL for ``cuda`` and gloo for ``cpu``
    (``device_type``: the port's default device when not given). On the
    card the process's device becomes ``cuda:LOCAL_RANK`` (modulo the
    visible cards) before the group starts.
    """
    if dist.is_initialized():
        return dist.get_rank()
    dev = _device_type(device_type)
    backend = backend or _BACKENDS[dev]
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if explicit:
        if world_size is None or rank is None:
            raise InvalidParameter("world_size",
                                   "an explicit launch needs both world_size and rank")
        world_size, rank = int(world_size), int(rank)
        if world_size < 1 or not 0 <= rank < world_size:
            raise InvalidParameter("rank", f"({rank}) must lie in [0, world_size={world_size})")
    kw = {} if timeout is None else {"timeout": _seconds(timeout)}
    if dev == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if explicit or any(os.environ.get(v) for v in _LAUNCHER_ENV):
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, **kw,
        )
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return dist.get_rank()


def make_mesh(
    n_devices: Optional[int] = None,
    subspace_parallel: int = 1,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A ``(data, sub)`` mesh over the ranks of the default process group
    (started as a world of one if nothing started it).

    ``subspace_parallel`` ranks are dedicated to the PQ subspace axis; the
    rest shard the corpus. A mesh spans the whole world, so ``n_devices``,
    when given, must be the world size. Every rank calls this in the same
    order (the mesh's groups are made collectively).
    """
    dt = _device_type(device_type)
    init_distributed(device_type=dt)
    if dt == "cpu" and dist.get_backend() == "nccl":
        raise InvalidParameter("device_type",
                               "the process group runs NCCL, which takes no CPU tensors")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise InvalidParameter("n_devices",
                               f"a mesh spans the whole world ({world} ranks), got {n}")
    sub = int(subspace_parallel)
    if sub < 1 or n % sub != 0:
        raise InvalidParameter(
            "subspace_parallel", f"({sub}) must divide the device count {n}"
        )
    return DeviceMesh(dt, torch.arange(n).reshape(n // sub, sub),
                      mesh_dim_names=(DATA_AXIS, SUBSPACE_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank works on: the CPU, or its current card."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coords(mesh: DeviceMesh) -> Tuple[int, int, int, int]:
    """``(data index, data size, sub index, sub size)`` of this rank."""
    return (mesh.get_local_rank(DATA_AXIS), mesh.size(0),
            mesh.get_local_rank(SUBSPACE_AXIS), mesh.size(1))


def _block(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of block i of ``parts``: ``torch.chunk``'s (and
    ``Shard``'s) layout, ``ceil(n / parts)`` rows a block, the last short
    or empty."""
    per = -(-n // parts)
    lo = min(i * per, n)
    return lo, min(lo + per, n)


def _sharded(local: torch.Tensor, mesh: DeviceMesh, shape, placements) -> DTensor:
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape, stride=stride)


def _row_dtensor(local: torch.Tensor, mesh: DeviceMesh, n: int) -> DTensor:
    """``local`` as this rank's row block of an ``[n, ...]`` DTensor."""
    return _sharded(local, mesh, (n,) + tuple(local.shape[1:]), [Shard(0), Replicate()])


def _numeric(x) -> Union[np.ndarray, torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiub":
        raise InvalidParameter("x", f"expected numeric input, got dtype {arr.dtype}")
    return arr


def local_rows(x, mesh: DeviceMesh, dtype=torch.float32) -> Tuple[torch.Tensor, int]:
    """``(this rank's row block on its device, global row count)`` of ``x``
    sharded over the data axis: a row-sharded DTensor gives its local
    block; a replicated DTensor, a tensor or a host array is cut here, so
    a host array's other blocks never reach the device."""
    di, dn, _, _ = _coords(mesh)
    dev = mesh_device(mesh)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise InvalidParameter("x", "is placed on another mesh")
        n = x.shape[0]
        if x.placements[0] == Shard(0):
            local = x.to_local()
        elif all(isinstance(p, Replicate) for p in x.placements):
            lo, hi = _block(n, dn, di)
            local = x.to_local()[lo:hi]
        else:
            raise InvalidParameter(
                "x", f"expected rows sharded over '{DATA_AXIS}', got {x.placements}")
        return local.to(device=dev, dtype=dtype), n
    arr = _numeric(x)
    if arr.ndim == 0:
        raise InvalidParameter("x", "expected rows, got a scalar")
    n = arr.shape[0]
    lo, hi = _block(n, dn, di)
    block = arr[lo:hi]
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(device=dev, dtype=dtype), n


def check_rows(x, mesh: DeviceMesh) -> Tuple[torch.Tensor, int, int]:
    """:func:`local_rows` of a 2-D non-empty training matrix ->
    ``(local [n_l, d] f32, n, d)``; the checks of
    ``models.base.check_training_matrix`` on the global shape."""
    if isinstance(x, (list, tuple)):
        from vq_tpu_torch.models.base import check_training_matrix

        x = check_training_matrix(x, "cpu")
    local, n = local_rows(x, mesh)
    if local.ndim != 2:
        raise InvalidParameter("training_data", f"must be a 2-D [n, d] matrix, got {local.ndim}-D")
    if n == 0 or local.shape[1] == 0:
        raise EmptyInput("training data must not be empty")
    return local, n, local.shape[1]


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def merge_topk(ids: torch.Tensor, vals: torch.Tensor, k: int, group):
    """The cross-rank merge of local top-k ``(ids [Q, k] i32, vals [Q, k]
    f32)`` (smaller is better): one ``all_gather`` of both in one int32
    buffer, then :func:`_smallest` over the concatenation in rank order,
    so the lowest rank wins exact ties -> ``(ids, vals)`` ``[Q, k]``, the
    same on every rank of ``group``."""
    packed = torch.stack([vals.contiguous().view(torch.int32), ids.to(torch.int32)])
    cat = torch.cat(_all_gather(packed, group), dim=2)
    best, pos = _smallest(cat[0].view(torch.float32), k)
    return torch.gather(cat[1], 1, pos), best


def gather_global(x) -> torch.Tensor:
    """The whole of ``x`` on every rank: a DTensor's shards gathered along
    each sharded mesh dimension (``dist.all_gather``, which gloo also
    takes for CUDA tensors), a plain tensor as it is. Every rank of the
    mesh calls it."""
    if not isinstance(x, DTensor):
        return x
    mesh, t = x.device_mesh, x.to_local()
    for dim_idx, p in enumerate(x.placements):
        if not isinstance(p, Shard):
            continue
        group = mesh.get_group(dim_idx)
        parts = mesh.size(dim_idx)
        full = x.shape[p.dim]
        per = -(-full // parts)
        pad = [0, 0] * (t.ndim - p.dim - 1) + [0, per - t.shape[p.dim]]
        pieces = _all_gather(torch.nn.functional.pad(t, pad) if any(pad) else t, group)
        t = torch.cat(pieces, dim=p.dim).narrow(p.dim, 0, full)
    return t


def shard_rows(x, mesh: DeviceMesh) -> DTensor:
    """Place ``x`` with its leading (vector) axis sharded over the data
    axis and replicated over the subspace axis (each rank keeps its block
    of ``x``, which every rank holds whole)."""
    local, n = local_rows(x, mesh, dtype=None)
    return _row_dtensor(local, mesh, n)


def replicate(x, mesh: DeviceMesh) -> DTensor:
    """Place ``x`` replicated across the mesh."""
    t = x.to(mesh_device(mesh)) if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(_numeric(x)), device=mesh_device(mesh))
    return _sharded(t, mesh, t.shape, [Replicate(), Replicate()])


def all_reduce_sum(tensors: Sequence[torch.Tensor], group, async_op: bool = False):
    """Sum ``tensors`` over ``group`` in one ``dist.all_reduce`` of their
    concatenation -> ``(sums, work)``: the sums in the tensors' shapes
    (valid once ``work.wait()`` returned, when ``async_op``)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    work = dist.all_reduce(flat, group=group, async_op=async_op)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()
    return out, work


def overlapped_sum(fn, n_rows: int, half: int, group) -> List[torch.Tensor]:
    """``fn(lo, hi)``'s tensors (this rank's partial sums over its rows
    ``[lo, hi)``) summed over ``group``.

    With ``0 < half < n_rows`` and more than one rank in the group, the
    rows are swept in two halves: the first half's ``all_reduce`` is
    issued asynchronously before the second half's ``fn`` runs, which
    does not depend on it, and is waited on after it. Otherwise (``half``
    0, or a group of one, where a collective has nothing to hide) one
    sweep and one ``all_reduce``."""
    if 0 < half < n_rows and dist.get_world_size(group) > 1:
        first, work = all_reduce_sum(fn(0, half), group, async_op=True)
        second, _ = all_reduce_sum(fn(half, n_rows), group)
        work.wait()
        return [a + b for a, b in zip(first, second)]
    out, _ = all_reduce_sum(fn(0, n_rows), group)
    return out
