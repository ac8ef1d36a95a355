"""Multi-rank dry run of the sharded layer — the twin of the JAX
package's ``__graft_entry__.py::dryrun_multichip``: training, streaming,
OPQ, and the flat, IVF-PQ, IVF scan-ladder, graph and refine searches.

    python -m vq_tpu_torch.parallel.dryrun --ranks 4 --device cpu --out run.npz
    python -m vq_tpu_torch.parallel.dryrun --ranks 2 --device cuda --backend gloo --out run.npz

It spawns the world itself (``--ranks`` processes on ``127.0.0.1``; gloo
on the CPU, NCCL on the card unless ``--backend gloo`` asks for gloo,
which lets ranks share one card) and runs every sharded function of
:mod:`vq_tpu_torch.parallel` on the meshes ``(N, 1)`` and, for an even
N > 1, ``(N/2, 2)``, on small seeded inputs (:func:`make_inputs`). Rank 0
holds each result to the port's single-device functions on the same
inputs (:func:`check_single_device`), writes every result to ``--out``
(``.npz``, keys ``<function>/<case>/<mesh>/<field>``), and any mismatch
fails the run. ``--indexes DIR`` searches the indexes saved there
(``<kind>.npz`` for each kind of :data:`INDEX_KINDS` and
:data:`SERVING_KINDS` whose file is there, from either package) instead
of ones built here; a kind missing from the directory is not searched.

``--full`` (on the card, one card a rank on NCCL) runs the layer at full
width instead: ``sharded_pq_train`` 8x256 over a 1M x 128 seeded Gaussian
mixture (the one ``chip_smoke.py`` makes) with and without the overlap,
one Lloyd step of the global accumulate beside K3's pass on the rank's
rows and its ``all_reduce`` alone, ``sharded_flat_search`` of 128
queries over the 1M ``PQIndex``, and ``sharded_ivf_search`` /
``sharded_ivf_scan_search`` over a 1M IVF1024 IVF-PQ and IVF-Flat f32
index at nprobe 8 and 64 (each rank's block bytes beside), each beside
the same index's single-card search, by CUDA events; every result is
held to the single-card function (:func:`run_full`) and rank 0 prints
the times as one JSON object.

    python -m vq_tpu_torch.parallel.dryrun --ranks 4 --device cuda --full --out full.json

:func:`run_checks` is the worker body: any initialized world can call it
(a world of one, for instance), and :func:`compare_runs` holds one run's
results to another's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

N_ROWS, DIM, M, K = 128, 32, 4, 8
N_QUERIES, TOP_K = 6, 5
BLOCK_ROWS = 4  # the overlap's half is rounded to this: small, so the tiny shards split
PQ_ITERS, LLOYD_K, LLOYD_ITERS = 2, 8, 3
CORPUS_ROWS, CORPUS_DIM, CORPUS_CHUNK = 200, 8, 16  # chunks that straddle the shards
INDEX_KINDS = ("flat", "flat_dot", "pq", "pq_unpacked", "rq", "sq")
# The sharded serving layer's indexes: IVF-PQ (L2 and dot, by residual or
# not), the IVF scan ladder, a graph and a refine index (sq8 codes over an
# IVF-PQ base), over NLIST lists: not a multiple of 4, so a 4-rank data
# axis pads the lists and its last rank owns none.
IVF_KINDS = ("ivfpq", "ivfpq_raw", "ivfpq_dot", "ivfpq_dot_res")
SCAN_KINDS = ("ivfflat", "ivfflat_dot", "ivfsq", "ivfrq", "ivfbinary")
SERVING_KINDS = IVF_KINDS + SCAN_KINDS + ("graph_index", "refine_index")
NLIST, NPROBES = 6, (2, 6)
GRAPH_DEGREE, GRAPH_BEAMS = 8, (8, 16)
REFINE_K_FACTOR, REFINE_NPROBE, REFINE_BATCHES = 2, 2, 2
FAR = 100.0  # init centroids this far off the data get no rows: the reseed path
# Tolerances of a sharded result against the single-device one or another
# world's (f32 summation order), as ``dryrun_multichip`` holds them.
RTOL = ATOL = 1e-5
SEARCH_ATOL = 1e-4
OPQ_MSE_RTOL = 2e-2
# --full: the smoke's phase-4 mixture (1M x 128, 1024 components of rank 24
# plus isotropic noise, seed 0) and its PQ 8x256, 10 iterations, k 10.
FULL_ROWS, FULL_QUERIES, FULL_DIM, FULL_CLUSTERS, FULL_LATENT = 1_000_000, 128, 128, 1024, 24
FULL_M, FULL_K, FULL_ITERS, FULL_TOP_K = 8, 256, 10, 10
FULL_NLIST, FULL_IVF_TRAIN, FULL_NPROBES = 1024, 200_000, (8, 64)
SEARCH_FNS = ("flat", "ivf", "scan", "graph", "refine")

__all__ = ["make_inputs", "build_indexes", "build_serving_indexes", "run_checks",
           "serving_checks", "check_single_device", "compare_runs", "search_parity", "opq_mse",
           "mixture", "run_full", "spawn", "main"]


def make_inputs(seed: int = 0) -> Dict[str, np.ndarray]:
    """The dry run's seeded numpy inputs (the same on every rank and in
    the tests that hold the results to the JAX package)."""
    rng = np.random.default_rng(seed)
    data = rng.random((N_ROWS, DIM), dtype=np.float32)
    init = data[rng.choice(N_ROWS, K, replace=False)].reshape(K, M, DIM // M).transpose(1, 0, 2)
    far = np.ascontiguousarray(init).copy()
    far[:, -2:] = FAR  # two clusters a subspace start empty
    return {
        "data": data,
        "weights": (rng.random(N_ROWS, dtype=np.float32) + 1.0),
        "init": np.ascontiguousarray(init),
        "init_far": far,
        "counts": np.floor(rng.random((M, K), dtype=np.float32) * 5.0),
        "queries": rng.random((N_QUERIES, DIM), dtype=np.float32),
    }


def build_indexes(inputs, device) -> dict:
    """One small index of each of :data:`INDEX_KINDS` and
    :data:`SERVING_KINDS` over the inputs' rows, on ``device``, trained
    from fixed seeds."""
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.models.rq import ResidualQuantizer
    from vq_tpu_torch.search import FlatIndex, PQIndex, RQIndex, SQIndex

    x = torch.from_numpy(inputs["data"]).to(device)
    pq = ProductQuantizer(x, M, K, max_iters=PQ_ITERS, seed=0)
    out = {"flat": FlatIndex.from_data(x), "flat_dot": FlatIndex.from_data(x, metric="dot"),
           "pq": PQIndex(pq), "pq_unpacked": PQIndex(pq, packed=False),
           "rq": RQIndex(ResidualQuantizer(x, 2, K, max_iters=PQ_ITERS, seed=0)),
           "sq": SQIndex.from_data(x)}
    for kind in ("pq", "pq_unpacked", "rq"):
        out[kind].add(x)
    out.update(build_serving_indexes(x))
    return out


def build_serving_indexes(x: torch.Tensor) -> dict:
    """One index of each of :data:`SERVING_KINDS` over the rows ``x``, on
    their device, trained from fixed seeds."""
    import vq_tpu_torch as V

    ivf = V.IVFPQIndex.train(x, NLIST, M, K, max_iters=PQ_ITERS, seed=0)
    pq_raw = V.ProductQuantizer(x, M, K, max_iters=PQ_ITERS, seed=1)
    out = {"ivfpq": ivf,
           "ivfpq_raw": V.IVFPQIndex(ivf.coarse, pq_raw, by_residual=False),
           "ivfpq_dot": V.IVFPQIndex(ivf.coarse, pq_raw, by_residual=False, metric="dot"),
           "ivfpq_dot_res": V.IVFPQIndex(ivf.coarse, ivf.pq, metric="dot"),
           "ivfflat": V.IVFFlatIndex(ivf.coarse),
           "ivfflat_dot": V.IVFFlatIndex(ivf.coarse, metric="dot"),
           "ivfsq": V.IVFSQIndex.train(x, NLIST, max_iters=PQ_ITERS, seed=0),
           "ivfrq": V.IVFRQIndex.train(x, NLIST, 2, K, max_iters=PQ_ITERS, seed=0),
           "ivfbinary": V.IVFBinaryIndex(ivf.coarse, threshold=0.5)}
    for kind in IVF_KINDS + SCAN_KINDS:
        out[kind].add(x)
    out["graph_index"] = V.GraphIndex.build(x, degree=GRAPH_DEGREE, seed=0)
    out["refine_index"] = V.RefineIndex(V.IVFPQIndex(ivf.coarse, ivf.pq), "sq8", sq_train_data=x)
    out["refine_index"].add(x)
    return out


def load_indexes(index_dir: str, device) -> dict:
    """Every index of :data:`INDEX_KINDS` and :data:`SERVING_KINDS` saved
    under ``index_dir`` (either package's checkpoints), on ``device``."""
    from vq_tpu_torch.factory import load_index

    return {kind: load_index(os.path.join(index_dir, f"{kind}.npz"), device=device)
            for kind in INDEX_KINDS + SERVING_KINDS
            if os.path.exists(os.path.join(index_dir, f"{kind}.npz"))}


def _np(t) -> np.ndarray:
    from vq_tpu_torch.parallel.mesh import gather_global

    return gather_global(t).detach().cpu().numpy()


def meshes_for(world: int):
    """The dry run's ``subspace_parallel`` values: 1, and 2 for an even
    world of more than one rank."""
    return (1, 2) if world > 1 and world % 2 == 0 else (1,)


def run_checks(device: str, indexes: Optional[dict] = None,
               inputs: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """Every sharded function of the slice on each mesh of
    :func:`meshes_for` -> ``{key: numpy result}``, the same on every rank.
    Every rank of an initialized world calls it."""
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.models.sq import ScalarQuantizer

    inputs = make_inputs() if inputs is None else inputs
    world = dist.get_world_size()
    data, weights = inputs["data"], inputs["weights"]
    out: Dict[str, np.ndarray] = {"world": np.array(world)}
    pid = torch.tensor([os.getpid()], dtype=torch.int64,
                       device="cuda" if device == "cuda" else "cpu")
    pids = [torch.empty_like(pid) for _ in range(world)]
    dist.all_gather(pids, pid)
    out["pids"] = torch.cat(pids).cpu().numpy()
    for sub in meshes_for(world):
        mesh = P.make_mesh(subspace_parallel=sub, device_type=device)
        tag = f"{world // sub}x{sub}"
        dev = P.mesh_device(mesh)
        if indexes is None:
            indexes = build_indexes(inputs, dev)

        def train(case, **kw):
            r = P.sharded_pq_train(data, M, K, mesh=mesh, block_rows=BLOCK_ROWS, **kw)
            for f in ("centroids", "iterations", "inertia"):
                out[f"pq_train/{case}/{tag}/{f}"] = _np(getattr(r, f))
            return r

        train("seeded", max_iters=PQ_ITERS, seed=0)
        train("seeded_single", max_iters=PQ_ITERS, seed=0, overlap=False)
        train("warm", max_iters=1, seed=0, init_codebooks=inputs["init"])
        train("weighted", max_iters=1, seed=0, init_codebooks=inputs["init"], weights=weights)
        train("reseed", max_iters=PQ_ITERS, seed=0, init_codebooks=inputs["init_far"])
        if sub == 1:  # m = 1 does not divide over two subspace shards
            for case, kw in (("seeded", {}), ("weighted", {"weights": weights})):
                r = P.sharded_lloyd(data, LLOYD_K, LLOYD_ITERS, seed=0, mesh=mesh,
                                    block_rows=BLOCK_ROWS, **kw)
                for f in ("centroids", "iterations", "inertia"):
                    out[f"lloyd/{case}/{tag}/{f}"] = _np(getattr(r, f))
        codes = P.sharded_pq_encode(data, inputs["init"], mesh=mesh)
        out[f"pq_encode/init/{tag}/codes"] = _np(codes)
        out[f"quantize/sq8/{tag}/codes"] = _np(P.sharded_quantize(ScalarQuantizer(0.0, 1.0), data,
                                                                  mesh=mesh))
        for case, counts in (("zero", np.zeros((M, K), np.float32)), ("counts", inputs["counts"])):
            for ov in (True, False):
                name = f"stream/{case}{'' if ov else '_single'}/{tag}"
                c, n, i = P.sharded_pq_minibatch_update(inputs["init"], counts, data, mesh=mesh,
                                                        overlap=ov)
                out[f"{name}/centroids"], out[f"{name}/counts"], out[f"{name}/inertia"] = (
                    _np(c), _np(n), _np(i))
        corpus = P.sharded_synthetic_corpus(CORPUS_ROWS, CORPUS_DIM, seed=3, mesh=mesh,
                                            chunk_rows=CORPUS_CHUNK)
        out[f"corpus/seed3/{tag}/rows"] = _np(corpus)
        rot, cb = P.sharded_opq_train(data, M, K, opq_iters=1, pq_iters=1, final_pq_iters=1, seed=0,
                                      mesh=mesh, block_rows=BLOCK_ROWS)
        rot, cb = _np(rot), _np(cb)
        out[f"opq/seeded/{tag}/rotation"], out[f"opq/seeded/{tag}/codebooks"] = rot, cb
        out[f"opq/seeded/{tag}/mse"] = np.array(opq_mse(data, rot, cb))
        out.update(error_cases(mesh, tag, inputs, indexes))
        q = torch.from_numpy(inputs["queries"]).to(dev)
        for kind in INDEX_KINDS:
            if kind not in indexes:
                continue
            ids, vals = P.sharded_flat_search(indexes[kind], q, TOP_K, mesh=mesh)
            out[f"flat/{kind}/{tag}/ids"], out[f"flat/{kind}/{tag}/values"] = _np(ids), _np(vals)
            out[f"blocks/{kind}/{tag}"] = _blocks(indexes[kind], mesh)
        out.update(serving_checks(mesh, tag, q, indexes))
    return out


def serving_checks(mesh, tag: str, q: torch.Tensor, indexes) -> Dict[str, np.ndarray]:
    """The sharded serving layer on ``mesh`` over the kinds of
    :data:`SERVING_KINDS` that ``indexes`` holds -> ``{key: result}``:
    IVF-PQ and the scan ladder at each of :data:`NPROBES` (``ivf/`` and
    ``scan/<kind>@<nprobe>``, with each rank's block, ``ivfblocks/``),
    ``shard_buckets``' global view of the IVF-PQ pool (``buckets/``), the
    graph at each of :data:`GRAPH_BEAMS`, and the refine index eagerly and
    through ``BatchPipeline.from_core`` over :data:`REFINE_BATCHES`
    batches (``refine/pipe<b>``)."""
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.serving import BatchPipeline

    out: Dict[str, np.ndarray] = {}

    def put(name, res):
        out[f"{name}/{tag}/ids"], out[f"{name}/{tag}/values"] = _np(res[0]), _np(res[1])

    for kind in IVF_KINDS + SCAN_KINDS:
        if kind not in indexes:
            continue
        fn, name = ((P.sharded_ivf_search, "ivf") if kind in IVF_KINDS
                    else (P.sharded_ivf_scan_search, "scan"))
        for p in NPROBES:
            put(f"{name}/{kind}@{p}", fn(indexes[kind], q, TOP_K, nprobe=p, mesh=mesh))
        out[f"ivfblocks/{kind}/{tag}"] = _ivf_blocks(indexes[kind], mesh)
    if "ivfpq" in indexes:
        slot_ids, codes, chains, cap, _ = P.shard_buckets(indexes["ivfpq"], mesh)
        out[f"buckets/ivfpq/{tag}/slot_ids"], out[f"buckets/ivfpq/{tag}/pool_codes"] = (
            _np(slot_ids), _np(codes))
        out[f"buckets/ivfpq/{tag}/chains"], out[f"buckets/ivfpq/{tag}/cap"] = _np(chains), np.array(cap)
    if "graph_index" in indexes:
        for beam in GRAPH_BEAMS:
            put(f"graph/beam{beam}", P.sharded_graph_search(indexes["graph_index"], q, TOP_K,
                                                            beam=beam, mesh=mesh))
    if "refine_index" in indexes:
        ref, kw = indexes["refine_index"], dict(k_factor=REFINE_K_FACTOR, nprobe=REFINE_NPROBE)
        put("refine/eager", P.sharded_refine_search(ref, q, TOP_K, mesh=mesh, **kw))
        core, arrays = P.sharded_refine_search_core(ref, TOP_K, mesh=mesh, **kw)
        ids, vals = BatchPipeline.from_core(core, arrays, dim=q.shape[1]).search(
            q.reshape(REFINE_BATCHES, -1, q.shape[1]))
        for b in range(REFINE_BATCHES):
            put(f"refine/pipe{b}", (ids[b], vals[b]))
    return out


def _ivf_blocks(index, mesh) -> np.ndarray:
    """``[world, 4]``: each rank's block of the list-sharded pool — its
    chunks, the chunks its ids' and its first payload's storage hold (its
    block only when equal), and its live chunks (its own lists')."""
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.parallel.ivf_scan import _shard_lists

    b = _shard_lists(mesh, index, tuple(getattr(index, "_scan_payloads", ("codes",))))
    pay = next(iter(b.payloads.values()))
    chunk_bytes = pay[0].numel() * pay.element_size()
    mine = torch.tensor([b.ids.shape[0], b.ids.untyped_storage().nbytes() // (b.ids[0].numel() * 4),
                         pay.untyped_storage().nbytes() // chunk_bytes,
                         int((b.chains_local >= 0).sum())],
                        dtype=torch.int64, device=P.mesh_device(mesh))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).cpu().numpy()


def _blocks(index, mesh) -> np.ndarray:
    """``[world, 2]``: each rank's rows in its search core's first array,
    and the rows that array's storage holds (its block only when equal)."""
    from vq_tpu_torch import parallel as P

    _, arrays = P.sharded_flat_search_core(index, TOP_K, mesh=mesh)
    a = arrays[0] if arrays else torch.empty(0)
    row_bytes = max(a[0].numel() * a.element_size(), 1) if a.shape[0] else 1
    mine = torch.tensor([a.shape[0], a.untyped_storage().nbytes() // row_bytes],
                        dtype=torch.int64, device=P.mesh_device(mesh))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).cpu().numpy()


def _raised(fn) -> np.ndarray:
    """``"<error class>:<parameter>"`` of what ``fn()`` raised (an error
    of the package's own or a ``TypeError``), or ``"none"``."""
    from vq_tpu_torch.errors import VqError

    try:
        fn()
    except (VqError, TypeError) as e:
        return np.array(f"{type(e).__name__}:{getattr(e, 'parameter', '')}")
    return np.array("none")


def error_cases(mesh, tag: str, inputs, indexes) -> Dict[str, np.ndarray]:
    """The validation cases of the JAX package's sharded tests on this
    mesh -> ``{"errors/<case>/<mesh>/raised": "<class>:<parameter>"}``.
    Each raises on every rank before any collective."""
    from vq_tpu_torch import parallel as P

    data, init, queries = inputs["data"], inputs["init"], inputs["queries"]
    cases = {
        "uneven_rows": lambda: P.sharded_pq_train(data[:N_ROWS - 1], M, K, 1, mesh=mesh),
        "uneven_subspaces": lambda: P.sharded_pq_train(data[:, :24], 3, K, 1, mesh=mesh),
        "bad_init_shape": lambda: P.sharded_pq_train(data, M, K, 1, mesh=mesh,
                                                     init_codebooks=init[:, :K - 1]),
        "bad_weight_length": lambda: P.sharded_pq_train(data, M, K, 1, mesh=mesh,
                                                        weights=inputs["weights"][:-4]),
        "too_few_rows": lambda: P.sharded_pq_train(data[:4 * mesh.size()], M, 4 * mesh.size() + 4,
                                                   1, mesh=mesh),
        "stream_uneven_batch": lambda: P.sharded_pq_minibatch_update(
            init, np.zeros((M, K), np.float32), data[:N_ROWS - 1], mesh=mesh),
        "stream_bad_width": lambda: P.sharded_pq_minibatch_update(
            init, np.zeros((M, K), np.float32), data[:, :16], mesh=mesh),
        "callback_uneven_rows": lambda: P.sharded_synthetic_corpus(N_ROWS - 1, 4, mesh=mesh),
        "encode_bad_width": lambda: P.sharded_pq_encode(data[:, :16], init, mesh=mesh),
        "flat_query_width": lambda: P.sharded_flat_search(indexes["pq"], queries[:, :16],
                                                          TOP_K, mesh=mesh),
        "flat_unknown_index": lambda: P.sharded_flat_search(object(), queries, TOP_K,
                                                            mesh=mesh),
    }
    if "pq" not in indexes:
        del cases["flat_query_width"]
    cases.update(serving_error_cases(mesh, queries, indexes))
    return {f"errors/{case}/{tag}/raised": _raised(fn) for case, fn in cases.items()}


def serving_error_cases(mesh, queries, indexes) -> dict:
    """``{case: fn}``: the serving layer's validation cases over the kinds
    ``indexes`` holds, each raising on every rank before any collective."""
    import vq_tpu_torch as V
    from vq_tpu_torch import parallel as P

    cases = {}
    narrow = queries[:, :16]
    if "ivfpq" in indexes:
        ivf = indexes["ivfpq"]
        cases["ivf_query_width"] = lambda: P.sharded_ivf_search(ivf, narrow, TOP_K, mesh=mesh)
        cases["ivf_empty"] = lambda: P.sharded_ivf_search(V.IVFPQIndex(ivf.coarse, ivf.pq),
                                                          queries, TOP_K, mesh=mesh)
        cases["scan_wrong_kind"] = lambda: P.sharded_ivf_scan_search(ivf, queries, TOP_K,
                                                                     mesh=mesh)
    if "ivfflat" in indexes:
        flat = indexes["ivfflat"]
        cases["scan_query_width"] = lambda: P.sharded_ivf_scan_search(flat, narrow, TOP_K,
                                                                      mesh=mesh)
        cases["scan_empty"] = lambda: P.sharded_ivf_scan_search(V.IVFFlatIndex(flat.coarse),
                                                                queries, TOP_K, mesh=mesh)
    if "graph_index" in indexes:
        cases["graph_query_width"] = lambda: P.sharded_graph_search(indexes["graph_index"], narrow,
                                                                    TOP_K, mesh=mesh)
    if "refine_index" in indexes:
        ref = indexes["refine_index"]
        cases["refine_query_width"] = lambda: P.sharded_refine_search(ref, narrow, TOP_K,
                                                                      mesh=mesh)
        cases["refine_k_factor"] = lambda: P.sharded_refine_search(ref, queries, TOP_K,
                                                                   k_factor=0.5, mesh=mesh)
    return cases


def opq_mse(data: np.ndarray, rot: np.ndarray, cb: np.ndarray) -> float:
    """Reconstruction MSE of ``data`` under ``(rotation, codebooks)`` in
    float64, the objective ``dryrun_multichip`` holds OPQ to."""
    xr = data.astype(np.float64) @ rot.astype(np.float64)
    m, _, s = cb.shape
    parts = []
    for i in range(m):
        xs = xr[:, i * s:(i + 1) * s]
        d2 = ((xs[:, None, :] - cb[i][None].astype(np.float64)) ** 2).sum(-1)
        parts.append(cb[i][d2.argmin(1)])
    return float(((xr - np.concatenate(parts, axis=1)) ** 2).mean())


def search_parity(name: str, got, want, *, atol: float = SEARCH_ATOL, rtol: float = RTOL) -> None:
    """Values within tolerance; ids equal at every rank whose value is
    unique in its row (tied ranks may hold another member of the tie)."""
    gids, gd = (np.asarray(a) for a in got)
    wids, wd = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gd, wd, atol=atol, rtol=rtol, err_msg=f"{name}: values drifted")
    unique = (wd[:, :, None] == wd[:, None, :]).sum(-1) == 1
    np.testing.assert_array_equal(np.where(unique, gids, -1), np.where(unique, wids, -1),
                                  err_msg=f"{name}: ids differ at unique-value ranks")


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def check_single_device(res: Dict[str, np.ndarray], inputs, indexes, device) -> int:
    """Hold every sharded result of ``res`` to the port's single-device
    function on the same inputs; raises on a mismatch, returns the number
    of results checked."""
    from vq_tpu_torch.models.base import default_device

    with default_device(device):
        return _check_single_device(res, inputs, indexes, device)


def _check_single_device(res, inputs, indexes, device) -> int:
    from vq_tpu_torch.models.opq import opq_train
    from vq_tpu_torch.models.pq import pq_encode
    from vq_tpu_torch.models.sq import ScalarQuantizer
    from vq_tpu_torch.ops.kmeans import lloyd_batched
    from vq_tpu_torch.ops.kmeans_stream import pq_minibatch_update

    x = torch.from_numpy(inputs["data"]).to(device)
    xb = x.view(N_ROWS, M, DIM // M).permute(1, 0, 2)
    ref = {
        "seeded": lloyd_batched(xb, K, PQ_ITERS, 0),
        "warm": lloyd_batched(xb, K, 1, 0, init_centroids=inputs["init"]),
        "reseed": lloyd_batched(xb, K, PQ_ITERS, 0, init_centroids=inputs["init_far"]),
    }
    ref["seeded_single"] = ref["seeded"]
    q = torch.from_numpy(inputs["queries"]).to(device)
    want_search = {kind: [a.cpu().numpy() for a in indexes[kind].search(q, TOP_K)]
                   for kind in INDEX_KINDS if kind in indexes}
    checked = 0
    for key, val in res.items():
        parts = key.split("/")
        if len(parts) != 4:
            continue
        fn, case, _, field = parts
        if fn == "pq_train" and case in ref and field == "centroids":
            _close(key, val, ref[case][0].cpu().numpy())
        elif fn == "pq_train" and case in ref and field == "iterations":
            np.testing.assert_array_equal(val, ref[case][1].cpu().numpy(), err_msg=key)
        elif fn == "pq_encode" and field == "codes":
            np.testing.assert_array_equal(
                val, pq_encode(x, torch.from_numpy(inputs["init"]).to(device),
                               "squared_euclidean").cpu().numpy(), err_msg=key)
        elif fn == "quantize":
            np.testing.assert_array_equal(val, ScalarQuantizer(0.0, 1.0).quantize(x).cpu().numpy(),
                                          err_msg=key)
        elif fn == "stream":
            counts = np.zeros((M, K), np.float32) if case.startswith("zero") else inputs["counts"]
            want = pq_minibatch_update(inputs["init"], counts, x)
            w = {"centroids": want[0], "counts": want[1], "inertia": want[2]}[field].cpu().numpy()
            if field == "counts":
                np.testing.assert_array_equal(val, w, err_msg=key)
            else:
                _close(key, val, w)
        elif fn == "corpus":
            rows = np.concatenate([
                np.random.default_rng((3, c0 // CORPUS_CHUNK)).random(
                    (min(CORPUS_CHUNK, CORPUS_ROWS - c0), CORPUS_DIM), dtype=np.float32)
                for c0 in range(0, CORPUS_ROWS, CORPUS_CHUNK)])
            np.testing.assert_array_equal(val, rows, err_msg=key)
        elif fn == "opq" and field == "mse":
            rot1, cb1 = opq_train(x, M, K, opq_iters=1, pq_iters=1, final_pq_iters=1, seed=0)
            single = opq_mse(inputs["data"], rot1.cpu().numpy(), cb1.cpu().numpy())
            _close(key, float(val), single, rtol=OPQ_MSE_RTOL, atol=0.0)
        elif fn == "flat" and field == "ids":
            search_parity(key, (val, res[key[:-3] + "values"]), want_search[case])
        elif fn in SEARCH_FNS and field == "ids":
            search_parity(key, (val, res[key[:-3] + "values"]),
                          single_device_search(fn, case, indexes, q), **_tier(case))
        else:
            continue
        checked += 1
    return checked


def single_device_search(fn: str, case: str, indexes, q: torch.Tensor):
    """The single-device search a serving result of ``fn`` / ``case`` is
    held to, as numpy ``(ids, values)``."""
    if fn in ("ivf", "scan"):
        kind, p = case.split("@")
        res = indexes[kind].search(q, TOP_K, nprobe=int(p))
    elif fn == "graph":
        res = indexes["graph_index"].search(q, TOP_K, beam=int(case[len("beam"):]))
    else:  # refine: eager, or one pipelined batch
        rows = q if case == "eager" else q.reshape(REFINE_BATCHES, -1, q.shape[1])[int(case[4:])]
        res = indexes["refine_index"].search(rows, TOP_K, k_factor=REFINE_K_FACTOR,
                                             nprobe=REFINE_NPROBE)
    return [a.cpu().numpy() for a in res]


def _tier(case: str) -> dict:
    """Hamming distances are small integers: held exactly."""
    return dict(atol=0.0, rtol=0.0) if case.startswith("ivfbinary") else {}


def _tagless(key: str) -> str:
    parts = key.split("/")
    return "/".join(parts[:2] + parts[3:]) if len(parts) == 4 else key


def compare_runs(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Hold each result of ``got`` (any mesh) to ``want``'s result of the
    same function and case (its first mesh): codes, counts, iterations and
    corpus rows exactly, centroids and inertia at ``RTOL``/``ATOL``, OPQ
    by its objective, searches by :func:`search_parity`. Returns the number
    of results compared; raises on a mismatch."""
    by_case = {}
    for key in want:
        by_case.setdefault(_tagless(key), key)
    compared = 0
    for key, val in got.items():
        other = by_case.get(_tagless(key))
        if other is None or key.count("/") != 3:
            continue
        fn, case, _, field = key.split("/")
        w = want[other]
        if field in ("codes", "counts", "iterations", "rows"):
            np.testing.assert_array_equal(val, w, err_msg=f"{key} vs {other}")
        elif field in ("centroids", "inertia"):
            _close(f"{key} vs {other}", val, w)
        elif field == "mse":
            _close(f"{key} vs {other}", float(val), float(w), rtol=OPQ_MSE_RTOL, atol=0.0)
        elif fn in SEARCH_FNS and field == "ids":
            search_parity(f"{key} vs {other}", (val, got[key[:-3] + "values"]),
                          (w, want[other[:-3] + "values"]), **_tier(case))
        else:
            continue
        compared += 1
    if not compared:
        raise AssertionError("compare_runs: no result in common")
    return compared


def mixture(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows [FULL_ROWS, FULL_DIM], queries [FULL_QUERIES, FULL_DIM])``
    of ``chip_smoke.py``'s seeded Gaussian mixture, made on ``device`` (the
    same bits on every card of one kind)."""
    g = torch.Generator(device=device).manual_seed(0)
    n, d, lat = FULL_ROWS + FULL_QUERIES, FULL_DIM, FULL_LATENT
    centres = torch.randn(FULL_CLUSTERS, d, generator=g, device=device) * 4.0
    lab = torch.randint(0, FULL_CLUSTERS, (n,), generator=g, device=device)
    basis = torch.randn(lat, d, generator=g, device=device) * (2.0 / lat ** 0.5)
    pts = (centres[lab] + torch.randn(n, lat, generator=g, device=device) @ basis
           + 0.1 * torch.randn(n, d, generator=g, device=device))
    return pts[:FULL_ROWS].contiguous(), pts[FULL_ROWS:].contiguous()


def _cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event ms of ``fn`` over ``reps`` calls after one warm
    call, every rank starting each call together."""
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run_full() -> Dict[str, object]:
    """The layer at full width on the card (see the module docstring) ->
    rank 0's ``{name: value}``; raises on any mismatch with the
    single-card functions."""
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.models.pq import ProductQuantizer
    from vq_tpu_torch.ops.cuda_kernels import pq_lloyd_accumulate_fused
    from vq_tpu_torch.ops.kmeans import default_block_rows, lloyd_batched
    from vq_tpu_torch.parallel.kmeans import global_accumulate
    from vq_tpu_torch.parallel.mesh import all_reduce_sum, local_rows
    from vq_tpu_torch.search import PQIndex

    mesh = P.make_mesh(device_type="cuda")
    dev, group, world = P.mesh_device(mesh), mesh.get_group(P.DATA_AXIS), dist.get_world_size()
    rank0 = dist.get_rank() == 0
    corpus, queries = mixture(dev)
    m, k, s = FULL_M, FULL_K, FULL_DIM // FULL_M
    dist.all_reduce(torch.zeros(1, device=dev), group=group)  # NCCL's communicator, set up
    res: Dict[str, object] = {"world": world, "rows": FULL_ROWS, "pq": f"{m}x{k}x{s}"}

    def train(iters=FULL_ITERS, **kw):
        return P.sharded_pq_train(corpus, m, k, iters, seed=0, mesh=mesh, **kw)

    cbs = {}
    for name, kw in (("overlap", {}), ("one_sweep", {"overlap": False})):
        r = train(**kw)
        res[f"pq_train_{name}_ms"] = _cuda_ms(lambda: train(**kw), 3)
        cbs[name] = r.centroids.to_local()
        res[f"pq_train_{name}_inertia"] = float(r.inertia.to_local())
        res[f"pq_train_{name}_iterations"] = r.iterations.to_local().tolist()
    cb = cbs["overlap"]
    # Held to the single card: one warm step exactly (its assignments are
    # the same row by row; the sums add in another order), the seeded runs
    # on iterations and inertia.
    xb = corpus.view(FULL_ROWS, m, s).permute(1, 0, 2)
    step = train(1, init_codebooks=cb).centroids.to_local()
    if rank0:
        want_step, _, _ = lloyd_batched(xb, k, 1, 0, init_centroids=cb)
        res["step_max_abs_err"] = float((step - want_step).abs().max())
        torch.testing.assert_close(step, want_step, rtol=RTOL, atol=ATOL)
        want_cb, want_it, _ = lloyd_batched(xb, k, FULL_ITERS, 0)
        want_inertia = float(pq_lloyd_accumulate_fused(corpus, want_cb)[2])
        res["lloyd_batched_inertia"] = want_inertia
        for name in ("overlap", "one_sweep"):
            res[f"pq_train_{name}_max_abs_gap"] = float((cbs[name] - want_cb).abs().max())
            assert res[f"pq_train_{name}_iterations"] == want_it.tolist(), name
            np.testing.assert_allclose(res[f"pq_train_{name}_inertia"], want_inertia, rtol=RTOL,
                                       err_msg=f"sharded_pq_train ({name}) inertia")
    # One iteration's global accumulate on this rank's rows, as the trainer runs it.
    x_l, _ = local_rows(corpus, mesh)
    block = default_block_rows(x_l.shape[0], k, s)
    half = ((x_l.shape[0] // 2) // block) * block
    sums, counts, inertia = pq_lloyd_accumulate_fused(x_l, cb)
    res["local_rows"] = int(x_l.shape[0])
    res["step_two_halves_ms"] = _cuda_ms(lambda: global_accumulate(x_l, None, cb, half, False,
                                                                   group))
    res["step_one_sweep_ms"] = _cuda_ms(lambda: global_accumulate(x_l, None, cb, 0, False, group))
    res["k3_local_pass_ms"] = _cuda_ms(lambda: pq_lloyd_accumulate_fused(x_l, cb))
    res["all_reduce_ms"] = _cuda_ms(lambda: all_reduce_sum([sums, counts, inertia], group), 20)
    res["all_reduce_share"] = res["all_reduce_ms"] / res["step_one_sweep_ms"]
    # The flat search over the 1M PQIndex: each rank keeps its block.
    index = PQIndex(ProductQuantizer(codebooks=cb))
    index.add(corpus)
    fn, arrays = P.sharded_flat_search_core(index, FULL_TOP_K, mesh=mesh)
    res["search_block_rows"] = int(arrays[0].shape[0])
    got = fn(queries, *arrays)
    if rank0:
        want = index.search(queries, FULL_TOP_K)
        search_parity("sharded_flat_search PQIndex", [a.cpu().numpy() for a in got],
                      [a.cpu().numpy() for a in want])
    res["sharded_search_core_ms"] = _cuda_ms(lambda: fn(queries, *arrays), 10)
    res["sharded_flat_search_ms"] = _cuda_ms(
        lambda: P.sharded_flat_search(index, queries, FULL_TOP_K, mesh=mesh), 10)
    res["single_card_search_ms"] = _cuda_ms(lambda: index.search(queries, FULL_TOP_K), 10)
    del index, fn, arrays
    res.update(_full_ivf(mesh, corpus, queries, cb))
    return res


def _full_ivf(mesh, corpus, queries, cb) -> Dict[str, object]:
    """``run_full``'s IVF part: an IVF1024 IVF-PQ (the trained 8x256
    codebooks, by residual) and IVF-Flat f32 over the 1M rows, the coarse
    centroids trained on rank 0 and broadcast; ``sharded_ivf_search`` /
    ``sharded_ivf_scan_search`` at each of :data:`FULL_NPROBES` held to
    rank 0's single-card search (bit for bit in a world of one), and each
    rank's block bytes."""
    import vq_tpu_torch as V
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.ops.kmeans import lloyd
    from vq_tpu_torch.parallel.ivf_scan import _shard_lists

    dev, world = P.mesh_device(mesh), dist.get_world_size()
    rank0 = dist.get_rank() == 0
    coarse = torch.empty((FULL_NLIST, FULL_DIM), device=dev)
    if rank0:
        coarse.copy_(lloyd(corpus[:FULL_IVF_TRAIN], FULL_NLIST, max_iters=10, seed=42,
                           init="kmeans++").centroids)
    dist.broadcast(coarse, 0)
    res: Dict[str, object] = {"ivf": f"IVF{FULL_NLIST}"}
    # The PQ codebooks trained above on the raw rows code the residuals
    # here: a search's work and its parity do not depend on their fit.
    indexes = {"ivfpq": (V.IVFPQIndex(coarse, V.ProductQuantizer(codebooks=cb)),
                         P.sharded_ivf_search_core),
               "ivfflat": (V.IVFFlatIndex(coarse), P.sharded_scan_search_core)}
    for name, (index, core) in indexes.items():
        index.add(corpus)
        for p in FULL_NPROBES:
            fn, arrays = core(index, FULL_TOP_K, nprobe=p, mesh=mesh)
            got = fn(queries, *arrays)
            if rank0:
                want = index.search(queries, FULL_TOP_K, nprobe=p)
                if world == 1:
                    assert all(torch.equal(a, b) for a, b in zip(got, want)), f"{name} nprobe {p}"
                else:
                    search_parity(f"sharded {name} nprobe {p}", [a.cpu().numpy() for a in got],
                                  [a.cpu().numpy() for a in want])
            res[f"{name}_sharded_ms_nprobe{p}"] = _cuda_ms(lambda: fn(queries, *arrays), 10)
            res[f"{name}_single_card_ms_nprobe{p}"] = _cuda_ms(
                lambda: index.search(queries, FULL_TOP_K, nprobe=p), 10)
        b = _shard_lists(mesh, index, tuple(getattr(index, "_scan_payloads", ("codes",))))
        block = sum(t.numel() * t.element_size() for t in [b.ids, *b.payloads.values()])
        sizes = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([block], dtype=torch.int64, device=dev))
        res[f"{name}_block_bytes_by_rank"] = [int(t) for t in sizes]
        res[f"{name}_pool_bytes"] = sum(t.numel() * t.element_size()
                                        for t in list(index._pool.data.values())
                                        + [index._pool.slot_ids])
        del index
    return res


def _worker(rank: int, world: int, device: str, backend: str, port: int, out: str,
            index_dir: Optional[str], full: bool = False) -> None:
    from vq_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)  # the rank's card, modulo the visible ones
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, backend=backend,
                     device_type=device, timeout=300)
    try:
        if full:
            res = run_full()
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(res, f)
            dist.barrier()
            return
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
        inputs = make_inputs()
        indexes = load_indexes(index_dir, dev) if index_dir else build_indexes(inputs, dev)
        res = run_checks(device, indexes, inputs)
        if rank == 0:
            res["checked"] = np.array(check_single_device(res, inputs, indexes, dev))
            res["backend"] = np.array(dist.get_backend())
            np.savez(out, **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(ranks: int, device: str, out: str, *, backend: Optional[str] = None,
          index_dir: Optional[str] = None, full: bool = False):
    """Run :func:`run_checks` (or, ``full``, :func:`run_full`) in a world
    of ``ranks`` fresh processes and return rank 0's results (written to
    ``out``). A rank that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    from vq_tpu_torch.parallel.mesh import _BACKENDS

    if device == "cuda":  # build the kernels once, before the ranks start
        from vq_tpu_torch.ops._build import LIBRARY

        LIBRARY.get()
    backend = backend or _BACKENDS[device]
    mp.start_processes(_worker, args=(ranks, device, backend, _free_port(), out, index_dir, full),
                       nprocs=ranks, join=True, start_method="spawn")
    if full:
        with open(out) as f:
            return json.load(f)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the collectives' backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--out", required=True, help="the .npz the results go to")
    ap.add_argument("--indexes", default=None, help="a directory of <kind>.npz indexes to search")
    ap.add_argument("--full", action="store_true",
                    help="the full-width run on the card, one card a rank (--out gets its JSON)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    if args.full:
        if args.device != "cuda" or torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"--full needs {args.ranks} cards, one a rank")
        res = spawn(args.ranks, "cuda", args.out, backend=args.backend, full=True)
        res["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()
        print(json.dumps(res))
        return 0
    res = spawn(args.ranks, args.device, args.out, backend=args.backend, index_dir=args.indexes)
    print(f"dryrun ok: world {int(res['world'])}, backend {res['backend']}, "
          f"{int(res['checked'])} results held to the single-device functions -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
