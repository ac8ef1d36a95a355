"""The sharded serving half of ``vq_tpu_torch.parallel`` (``ivf_scan``,
``ivf``, ``refine``, ``graph``) against ``vq_tpu.parallel`` (JAX on
4-device meshes of the 8-device CPU mesh of ``tests/conftest.py``) and
against the port's single-device searches, mirroring the serving checks
of ``__graft_entry__.py::dryrun_multichip``.

The port's side runs once, as a 4-rank gloo world of separate processes
(``python -m vq_tpu_torch.parallel.dryrun --ranks 4 --device cpu
--indexes DIR``) over the JAX package's checkpoints of every kind of
``dryrun.SERVING_KINDS``, on the meshes ``(4, 1)`` and ``(2, 2)``; the
JAX side searches the same indexes on meshes of the same shapes. The
world-of-one, R3, R8 and cache cases run in this process.

Tiers, as the single-device parity tests hold each family:

* IVF-PQ (ADC sums): values within rtol 1e-5 / atol 1e-4;
* IVF-Flat, IVF-SQ, IVF-RQ (distances assembled from norms and dots):
  rtol 1e-5 / atol 1e-3 (``test_torch_ivf_flat.assert_probe_parity``);
* IVF-Binary: Hamming distances exactly;
* the graph and the refine index: rtol 1e-5 / atol 1e-4;

with ids equal wherever a value is apart from the rest of its row by
more than the tolerance. ``shard_buckets``' global view equals the JAX
package's bit for bit, and a world of one is the single-device search bit
for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vq_tpu.parallel as jpar
import vq_tpu_torch
import vq_tpu_torch.parallel as tpar
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.parallel import dryrun
from test_torch_ivf_flat import assert_probe_parity
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
INPUTS = dryrun.make_inputs()
M, K, TOP_K = dryrun.M, dryrun.K, dryrun.TOP_K
TAGS = {"4x1": 1, "2x2": 2}  # mesh tag -> subspace_parallel
ADC_TOL = dict(rtol=1e-5, atol=1e-4)
NORM_TOL = dict(rtol=1e-5, atol=1e-3)
EXACT = dict(rtol=0.0, atol=0.0)
TIERS = {"ivfflat": NORM_TOL, "ivfflat_dot": NORM_TOL, "ivfsq": NORM_TOL, "ivfrq": NORM_TOL,
         "ivfbinary": EXACT}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with default_device("cpu"):
        yield


def _jax_serving_indexes():
    """The dry run's serving indexes, built by the JAX package as
    ``dryrun.build_serving_indexes`` builds them in the port."""
    import vq_tpu
    from vq_tpu.graph import GraphIndex
    from vq_tpu.ivf import IVFPQIndex
    from vq_tpu.ivf_binary import IVFBinaryIndex
    from vq_tpu.ivf_flat import IVFFlatIndex, IVFRQIndex, IVFSQIndex
    from vq_tpu.refine import RefineIndex

    x = INPUTS["data"]
    ivf = IVFPQIndex.train(x, dryrun.NLIST, M, K, max_iters=dryrun.PQ_ITERS, seed=0)
    pq_raw = vq_tpu.ProductQuantizer(x, M, K, max_iters=dryrun.PQ_ITERS, seed=1)
    out = {"ivfpq": ivf,
           "ivfpq_raw": IVFPQIndex(ivf.coarse, pq_raw, by_residual=False),
           "ivfpq_dot": IVFPQIndex(ivf.coarse, pq_raw, by_residual=False, metric="dot"),
           "ivfpq_dot_res": IVFPQIndex(ivf.coarse, ivf.pq, metric="dot"),
           "ivfflat": IVFFlatIndex(ivf.coarse),
           "ivfflat_dot": IVFFlatIndex(ivf.coarse, metric="dot"),
           "ivfsq": IVFSQIndex.train(x, dryrun.NLIST, max_iters=dryrun.PQ_ITERS, seed=0),
           "ivfrq": IVFRQIndex.train(x, dryrun.NLIST, 2, K, max_iters=dryrun.PQ_ITERS, seed=0),
           "ivfbinary": IVFBinaryIndex(ivf.coarse, threshold=0.5)}
    for kind in dryrun.IVF_KINDS + dryrun.SCAN_KINDS:
        out[kind].add(x)
    out["graph_index"] = GraphIndex.build(x, degree=dryrun.GRAPH_DEGREE, seed=0)
    out["refine_index"] = RefineIndex(IVFPQIndex(ivf.coarse, ivf.pq), "sq8", sq_train_data=x)
    out["refine_index"].add(x)
    return out


@pytest.fixture(scope="module")
def jax_indexes():
    return _jax_serving_indexes()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory, jax_indexes):
    d = tmp_path_factory.mktemp("serving")
    for kind, idx in jax_indexes.items():
        idx.save(str(d / kind))
    return d


@pytest.fixture(scope="module")
def run4(index_dir):
    """The port's 4-rank world over the JAX package's checkpoints."""
    out = index_dir / "run4.npz"
    cmd = [sys.executable, "-m", "vq_tpu_torch.parallel.dryrun", "--ranks", "4", "--device",
           "cpu", "--out", str(out), "--indexes", str(index_dir)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run(cmd, check=True, timeout=300, cwd=REPO, env=env, capture_output=True)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port_indexes(index_dir):
    """The same checkpoints restored in the port, on the CPU."""
    return dryrun.load_indexes(str(index_dir), "cpu")


@pytest.fixture(scope="module")
def jmesh():
    return {tag: jpar.make_mesh(n_devices=4, subspace_parallel=sub) for tag, sub in TAGS.items()}


@pytest.fixture(scope="module")
def mesh1():
    """A world of one in this process (gloo on a local store)."""
    import torch.distributed as dist

    mesh = tpar.make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _got(run, name, tag):
    return run[f"{name}/{tag}/ids"], run[f"{name}/{tag}/values"]


def _np(res):
    return [np.asarray(a) for a in res]


def _hold(got, want, tol):
    if tol is EXACT:
        np.testing.assert_array_equal(got[1], want[1])
    assert_probe_parity(got, want, **tol)


# ---------------------------------------------------------------------------
# The 4-rank world.
# ---------------------------------------------------------------------------


def test_world_serves_the_jax_checkpoints(run4):
    """Four processes searched every serving kind, and rank 0 held each
    result to the port's single-device search in the run."""
    assert int(run4["world"]) == 4 and str(run4["backend"]) == "gloo"
    assert len(set(run4["pids"].tolist())) == 4 and os.getpid() not in run4["pids"].tolist()
    searches = [k for k in run4 if k.endswith("/ids") and k.split("/")[0] in dryrun.SEARCH_FNS]
    # 9 IVF kinds x 2 nprobe, 2 beams, the eager refine and 2 pipelined batches, on 2 meshes.
    assert len(searches) == 2 * (9 * 2 + 2 + 1 + dryrun.REFINE_BATCHES)
    assert not any(k.startswith("flat/") for k in run4)  # no flat checkpoint was given
    assert int(run4["checked"]) >= 30 + len(searches)


def test_serving_meshes_agree(run4):
    """Every serving result of the (2, 2) mesh held to the (4, 1) mesh's."""
    serving = {k: v for k, v in run4.items() if k.split("/")[0] in dryrun.SEARCH_FNS}
    by_tag = {tag: {k: v for k, v in serving.items() if f"/{tag}/" in k} for tag in TAGS}
    assert dryrun.compare_runs(by_tag["2x2"], by_tag["4x1"]) == len(by_tag["4x1"]) // 2


@pytest.mark.parametrize("p", dryrun.NPROBES)
@pytest.mark.parametrize("kind", dryrun.IVF_KINDS)
@pytest.mark.parametrize("tag", TAGS)
def test_ivf_search_matches_jax_and_single_device(run4, jmesh, jax_indexes, port_indexes, tag,
                                                  kind, p):
    got = _got(run4, f"ivf/{kind}@{p}", tag)
    q = INPUTS["queries"]
    j = jpar.sharded_ivf_search(jax_indexes[kind], q, TOP_K, nprobe=p, mesh=jmesh[tag])
    _hold(got, _np(j), ADC_TOL)
    _hold(got, _np(port_indexes[kind].search(q, TOP_K, nprobe=p)), ADC_TOL)


@pytest.mark.parametrize("p", dryrun.NPROBES)
@pytest.mark.parametrize("kind", dryrun.SCAN_KINDS)
@pytest.mark.parametrize("tag", TAGS)
def test_scan_search_matches_jax_and_single_device(run4, jmesh, jax_indexes, port_indexes, tag,
                                                   kind, p):
    got = _got(run4, f"scan/{kind}@{p}", tag)
    q = INPUTS["queries"]
    j = jpar.sharded_ivf_scan_search(jax_indexes[kind], q, TOP_K, nprobe=p, mesh=jmesh[tag])
    _hold(got, _np(j), TIERS[kind])
    _hold(got, _np(port_indexes[kind].search(q, TOP_K, nprobe=p)), TIERS[kind])


@pytest.mark.parametrize("beam", dryrun.GRAPH_BEAMS)
@pytest.mark.parametrize("tag", TAGS)
def test_graph_search_matches_jax_and_single_device(run4, jmesh, jax_indexes, port_indexes, tag,
                                                    beam):
    """Six queries over four ranks: two a rank, the last rank all pad."""
    got = _got(run4, f"graph/beam{beam}", tag)
    q = INPUTS["queries"]
    j = jpar.sharded_graph_search(jax_indexes["graph_index"], q, TOP_K, beam=beam,
                                  mesh=jmesh[tag])
    _hold(got, _np(j), ADC_TOL)
    _hold(got, _np(port_indexes["graph_index"].search(q, TOP_K, beam=beam)), ADC_TOL)


@pytest.mark.parametrize("tag", TAGS)
def test_refine_pipeline_matches_jax(run4, jmesh, jax_indexes, port_indexes, tag):
    """The pipelined refine: a sharded IVF-PQ base with sq8 codes, its
    ``sharded_refine_search_core`` driven by ``BatchPipeline.from_core``
    over two batches, each held to the JAX package's pipeline and to the
    port's ``RefineIndex.search``; the eager search likewise."""
    from vq_tpu.serving import BatchPipeline

    kw = dict(k_factor=dryrun.REFINE_K_FACTOR, nprobe=dryrun.REFINE_NPROBE)
    q = INPUTS["queries"]
    core, arrays = jpar.sharded_refine_search_core(jax_indexes["refine_index"], TOP_K,
                                                   mesh=jmesh[tag], **kw)
    batches = q.reshape(dryrun.REFINE_BATCHES, -1, dryrun.DIM)
    jids, jd = BatchPipeline.from_core(core, arrays, dim=dryrun.DIM).search(batches)
    ref = port_indexes["refine_index"]
    for b in range(dryrun.REFINE_BATCHES):
        got = _got(run4, f"refine/pipe{b}", tag)
        _hold(got, [np.asarray(jids[b]), np.asarray(jd[b])], ADC_TOL)
        _hold(got, _np(ref.search(batches[b], TOP_K, **kw)), ADC_TOL)
    got = _got(run4, "refine/eager", tag)
    _hold(got, _np(jpar.sharded_refine_search(jax_indexes["refine_index"], q, TOP_K,
                                              mesh=jmesh[tag], **kw)), ADC_TOL)
    _hold(got, _np(ref.search(q, TOP_K, **kw)), ADC_TOL)


@pytest.mark.parametrize("tag", TAGS)
def test_shard_buckets_equal_jax_bit_for_bit(run4, jmesh, jax_indexes, tag):
    """The global view of the port's DTensors (gathered over the data
    axis) is the JAX package's sharded arrays, bit for bit, on the same
    checkpoint: the same blocks in the same order, the same block-local
    chains over the padded lists, the same searched cap."""
    slot_ids, codes, chains, cap, _ = jpar.shard_buckets(jax_indexes["ivfpq"], jmesh[tag])
    pre = f"buckets/ivfpq/{tag}"
    np.testing.assert_array_equal(run4[f"{pre}/slot_ids"], np.asarray(slot_ids))
    np.testing.assert_array_equal(run4[f"{pre}/pool_codes"], np.asarray(codes))
    np.testing.assert_array_equal(run4[f"{pre}/chains"], np.asarray(chains))
    assert int(run4[f"{pre}/cap"]) == int(cap)
    data = 4 // TAGS[tag]
    assert chains.shape[0] == -(-dryrun.NLIST // data) * data


@pytest.mark.parametrize("kind", dryrun.IVF_KINDS + dryrun.SCAN_KINDS)
@pytest.mark.parametrize("tag", TAGS)
def test_ranks_hold_their_block_only(run4, port_indexes, tag, kind):
    """Each rank's arrays are its own block of the pool, copied: their
    storage holds its block's chunks and no other, and its live chunks are
    exactly its own lists' (the last rank of the (4, 1) mesh owns only pad
    lists, and holds one dead chunk)."""
    blocks = run4[f"ivfblocks/{kind}/{tag}"]  # [world, (chunks, ids', payload's, live)]
    data = 4 // TAGS[tag]
    per = -(-dryrun.NLIST // data)
    chains = port_indexes[kind]._pool._chains_h
    maxc = -(-port_indexes[kind]._pool.cap // port_indexes[kind]._pool.ch)
    live = [int((chains[min(s * per, dryrun.NLIST):min((s + 1) * per, dryrun.NLIST), :maxc]
                 >= 0).sum()) for s in range(data)]
    width = max(1, max(live))
    for rank, row in enumerate(blocks.tolist()):
        s = rank // TAGS[tag]  # the rank's place on the data axis
        assert row == [width, width, width, live[s]], (rank, row)


def _raised(fn) -> str:
    from vq_tpu.errors import VqError

    try:
        fn()
    except (VqError, TypeError) as e:
        return f"{type(e).__name__}:{getattr(e, 'parameter', '')}"
    return "none"


@pytest.mark.parametrize("tag", TAGS)
def test_error_cases_match_jax(run4, jmesh, jax_indexes, tag):
    """Each serving validation case raises the JAX package's class with
    its parameter: a wrong query width, an empty index, an IVF-PQ index
    given to the scan ladder, a ``k_factor`` below 1."""
    from vq_tpu.ivf import IVFPQIndex
    from vq_tpu.ivf_flat import IVFFlatIndex

    mesh, q = jmesh[tag], INPUTS["queries"]
    narrow = q[:, :16]
    ivf, flat = jax_indexes["ivfpq"], jax_indexes["ivfflat"]
    ref, graph = jax_indexes["refine_index"], jax_indexes["graph_index"]
    want = {
        "ivf_query_width": lambda: jpar.sharded_ivf_search(ivf, narrow, TOP_K, mesh=mesh),
        "ivf_empty": lambda: jpar.sharded_ivf_search(IVFPQIndex(ivf.coarse, ivf.pq), q, TOP_K,
                                                     mesh=mesh),
        "scan_wrong_kind": lambda: jpar.sharded_ivf_scan_search(ivf, q, TOP_K, mesh=mesh),
        "scan_query_width": lambda: jpar.sharded_ivf_scan_search(flat, narrow, TOP_K, mesh=mesh),
        "scan_empty": lambda: jpar.sharded_ivf_scan_search(IVFFlatIndex(flat.coarse), q, TOP_K,
                                                           mesh=mesh),
        "graph_query_width": lambda: jpar.sharded_graph_search(graph, narrow, TOP_K, mesh=mesh),
        "refine_query_width": lambda: jpar.sharded_refine_search(ref, narrow, TOP_K, mesh=mesh),
        "refine_k_factor": lambda: jpar.sharded_refine_search(ref, q, TOP_K, k_factor=0.5,
                                                              mesh=mesh),
    }
    for case, fn in want.items():
        assert str(run4[f"errors/{case}/{tag}/raised"]) == _raised(fn), case


# ---------------------------------------------------------------------------
# A world of one: bit for bit the single-device searches.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """Port indexes of every serving kind over 8-row chunks (lists of
    several chunks, so chains and blocks are more than one chunk long)."""
    x = torch.from_numpy(INPUTS["data"])
    out = dryrun.build_serving_indexes(x)
    for kind in dryrun.SCAN_KINDS:
        old = out[kind]
        old.chunk_rows = 8
        old._pool, old._flat_lists = None, None
        old.add(x)
    return out


@pytest.mark.parametrize("kind", dryrun.IVF_KINDS + dryrun.SCAN_KINDS)
def test_world_of_one_ivf_bit_for_bit(mesh1, small, kind):
    fn = tpar.sharded_ivf_search if kind in dryrun.IVF_KINDS else tpar.sharded_ivf_scan_search
    q = INPUTS["queries"]
    for p in (1,) + dryrun.NPROBES:
        got = fn(small[kind], q, TOP_K, nprobe=p, mesh=mesh1)
        want = small[kind].search(q, TOP_K, nprobe=p)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (kind, p)
    if kind in dryrun.SCAN_KINDS:
        assert small[kind]._pool.maxc > 1  # chains of several chunks


def test_world_of_one_graph_and_refine_bit_for_bit(mesh1, small):
    q = INPUTS["queries"]
    g = small["graph_index"]
    for beam in dryrun.GRAPH_BEAMS:
        got = tpar.sharded_graph_search(g, q, TOP_K, beam=beam, mesh=mesh1)
        assert all(torch.equal(a, b) for a, b in zip(got, g.search(q, TOP_K, beam=beam)))
    ref = small["refine_index"]
    kw = dict(k_factor=dryrun.REFINE_K_FACTOR, nprobe=dryrun.REFINE_NPROBE)
    got = tpar.sharded_refine_search(ref, q, TOP_K, mesh=mesh1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref.search(q, TOP_K, **kw)))
    core, arrays = tpar.sharded_refine_search_core(ref, TOP_K, mesh=mesh1, **kw)
    ids, vals = vq_tpu_torch.BatchPipeline.from_core(core, arrays, dim=dryrun.DIM).search(
        q.reshape(2, 3, dryrun.DIM))
    for b in range(2):
        want = ref.search(q[3 * b:3 * b + 3], TOP_K, **kw)
        assert torch.equal(ids[b], want[0]) and torch.equal(vals[b], want[1])


@pytest.mark.parametrize("base,refiner", [("ivfflat", "flat"), ("ivfsq", "sq8"), ("pq", "flat"),
                                          ("pq", "residual_pq"), ("ivfpq", "residual_pq")])
def test_world_of_one_refine_bases_bit_for_bit(mesh1, small, base, refiner):
    """``_base_core`` dispatches each base family to its sharded core (the
    scan ladder, the flat rows, IVF-PQ); a residual PQ refiner carries the
    base's ``_reconstruct_core`` to the rank."""
    x = torch.from_numpy(INPUTS["data"])
    if base == "pq":
        b = vq_tpu_torch.PQIndex(vq_tpu_torch.ProductQuantizer(x, M, K, max_iters=2, seed=0))
    elif base == "ivfpq":
        b = vq_tpu_torch.IVFPQIndex(small["ivfpq"].coarse, small["ivfpq"].pq)
    elif base == "ivfsq":
        b = vq_tpu_torch.IVFSQIndex(small["ivfsq"].coarse, small["ivfsq"].sq, chunk_rows=8)
    else:
        b = vq_tpu_torch.IVFFlatIndex(small["ivfflat"].coarse, chunk_rows=8)
    if refiner == "residual_pq":
        ref = vq_tpu_torch.RefineIndex.train_pq(b, x, num_subspaces=M, num_centroids=K,
                                                max_iters=2, seed=0)
    else:
        ref = vq_tpu_torch.RefineIndex(b, refiner, sq_train_data=x)
    ref.add(x)
    kw = {} if base == "pq" else {"nprobe": 3}
    q = INPUTS["queries"]
    got = tpar.sharded_refine_search(ref, q, TOP_K, k_factor=3, mesh=mesh1, **kw)
    want = ref.search(q, TOP_K, k_factor=3, **kw)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("case", ["flat_base_params", "unknown_base", "k_factor", "empty"])
def test_world_of_one_refine_validation_matches_jax(mesh1, jmesh, case):
    """The refine core's checks, each with the JAX package's class and
    parameter: search params given to a flat base, a base with no sharded
    core, ``k_factor`` below 1, an empty index."""
    from vq_tpu.refine import RefineIndex as JRefine
    from vq_tpu.search import BinaryIndex as JBinary, FlatIndex as JFlat

    x = INPUTS["data"]
    jbase = {"unknown_base": lambda: JBinary(dryrun.DIM)}.get(case, lambda: JFlat(dryrun.DIM))()
    tbase = ({"unknown_base": lambda: vq_tpu_torch.BinaryIndex(dryrun.DIM)}
             .get(case, lambda: vq_tpu_torch.FlatIndex(dryrun.DIM))())
    jref, tref = JRefine(jbase, "flat"), vq_tpu_torch.RefineIndex(tbase, "flat")
    if case != "empty":
        jref.add(x)
        tref.add(x)
    kw = {"flat_base_params": {"nprobe": 2}, "k_factor": {"k_factor": 0.5}}.get(case, {})
    want = _raised(lambda: jpar.sharded_refine_search_core(jref, TOP_K, mesh=jmesh["4x1"], **kw))
    got = str(dryrun._raised(lambda: tpar.sharded_refine_search_core(tref, TOP_K, mesh=mesh1,
                                                                      **kw)))
    assert want != "none" and got == want


def test_scan_search_type_error_names_the_kind(mesh1, small):
    with pytest.raises(TypeError, match="IVFPQIndex"):
        tpar.sharded_ivf_scan_search(small["ivfpq"], INPUTS["queries"], TOP_K, mesh=mesh1)


# ---------------------------------------------------------------------------
# Caches: R3 and the graph's replica.
# ---------------------------------------------------------------------------


def _front_empty_coarse():
    """Two far centroids ahead of six trained ones: lists 0 and 1 stay
    empty, and ``rebalance(min_size=1)`` retires them by relabelling the
    other lists alone, with no row moved."""
    x = torch.from_numpy(INPUTS["data"])
    base = vq_tpu_torch.lloyd(x, 6, max_iters=2, seed=0, init="kmeans++").centroids.numpy()
    return np.concatenate([np.full((2, dryrun.DIM), 50.0, np.float32), base])


def test_stale_blocks_after_relabel_rebalance_R3(mesh1, jmesh):
    """R3: the reference caches its blocks on the identity of ``slot_ids``
    (``vq_tpu/parallel/ivf_scan.py:61-65``), which the relabel keeps, so
    after ``rebalance(min_size=1)`` its sharded search reads the old
    chains under the new list ids and disagrees with its own single-device
    search; the port keys on ``ChunkPool.version`` and rebuilds."""
    from vq_tpu.ivf_flat import IVFFlatIndex as JFlat

    coarse, x, q = _front_empty_coarse(), INPUTS["data"], INPUTS["queries"]
    j, t = JFlat(coarse), vq_tpu_torch.IVFFlatIndex(coarse, chunk_rows=8)
    j.add(x)
    t.add(x)
    for idx, search in ((j, lambda i: jpar.sharded_ivf_scan_search(i, q, TOP_K, nprobe=3,
                                                                   mesh=jmesh["4x1"])),
                        (t, lambda i: tpar.sharded_ivf_scan_search(i, q, TOP_K, nprobe=3,
                                                                   mesh=mesh1))):
        search(idx)  # fills the cache
        info = idx.rebalance(min_size=1, target_max=10 ** 6)
        assert info == {"split": 0, "retired": 2, "new_nlist": 6}
    jgot = np.asarray(jpar.sharded_ivf_scan_search(j, q, TOP_K, nprobe=3, mesh=jmesh["4x1"])[0])
    jwant = np.asarray(j.search(q, TOP_K, nprobe=3)[0])
    assert (jgot != jwant).any()  # the reference is stale
    version = t._pool.version
    got = tpar.sharded_ivf_scan_search(t, q, TOP_K, nprobe=3, mesh=mesh1)
    assert all(torch.equal(a, b) for a, b in zip(got, t.search(q, TOP_K, nprobe=3)))
    assert t._shard_cache[2] == version
    np.testing.assert_array_equal(got[0].numpy(), jwant)  # the port agrees with the reference's own


@pytest.mark.parametrize("mutation", ["add", "remove_ids", "merge_from"])
def test_ivf_blocks_follow_the_pool(mesh1, small, mutation):
    """Every pool mutation bumps ``ChunkPool.version``, and the next
    sharded search rebuilds the blocks from the pool as it is."""
    x = INPUTS["data"]
    idx = vq_tpu_torch.IVFPQIndex(small["ivfpq"].coarse, small["ivfpq"].pq)
    idx.add(x[:64])
    q = INPUTS["queries"]
    tpar.sharded_ivf_search(idx, q, TOP_K, nprobe=3, mesh=mesh1)
    cached = idx._shard_cache[4]
    if mutation == "add":
        idx.add(x[64:])
    elif mutation == "remove_ids":
        idx.remove_ids(np.arange(0, 64, 3))
    else:
        other = vq_tpu_torch.IVFPQIndex(idx.coarse, idx.pq)
        other.add(x[64:])
        idx.merge_from(other)
    got = tpar.sharded_ivf_search(idx, q, TOP_K, nprobe=3, mesh=mesh1)
    assert idx._shard_cache[4] is not cached
    assert all(torch.equal(a, b) for a, b in zip(got, idx.search(q, TOP_K, nprobe=3)))


def test_graph_cache_drops_on_add_and_remove(mesh1):
    """``GraphIndex.add`` and ``remove_ids`` drop the sharded search's
    replica, as ``vq_tpu/graph.py:981, 1115`` do, and the next search
    copies the index as it is."""
    x = torch.from_numpy(INPUTS["data"])
    g = vq_tpu_torch.GraphIndex.build(x[:96], degree=dryrun.GRAPH_DEGREE, seed=0)
    q = INPUTS["queries"]
    tpar.sharded_graph_search(g, q, TOP_K, beam=16, mesh=mesh1)
    assert g._replica_cache is not None and g._replica_cache[1][0].shape[0] == 96
    g.add(x[96:])
    assert g._replica_cache is None
    got = tpar.sharded_graph_search(g, q, TOP_K, beam=16, mesh=mesh1)
    assert g._replica_cache[1][0].shape[0] == dryrun.N_ROWS
    assert all(torch.equal(a, b) for a, b in zip(got, g.search(q, TOP_K, beam=16)))
    g.remove_ids(np.arange(10))
    assert g._replica_cache is None
    got = tpar.sharded_graph_search(g, q, TOP_K, beam=16, mesh=mesh1)
    assert all(torch.equal(a, b) for a, b in zip(got, g.search(q, TOP_K, beam=16)))


# ---------------------------------------------------------------------------
# R8 in the IVF merge.
# ---------------------------------------------------------------------------


def test_ivf_merge_negative_nan_R8(mesh1, jmesh):
    """R8: a row of +inf gives a NaN distance (``inf - inf``); the
    reference's ``lax.top_k`` merges (``vq_tpu/parallel/ivf_scan.py:133``
    and the single-device search) rank it first, the port's ranks every
    NaN last, in its sharded search as in its single-device one."""
    from vq_tpu.ivf_flat import IVFFlatIndex as JFlat

    coarse = _front_empty_coarse()[2:]
    x = INPUTS["data"].copy()
    x[5] = np.inf
    q = INPUTS["queries"]
    j = JFlat(coarse)
    j.add(x)
    jids, jd = jpar.sharded_ivf_scan_search(j, q, 3, nprobe=6, mesh=jmesh["4x1"])
    assert (np.asarray(jids)[:, 0] == 5).all() and np.isnan(np.asarray(jd)[:, 0]).all()
    t = vq_tpu_torch.IVFFlatIndex(coarse)
    t.add(x)
    tids, td = tpar.sharded_ivf_scan_search(t, q, 3, nprobe=6, mesh=mesh1)
    assert (tids != 5).all() and torch.isfinite(td).all()
    sids, sd = t.search(q, 3, nprobe=6)
    assert torch.equal(tids, sids) and torch.equal(td, sd)


def test_merge_ties_go_to_the_lowest_rank(monkeypatch):
    """``mesh.merge_topk`` over three ranks' local top-2 (the gather
    replaced by the three packed buffers it would return): equal values
    (±0.0 alike) rank by rank, then by position, every NaN last whatever
    its sign bit (R8), and the values come back with their own bits."""
    import vq_tpu_torch.parallel.mesh as pmesh

    vals = [torch.tensor([[0.0, 1.0]]), torch.tensor([[-0.0, float("nan")]]),
            torch.tensor([[-float("nan"), 1.0]])]
    ids = [torch.tensor([[10, 11]]), torch.tensor([[20, 21]]), torch.tensor([[30, 31]])]
    parts = [torch.stack([v.view(torch.int32), i.to(torch.int32)]) for v, i in zip(vals, ids)]
    monkeypatch.setattr(pmesh, "_all_gather", lambda packed, group: parts)
    got_ids, got_vals = pmesh.merge_topk(ids[0], vals[0], 6, group=None)
    assert got_ids[0].tolist() == [10, 20, 11, 31, 21, 30]
    assert got_vals[0, :4].tolist() == [0.0, -0.0, 1.0, 1.0]
    assert torch.signbit(got_vals[0, 1]) and torch.isnan(got_vals[0, 4:]).all()


# ---------------------------------------------------------------------------
# Imports.
# ---------------------------------------------------------------------------


def test_port_serving_imports_no_jax():
    code = (
        "import sys\n"
        "import vq_tpu_torch.parallel.ivf, vq_tpu_torch.parallel.ivf_scan\n"
        "import vq_tpu_torch.parallel.refine, vq_tpu_torch.parallel.graph\n"
        "import vq_tpu_torch.native, vq_tpu_torch.pyvq\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vq_tpu', 'pyvq') "
        "or m.startswith(('jax.', 'vq_tpu.', 'pyvq.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)
