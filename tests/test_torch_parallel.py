"""``vq_tpu_torch.parallel`` against ``vq_tpu.parallel`` (JAX on the
8-device CPU mesh of ``tests/conftest.py``) and against the port's
single-device functions, mirroring ``tests/test_sharded.py``.

The port's side runs once, as a 4-rank gloo world of separate processes
(``python -m vq_tpu_torch.parallel.dryrun --ranks 4 --device cpu``), on
the meshes ``(4, 1)`` and ``(2, 2)``; the JAX side runs the same numpy
inputs (``dryrun.make_inputs``) on 4-device meshes of the same shapes.
The validation cases and the named splits run in a world of one in this
process.

Tolerances and splits:

* warm-started ``sharded_pq_train``, weighted or not: centroids within
  atol and rtol 1e-5, inertia within rtol 1e-5 (``dryrun_multichip``'s
  bounds); the weighted data gives every cluster ``Σw >= 1``, where the
  port's divisor and the reference's ``max(Σw, 1)`` agree — R6 is its
  own test;
* seeded runs: the port's draws are ``lloyd_batched``'s (held within
  1e-5 of it, iterations equal); the JAX package's threefry draws are
  compared on inertia;
* ``sharded_pq_encode`` and ``sharded_quantize``: codes bit for bit;
* ``sharded_pq_minibatch_update``: counts exact, centroids within 1e-5;
* ``sharded_synthetic_corpus``: bit for bit;
* ``sharded_opq_train`` (R10): MSE within 2% of the JAX package's sharded
  result and of the port's ``opq_train``;
* ``sharded_flat_search`` over indexes restored from the JAX package's
  checkpoints (``convert.from_state`` through ``load_index``): ids equal
  at every rank with a unique value, values within rtol 1e-5 / atol 1e-4;
* R1 (``jnp.argmin`` lets a NaN score win), R6 (``max(Σw, 1)``) and R8
  (``lax.top_k`` ranks a negative NaN first) on the sharded paths.
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
from vq_tpu_torch.ops.kmeans import lloyd, lloyd_batched
from vq_tpu_torch.parallel import dryrun
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
INPUTS = dryrun.make_inputs()
M, K = dryrun.M, dryrun.K
TAGS = {"4x1": 1, "2x2": 2}  # mesh tag -> subspace_parallel
TOL = dict(rtol=dryrun.RTOL, atol=dryrun.ATOL)


def run_dryrun(ranks: int, out: Path, index_dir=None) -> dict:
    """``python -m vq_tpu_torch.parallel.dryrun`` as a gloo world of
    ``ranks`` processes on the CPU -> its results."""
    cmd = [sys.executable, "-m", "vq_tpu_torch.parallel.dryrun", "--ranks", str(ranks),
           "--device", "cpu", "--out", str(out)]
    if index_dir is not None:
        cmd += ["--indexes", str(index_dir)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run(cmd, check=True, timeout=300, cwd=REPO, env=env, capture_output=True)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with default_device("cpu"):
        yield


def _jax_indexes():
    import vq_tpu
    from vq_tpu.models.rq import ResidualQuantizer
    from vq_tpu.search import FlatIndex, PQIndex, RQIndex, SQIndex

    x = INPUTS["data"]
    pq = vq_tpu.ProductQuantizer(x, M, K, max_iters=2, seed=0)
    out = {"flat": FlatIndex.from_data(x), "flat_dot": FlatIndex.from_data(x, metric="dot"),
           "pq": PQIndex(pq), "pq_unpacked": PQIndex(pq, packed=False),
           "rq": RQIndex(ResidualQuantizer(x, 2, K, max_iters=2, seed=0)),
           "sq": SQIndex.from_data(x)}
    for kind in ("pq", "pq_unpacked", "rq"):
        out[kind].add(x)
    return out


@pytest.fixture(scope="module")
def jax_indexes():
    return _jax_indexes()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory, jax_indexes):
    """The JAX package's indexes, saved as its checkpoints."""
    d = tmp_path_factory.mktemp("parallel")
    for kind, idx in jax_indexes.items():
        idx.save(str(d / kind))
    return d


@pytest.fixture(scope="module")
def run4(index_dir):
    """The port's 4-rank run over the JAX package's saved indexes."""
    return run_dryrun(4, index_dir / "run4.npz", index_dir)


@pytest.fixture(scope="module")
def port_indexes(index_dir):
    """The same checkpoints restored in the port (``convert.from_state``)."""
    from vq_tpu_torch.factory import load_index

    return {kind: load_index(str(index_dir / f"{kind}.npz"), device="cpu")
            for kind in dryrun.INDEX_KINDS}


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


def _x():
    return torch.from_numpy(INPUTS["data"])


def test_world_crosses_process_boundaries(run4):
    assert int(run4["world"]) == 4
    pids = run4["pids"].tolist()
    assert len(set(pids)) == 4 and os.getpid() not in pids
    assert str(run4["backend"]) == "gloo"
    assert int(run4["checked"]) >= 60  # rank 0's single-device checks all held


def test_the_two_meshes_agree(run4):
    """Every (2, 2) result held to the (4, 1) result of the same function
    and case: only comparisons across the meshes count."""
    by_tag = {tag: {k: v for k, v in run4.items() if f"/{tag}/" in k} for tag in TAGS}
    # 5 training cases x (centroids, iterations, inertia), the codes of the
    # encode and of SQ8, 4 streaming cases x 3 fields, the corpus, OPQ's
    # MSE and 6 searches (sharded_lloyd runs on the (4, 1) mesh only).
    assert dryrun.compare_runs(by_tag["2x2"], by_tag["4x1"]) == 15 + 2 + 12 + 1 + 1 + 6


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tag", TAGS)
def test_warm_pq_train_matches_jax(run4, jmesh, tag, weighted):
    w = INPUTS["weights"] if weighted else None
    j = jpar.sharded_pq_train(INPUTS["data"], M, K, max_iters=1, seed=0, mesh=jmesh[tag],
                              block_rows=dryrun.BLOCK_ROWS, weights=w,
                              init_codebooks=INPUTS["init"])
    case = "weighted" if weighted else "warm"
    got = run4[f"pq_train/{case}/{tag}/centroids"]
    np.testing.assert_allclose(got, np.asarray(j.centroids), **TOL)
    np.testing.assert_allclose(run4[f"pq_train/{case}/{tag}/inertia"], float(j.inertia), rtol=1e-5)
    if weighted:  # every cluster's Σw >= 1: the divisors of R6 agree here
        codes = vq_tpu_torch.pq_encode(INPUTS["data"], INPUTS["init"], "squared_euclidean")
        for i in range(M):
            mass = np.bincount(codes[:, i].numpy(), weights=INPUTS["weights"], minlength=K)
            assert mass.min() >= 1.0


@pytest.mark.parametrize("case", ["seeded", "seeded_single", "reseed"])
@pytest.mark.parametrize("tag", TAGS)
def test_pq_train_follows_lloyd_batched(run4, tag, case):
    """Every rank draws ``lloyd_batched``'s rows (the init, and the reseeds
    of the clusters that ``init_far`` leaves empty), so the sharded run is
    the single-device one up to f32 summation order."""
    xb = _x().view(-1, M, dryrun.DIM // M).permute(1, 0, 2)
    init = INPUTS["init_far"] if case == "reseed" else None
    cb, it, _ = lloyd_batched(xb, K, dryrun.PQ_ITERS, 0, init_centroids=init)
    got = run4[f"pq_train/{case}/{tag}/centroids"]
    np.testing.assert_allclose(got, cb.numpy(), **TOL)
    np.testing.assert_array_equal(run4[f"pq_train/{case}/{tag}/iterations"], it.numpy())
    if case == "reseed":
        assert np.abs(got).max() < 2.0  # the far clusters were reseeded from rows


@pytest.mark.parametrize("tag", TAGS)
def test_seeded_pq_train_metric_against_jax(run4, jmesh, tag):
    """The torch generators cannot replay threefry: the seeded runs of the
    two packages are held on inertia."""
    j = jpar.sharded_pq_train(INPUTS["data"], M, K, max_iters=dryrun.PQ_ITERS, seed=0,
                              mesh=jmesh[tag], block_rows=dryrun.BLOCK_ROWS)
    got = float(run4[f"pq_train/seeded/{tag}/inertia"])
    assert abs(got - float(j.inertia)) <= 0.1 * float(j.inertia)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_lloyd_against_lloyd_and_jax(run4, jmesh, weighted):
    """``sharded_lloyd`` is ``sharded_pq_train(m=1)`` swept by K2: its
    start is lane 0's draw of ``lloyd_batched``, and from those rows it
    is ``lloyd`` (no cluster empties on this data); against the JAX
    package, on inertia."""
    case = "weighted" if weighted else "seeded"
    w = INPUTS["weights"] if weighted else None
    g = torch.Generator().manual_seed(0 * 1_000_003)
    start = _x()[torch.randperm(dryrun.N_ROWS, generator=g)[:dryrun.LLOYD_K]]
    ref = lloyd(_x(), dryrun.LLOYD_K, dryrun.LLOYD_ITERS, init_centroids=start, weights=w)
    np.testing.assert_allclose(run4[f"lloyd/{case}/4x1/centroids"], ref.centroids.numpy(), **TOL)
    assert int(run4[f"lloyd/{case}/4x1/iterations"]) == int(ref.iterations)
    np.testing.assert_allclose(run4[f"lloyd/{case}/4x1/inertia"], float(ref.inertia), rtol=1e-5)
    if not weighted:
        cb, _, _ = lloyd_batched(_x()[None], dryrun.LLOYD_K, dryrun.LLOYD_ITERS, 0)
        np.testing.assert_allclose(run4[f"lloyd/{case}/4x1/centroids"], cb[0].numpy(), **TOL)
    j = jpar.sharded_lloyd(INPUTS["data"], dryrun.LLOYD_K, dryrun.LLOYD_ITERS, seed=0,
                           mesh=jmesh["4x1"], block_rows=dryrun.BLOCK_ROWS, weights=w)
    got = float(run4[f"lloyd/{case}/4x1/inertia"])
    assert abs(got - float(j.inertia)) <= 0.1 * float(j.inertia)


# ---------------------------------------------------------------------------
# Encoding, streaming, OPQ.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_encode_and_quantize_bit_exact(run4, jmesh, tag):
    from vq_tpu.models.sq import ScalarQuantizer

    j = jpar.sharded_pq_encode(INPUTS["data"], INPUTS["init"], mesh=jmesh[tag])
    np.testing.assert_array_equal(run4[f"pq_encode/init/{tag}/codes"], np.asarray(j))
    jq = jpar.sharded_quantize(ScalarQuantizer(0.0, 1.0), INPUTS["data"], mesh=jmesh[tag])
    np.testing.assert_array_equal(run4[f"quantize/sq8/{tag}/codes"], np.asarray(jq))


@pytest.mark.parametrize("tag,case,overlap", [
    ("4x1", "counts", True), ("4x1", "zero", False), ("2x2", "counts", True),
])
def test_minibatch_update_matches_jax(run4, jmesh, tag, case, overlap):
    counts = np.zeros((M, K), np.float32) if case == "zero" else INPUTS["counts"]
    jc, jn, ji = jpar.sharded_pq_minibatch_update(INPUTS["init"], counts, INPUTS["data"],
                                                  mesh=jmesh[tag], overlap=overlap)
    name = f"stream/{case}{'' if overlap else '_single'}/{tag}"
    np.testing.assert_array_equal(run4[f"{name}/counts"], np.asarray(jn))
    np.testing.assert_allclose(run4[f"{name}/centroids"], np.asarray(jc), **TOL)
    np.testing.assert_allclose(run4[f"{name}/inertia"], np.asarray(ji), rtol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
def test_synthetic_corpus_bit_exact(run4, jmesh, tag):
    j = jpar.sharded_synthetic_corpus(dryrun.CORPUS_ROWS, dryrun.CORPUS_DIM, seed=3,
                                      mesh=jmesh[tag], chunk_rows=dryrun.CORPUS_CHUNK)
    np.testing.assert_array_equal(run4[f"corpus/seed3/{tag}/rows"], np.asarray(j))


@pytest.mark.parametrize("tag", TAGS)
def test_opq_mse_R10(run4, jmesh, tag):
    """R10: the rotations' fp32 products differ in their last bits between
    the packages, and the SVD amplifies a flipped assignment, so OPQ is
    held on its objective: within 2% of the JAX package's sharded MSE and
    of the port's ``opq_train``."""
    from vq_tpu_torch.models.opq import opq_train

    rot, cb = jpar.sharded_opq_train(INPUTS["data"], M, K, opq_iters=1, pq_iters=1,
                                     final_pq_iters=1, seed=0, mesh=jmesh[tag],
                                     block_rows=dryrun.BLOCK_ROWS)
    got = float(run4[f"opq/seeded/{tag}/mse"])
    want = dryrun.opq_mse(INPUTS["data"], np.asarray(rot), np.asarray(cb))
    assert abs(got - want) <= 0.02 * want
    r1, c1 = opq_train(_x(), M, K, opq_iters=1, pq_iters=1, final_pq_iters=1, seed=0)
    single = dryrun.opq_mse(INPUTS["data"], r1.numpy(), c1.numpy())
    assert abs(got - single) <= 0.02 * single
    r = run4[f"opq/seeded/{tag}/rotation"]
    np.testing.assert_allclose(r @ r.T, np.eye(dryrun.DIM), atol=1e-4)


# ---------------------------------------------------------------------------
# Flat search.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", dryrun.INDEX_KINDS)
@pytest.mark.parametrize("tag", TAGS)
def test_flat_search_matches_jax_and_single_device(run4, jmesh, jax_indexes, port_indexes, tag,
                                                    kind):
    got = (run4[f"flat/{kind}/{tag}/ids"], run4[f"flat/{kind}/{tag}/values"])
    q = INPUTS["queries"]
    j = jpar.sharded_flat_search(jax_indexes[kind], q, dryrun.TOP_K, mesh=jmesh[tag])
    dryrun.search_parity(f"{kind} {tag} vs JAX", got, [np.asarray(a) for a in j])
    single = port_indexes[kind].search(q, dryrun.TOP_K)
    dryrun.search_parity(f"{kind} {tag} vs single device", got, [a.numpy() for a in single])


@pytest.mark.parametrize("kind", dryrun.INDEX_KINDS)
@pytest.mark.parametrize("tag", TAGS)
def test_flat_search_ranks_hold_their_block_only(run4, tag, kind):
    """Each rank's search arrays are its own row block of the JAX
    package's layout (``ceil(n / D)`` rows a data shard), copied: their
    storage holds those rows and no other."""
    blocks = run4[f"blocks/{kind}/{tag}"]  # [world, (rows, rows in storage)]
    sub = TAGS[tag]
    want = [dryrun.N_ROWS // (4 // sub)] * 4
    assert blocks[:, 0].tolist() == want
    assert blocks[:, 1].tolist() == want


# ---------------------------------------------------------------------------
# Validation (the 4-rank world and a world of one) and the named splits.
# ---------------------------------------------------------------------------


def _jax_raised(fn) -> str:
    from vq_tpu.errors import VqError

    try:
        fn()
    except VqError as e:
        return f"{type(e).__name__}:{getattr(e, 'parameter', '')}"
    return "none"


@pytest.mark.parametrize("tag", TAGS)
def test_error_cases_match_jax(run4, jmesh, jax_indexes, tag):
    """Each validation case raises the JAX package's class with its
    parameter on the same mesh shape (uneven rows, uneven subspaces, a bad
    ``init_codebooks`` shape, a wrong query width, ...)."""
    mesh, data, init = jmesh[tag], INPUTS["data"], INPUTS["init"]
    n = dryrun.N_ROWS
    want = {
        "uneven_rows": lambda: jpar.sharded_pq_train(data[:n - 1], M, K, 1, mesh=mesh),
        "uneven_subspaces": lambda: jpar.sharded_pq_train(data[:, :24], 3, K, 1, mesh=mesh),
        "bad_init_shape": lambda: jpar.sharded_pq_train(data, M, K, 1, mesh=mesh,
                                                        init_codebooks=init[:, :K - 1]),
        "bad_weight_length": lambda: jpar.sharded_pq_train(data, M, K, 1, mesh=mesh,
                                                           weights=INPUTS["weights"][:-4]),
        "too_few_rows": lambda: jpar.sharded_pq_train(data[:16], M, 20, 1, mesh=mesh),
        "stream_uneven_batch": lambda: jpar.sharded_pq_minibatch_update(
            init, np.zeros((M, K), np.float32), data[:n - 1], mesh=mesh),
        "stream_bad_width": lambda: jpar.sharded_pq_minibatch_update(
            init, np.zeros((M, K), np.float32), data[:, :16], mesh=mesh),
        "callback_uneven_rows": lambda: jpar.sharded_synthetic_corpus(n - 1, 4, mesh=mesh),
        "encode_bad_width": lambda: jpar.sharded_pq_encode(data[:, :16], init, mesh=mesh),
        "flat_query_width": lambda: jpar.sharded_flat_search(
            jax_indexes["pq"], INPUTS["queries"][:, :16], dryrun.TOP_K, mesh=mesh),
        "flat_unknown_index": lambda: jpar.sharded_flat_search(
            object(), INPUTS["queries"], dryrun.TOP_K, mesh=mesh),
    }
    for case, fn in want.items():
        assert str(run4[f"errors/{case}/{tag}/raised"]) == _jax_raised(fn), case


@pytest.mark.parametrize("case", [
    "not_2d", "empty", "m_not_dividing_d", "bad_init_shape", "nan_weights", "query_width",
    "unknown_index", "sub_not_dividing_world", "n_devices_not_the_world",
])
def test_world_of_one_validation(mesh1, case):
    """The cases of ``tests/test_sharded.py`` that a single rank can
    reach, each with the JAX package's class and parameter."""
    from vq_tpu_torch.errors import DimensionMismatch, EmptyInput, InvalidParameter

    x = INPUTS["data"]
    flat = vq_tpu_torch.FlatIndex.from_data(x)
    cases = {
        "not_2d": (InvalidParameter, lambda: tpar.sharded_pq_train(x[0], M, K, mesh=mesh1)),
        "empty": (EmptyInput, lambda: tpar.sharded_pq_train(x[:0], M, K, mesh=mesh1)),
        "m_not_dividing_d": (InvalidParameter, lambda: tpar.sharded_pq_train(x, 5, K, mesh=mesh1)),
        "bad_init_shape": (InvalidParameter, lambda: tpar.sharded_pq_train(
            x, M, K, mesh=mesh1, init_codebooks=np.zeros((M, K, 3), np.float32))),
        "nan_weights": (InvalidParameter, lambda: tpar.sharded_pq_train(
            x, M, K, mesh=mesh1, weights=np.full(len(x), np.nan, np.float32))),
        "query_width": (DimensionMismatch, lambda: tpar.sharded_flat_search(
            flat, INPUTS["queries"][:, :8], 3, mesh=mesh1)),
        "unknown_index": (InvalidParameter, lambda: tpar.sharded_flat_search(
            object(), INPUTS["queries"], 3, mesh=mesh1)),
        "sub_not_dividing_world": (InvalidParameter, lambda: tpar.make_mesh(
            subspace_parallel=2, device_type="cpu")),
        "n_devices_not_the_world": (InvalidParameter, lambda: tpar.make_mesh(
            n_devices=2, device_type="cpu")),
    }
    err, fn = cases[case]
    with pytest.raises(err):
        fn()


def test_world_of_one_single_sweep_is_lloyd_batched_bit_for_bit(mesh1):
    """With ``overlap=False`` on a world of one the collectives add
    nothing, so the sharded trainer and the streaming step are the
    single-device functions bit for bit."""
    from vq_tpu_torch.ops.kmeans_stream import pq_minibatch_update

    xb = _x().view(-1, M, dryrun.DIM // M).permute(1, 0, 2)
    r = tpar.sharded_pq_train(INPUTS["data"], M, K, 3, seed=5, mesh=mesh1, overlap=False)
    cb, it, _ = lloyd_batched(xb, K, 3, 5)
    assert torch.equal(r.centroids.to_local(), cb) and torch.equal(r.iterations.to_local(), it)
    got = tpar.sharded_pq_minibatch_update(INPUTS["init"], INPUTS["counts"], INPUTS["data"],
                                           mesh=mesh1, overlap=False)
    want = pq_minibatch_update(INPUTS["init"], INPUTS["counts"], _x())
    assert all(torch.equal(g.to_local(), w) for g, w in zip(got, want))


def test_world_of_one_overlap_is_one_sweep(mesh1):
    """A data axis of one rank has nothing to hide a collective under, so
    the overlap runs one sweep: the default is bit for bit the
    single-device trainer, and ``sharded_opq_train`` (which skips the
    trainer's final inertia pass) is ``opq_train``."""
    from vq_tpu_torch.models.opq import opq_train

    xb = _x().view(-1, M, dryrun.DIM // M).permute(1, 0, 2)
    r = tpar.sharded_pq_train(INPUTS["data"], M, K, 3, seed=5, mesh=mesh1,
                              block_rows=dryrun.BLOCK_ROWS)
    cb, it, _ = lloyd_batched(xb, K, 3, 5)
    assert torch.equal(r.centroids.to_local(), cb) and torch.equal(r.iterations.to_local(), it)
    rot, ocb = tpar.sharded_opq_train(INPUTS["data"], M, K, opq_iters=2, pq_iters=2,
                                      final_pq_iters=2, seed=0, mesh=mesh1,
                                      block_rows=dryrun.BLOCK_ROWS)
    rot1, cb1 = opq_train(_x(), M, K, opq_iters=2, pq_iters=2, final_pq_iters=2, seed=0)
    assert torch.equal(rot.to_local(), rot1) and torch.equal(tpar.gather_global(ocb), cb1)


def test_minibatch_nan_centroid_R1(mesh1, jmesh):
    """R1: ``jnp.argmin`` (``vq_tpu/parallel/stream.py:45``) lets a NaN
    score win, so the reference sends every row of subspace 0 to the NaN
    centroid; the port's ``int2`` rule never picks it."""
    init = INPUTS["init"].copy()
    init[0, 3] = np.nan
    zero = np.zeros((M, K), np.float32)
    _, jn, _ = jpar.sharded_pq_minibatch_update(init, zero, INPUTS["data"], mesh=jmesh["4x1"])
    _, tn, _ = tpar.sharded_pq_minibatch_update(init, zero, INPUTS["data"], mesh=mesh1)
    assert np.asarray(jn)[0, 3] == dryrun.N_ROWS  # the reference: all rows to NaN
    assert tn.to_local()[0, 3] == 0 and tn.to_local()[0].sum() == dryrun.N_ROWS


def test_pq_train_nan_centroid_R1(mesh1, jmesh):
    """R1 at ``vq_tpu/parallel/kmeans.py:94``: the reference's NaN centroid
    takes every row of subspace 0 and becomes their mean; the port's
    ``int2`` rule leaves it empty, and it is reseeded from a row."""
    init = INPUTS["init"].copy()
    init[0, 3] = np.nan
    j = jpar.sharded_pq_train(INPUTS["data"], M, K, 1, mesh=jmesh["4x1"], init_codebooks=init)
    t = tpar.sharded_pq_train(INPUTS["data"], M, K, 1, mesh=mesh1, init_codebooks=init)
    sub0 = INPUTS["data"][:, :dryrun.DIM // M]
    np.testing.assert_allclose(np.asarray(j.centroids)[0, 3], sub0.mean(0), rtol=1e-5)
    got = t.centroids.to_local()[0, 3].numpy()
    assert (sub0 == got).all(1).any()  # one of the rows, bit for bit


def test_weighted_light_cluster_R6(mesh1, jmesh):
    """R6: rows 1..10 with weight 0.05 each; the reference divides their
    sum by ``max(Σw, 1)`` = 1 (``vq_tpu/parallel/kmeans.py:245``) and puts
    the centroid at 2.75, the port divides by Σw = 0.5: 5.5."""
    x = np.concatenate([np.arange(1, 11), np.arange(100, 110)]).astype(np.float32)[:, None]
    w = np.concatenate([np.full(10, 0.05), np.ones(10)]).astype(np.float32)
    init = np.array([[[5.0], [100.0]]], np.float32)
    j = jpar.sharded_pq_train(x, 1, 2, 1, mesh=jmesh["4x1"], weights=w, init_codebooks=init)
    t = tpar.sharded_pq_train(x, 1, 2, 1, mesh=mesh1, weights=w, init_codebooks=init)
    assert np.isclose(np.asarray(j.centroids)[0, 0, 0], 2.75)
    assert np.isclose(float(t.centroids.to_local()[0, 0, 0]), 5.5)


def test_flat_merge_negative_nan_R8(mesh1, jmesh):
    """R8: a row of +inf gives a NaN squared distance with its sign bit
    set (x86's ``inf - inf``); the reference's ``lax.top_k(-d)`` merge
    (``vq_tpu/parallel/flat.py:52``) ranks it first, the port's merge
    last, so the port returns the finite rows' top-k, as its
    single-device search does."""
    from vq_tpu.search import FlatIndex as JFlat

    x = INPUTS["data"][:16].copy()
    x[5] = np.inf
    q = INPUTS["queries"][:2]
    jids, jd = jpar.sharded_flat_search(JFlat.from_data(x), q, 3, mesh=jmesh["4x1"])
    assert (np.asarray(jids)[:, 0] == 5).all() and np.isnan(np.asarray(jd)[:, 0]).all()
    flat = vq_tpu_torch.FlatIndex.from_data(x)
    tids, td = tpar.sharded_flat_search(flat, q, 3, mesh=mesh1)
    sids, sd = flat.search(q, 3)
    assert (tids != 5).all() and torch.isfinite(td).all()
    assert torch.equal(tids, sids) and torch.equal(td, sd)


def test_results_are_placed_dtensors(mesh1):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    r = tpar.sharded_pq_train(INPUTS["data"], M, K, 1, mesh=mesh1)
    assert isinstance(r.centroids, DTensor) and r.centroids.placements == (Replicate(), Shard(0))
    codes = tpar.sharded_pq_encode(tpar.shard_rows(INPUTS["data"], mesh1), r.centroids, mesh=mesh1)
    assert codes.placements == (Shard(0), Replicate()) and codes.shape == (dryrun.N_ROWS, M)
    rep = tpar.replicate(INPUTS["init"], mesh1)
    assert torch.equal(tpar.gather_global(rep), torch.from_numpy(INPUTS["init"]))


def test_port_parallel_imports_no_jax():
    code = (
        "import sys, vq_tpu_torch.parallel, vq_tpu_torch.parallel.dryrun\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vq_tpu') "
        "or m.startswith(('jax.', 'vq_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)
