"""``vq_tpu_torch.parallel``'s input pipeline and process group against
``vq_tpu.parallel.data`` and ``vq_tpu.parallel.mesh``, mirroring
``tests/test_sharded_data.py``: the synthetic corpus bit for bit at world
1 (this process), 2 (a 2-rank gloo world of its own processes, meshes
``(2, 1)`` and ``(1, 2)``) and 4 (``tests/test_torch_parallel.py``);
the callback loader, encode and quantize; ``init_distributed``'s benign
and failing cases; and ``make_mesh``'s refusal to run on a card that is
not there.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import vq_tpu.parallel as jpar
import vq_tpu_torch.parallel as tpar
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.parallel import dryrun
from test_torch_parallel import INPUTS, REPO, run_dryrun
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

TAGS2 = {"2x1": 1, "1x2": 2}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return run_dryrun(2, tmp_path_factory.mktemp("parallel2") / "run2.npz")


@pytest.fixture(scope="module")
def mesh1():
    import torch.distributed as dist

    mesh = tpar.make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


def _jax_corpus(n_devices: int):
    return np.asarray(jpar.sharded_synthetic_corpus(
        dryrun.CORPUS_ROWS, dryrun.CORPUS_DIM, seed=3, mesh=jpar.make_mesh(n_devices=n_devices),
        chunk_rows=dryrun.CORPUS_CHUNK))


def test_two_rank_world(run2):
    assert int(run2["world"]) == 2 and len(set(run2["pids"].tolist())) == 2
    assert int(run2["checked"]) >= 60
    assert dryrun.compare_runs(run2, run2) > 60


@pytest.mark.parametrize("tag", TAGS2)
def test_synthetic_corpus_world_two(run2, tag):
    np.testing.assert_array_equal(run2[f"corpus/seed3/{tag}/rows"], _jax_corpus(2))


def test_synthetic_corpus_world_one(mesh1):
    got = tpar.sharded_synthetic_corpus(dryrun.CORPUS_ROWS, dryrun.CORPUS_DIM, seed=3, mesh=mesh1,
                                        chunk_rows=dryrun.CORPUS_CHUNK)
    np.testing.assert_array_equal(got.to_local().numpy(), _jax_corpus(1))
    np.testing.assert_array_equal(got.to_local().numpy(), _jax_corpus(4))  # layout-independent


@pytest.mark.parametrize("tag", TAGS2)
def test_encode_and_quantize_world_two(run2, tag):
    from vq_tpu.models.sq import ScalarQuantizer

    mesh = jpar.make_mesh(n_devices=2, subspace_parallel=TAGS2[tag])
    j = jpar.sharded_pq_encode(INPUTS["data"], INPUTS["init"], mesh=mesh)
    np.testing.assert_array_equal(run2[f"pq_encode/init/{tag}/codes"], np.asarray(j))
    jq = jpar.sharded_quantize(ScalarQuantizer(0.0, 1.0), INPUTS["data"], mesh=mesh)
    np.testing.assert_array_equal(run2[f"quantize/sq8/{tag}/codes"], np.asarray(jq))


def test_callback_loads_only_local_rows(mesh1):
    calls = []

    def load(a, b):
        calls.append((a, b))
        return np.arange(a * 3, b * 3, dtype=np.float32).reshape(b - a, 3)

    arr = tpar.sharded_from_callback(12, 3, load, mesh=mesh1)
    assert calls == [(0, 12)]  # one block, the rank's own
    np.testing.assert_array_equal(tpar.gather_global(arr).numpy(),
                                  np.arange(36, dtype=np.float32).reshape(12, 3))


def test_callback_bad_shape_rejected(mesh1):
    with pytest.raises(InvalidParameter) as e:
        tpar.sharded_from_callback(8, 3, lambda a, b: np.zeros((b - a, 2), np.float32), mesh=mesh1)
    assert e.value.parameter == "load_rows"


def test_train_from_sharded_corpus(mesh1):
    """A row-sharded DTensor trains as the array it holds does."""
    corpus = tpar.sharded_synthetic_corpus(256, 16, seed=1, mesh=mesh1)
    a = tpar.sharded_pq_train(corpus, 4, 8, 2, seed=0, mesh=mesh1)
    b = tpar.sharded_pq_train(corpus.to_local().numpy(), 4, 8, 2, seed=0, mesh=mesh1)
    assert torch.equal(a.centroids.to_local(), b.centroids.to_local())


def test_make_mesh_without_a_card_raises():
    """No card and no request for the CPU: the mesh raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with default_device(None):
        with pytest.raises(InvalidParameter):
            tpar.make_mesh()


def test_init_distributed_benign_and_failing_cases():
    """In a fresh process: a bad rank / world pair raises before any
    connection; an explicit address that nothing serves raises within a
    short timeout; a call with nothing set up is a world of one, and a
    second call is a no-op."""
    code = (
        "import time, torch.distributed as dist\n"
        "from vq_tpu_torch.errors import InvalidParameter\n"
        "from vq_tpu_torch.parallel import init_distributed\n"
        "from vq_tpu_torch.parallel.dryrun import _free_port\n"
        "try:\n"
        "    init_distributed('tcp://127.0.0.1:1', world_size=2, rank=2, device_type='cpu')\n"
        "    raise SystemExit('a bad rank passed')\n"
        "except InvalidParameter:\n"
        "    pass\n"
        "t = time.time()\n"
        "try:\n"
        "    init_distributed(f'tcp://127.0.0.1:{_free_port()}', world_size=2, rank=1,\n"
        "                     device_type='cpu', timeout=1)\n"
        "    raise SystemExit('an unreachable address passed')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "assert time.time() - t < 30, time.time() - t\n"
        "assert not dist.is_initialized()\n"
        "assert init_distributed(device_type='cpu') == 0 and dist.get_world_size() == 1\n"
        "assert init_distributed(device_type='cpu') == 0\n"
        "dist.destroy_process_group()\n"
    )
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("MASTER_ADDR", "TORCHELASTIC_RUN_ID")}
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO, env=env)
