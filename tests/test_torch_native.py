"""``vq_tpu_torch.native`` (the port's copy of the C++ oracle ``hsd.cpp``)
against ``vq_tpu.native`` on the same inputs, bit for bit: both compile
the same source with the same flags. Also ``NativeLibraryError``'s
bases, a failed build, builds racing in several processes, and
``get_backend`` without a card.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from vq_tpu import native as jn
from vq_tpu_torch import native as tn
from vq_tpu_torch.errors import NativeLibraryError, VqError
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return {
        "a": rng.standard_normal(100).astype(np.float32),
        "b": rng.standard_normal(100).astype(np.float32),
        "x": rng.standard_normal((3000, 32)).astype(np.float32),
        "c": rng.standard_normal((40, 32)).astype(np.float32),
        "cb": rng.standard_normal((4, 256, 8)).astype(np.float32),
    }


def test_source_is_the_reference_copy():
    assert (REPO / "vq_tpu_torch/native/hsd.cpp").read_bytes() == (
        REPO / "vq_tpu/native/hsd.cpp").read_bytes()


def test_builds_and_names_its_backend():
    assert tn.available() and jn.available()
    assert tn.get_native_backend() == jn.get_native_backend()
    assert "native" in tn.get_native_backend()
    assert Path(tn._get()._name).parent == tn.BUILD_DIR
    assert str(tn.BUILD_DIR).startswith(str(REPO / "build"))


@pytest.mark.parametrize("fn", ["sqeuclidean", "manhattan", "dot", "cosine_similarity"])
def test_pair_kernels_bit_for_bit(data, fn):
    got = getattr(tn, fn)(data["a"], data["b"])
    want = getattr(jn, fn)(data["a"], data["b"])
    assert isinstance(got, float) and np.float32(got).tobytes() == np.float32(want).tobytes()
    # A tensor is taken as its values.
    assert getattr(tn, fn)(torch.from_numpy(data["a"]), torch.from_numpy(data["b"])) == got


def test_cosine_of_a_zero_vector_is_zero(data):
    z = np.zeros(100, np.float32)
    assert tn.cosine_similarity(z, data["b"]) == jn.cosine_similarity(z, data["b"]) == 0.0


def test_sqeuclidean_batch_bit_for_bit(data):
    got = tn.sqeuclidean_batch(data["x"], data["c"])
    assert got.dtype == np.float32 and got.shape == (3000, 40)
    np.testing.assert_array_equal(got, jn.sqeuclidean_batch(data["x"], data["c"]))


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_pq_encode_bit_for_bit(data, threads):
    got = tn.pq_encode(data["x"], data["cb"], num_threads=threads)
    assert got.dtype == np.uint8 and got.shape == (3000, 4)
    np.testing.assert_array_equal(got, jn.pq_encode(data["x"], data["cb"], num_threads=threads))


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_assign_bit_for_bit(data, threads):
    got = tn.assign(data["x"], data["c"], num_threads=threads)
    assert got.dtype == np.int32 and got.shape == (3000,)
    np.testing.assert_array_equal(got, jn.assign(data["x"], data["c"], num_threads=threads))


def test_pq_encode_matches_the_port_cpu_route(data):
    """The oracle's codes are the port's PQ encode on the CPU (ties
    aside: none on Gaussian rows)."""
    with vq_tpu_torch.default_device("cpu"):
        want = vq_tpu_torch.pq_encode(data["x"], data["cb"], "squared_euclidean")
    np.testing.assert_array_equal(tn.pq_encode(data["x"], data["cb"]), want.numpy())


def test_bad_shapes_raise(data):
    with pytest.raises(ValueError):
        tn.sqeuclidean(data["a"], data["b"][:50])
    with pytest.raises(ValueError):
        tn.pq_encode(data["x"][:, :30], data["cb"])


def test_native_library_error_bases():
    import vq_tpu.errors as je

    assert issubclass(NativeLibraryError, VqError) and issubclass(NativeLibraryError, RuntimeError)
    assert vq_tpu_torch.NativeLibraryError is NativeLibraryError
    assert [c.__name__ for c in NativeLibraryError.__mro__] == [
        c.__name__ for c in je.NativeLibraryError.__mro__]
    assert str(NativeLibraryError("x")) == str(je.NativeLibraryError("x"))


def test_failed_build_raises_native_library_error(tmp_path, monkeypatch):
    """A source g++ refuses: ``available()`` is False and every call
    raises ``NativeLibraryError``, as in the reference."""
    bad = tmp_path / "hsd.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "_SRC", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_load_error", None)
    assert not tn.available()
    with pytest.raises(NativeLibraryError, match="g\\+\\+ failed"):
        tn.get_native_backend()
    assert not list((tmp_path / "build").glob("*.so"))


def test_racing_builds_all_load(tmp_path):
    """Four processes build one fresh library at once: each compiles to a
    name of its own and moves it into place, so every one of them loads."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import vq_tpu_torch.native as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "print(n.get_native_backend())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o[0] for o in outs}) == 1
    assert len(list((tmp_path / "b").glob("*.so"))) == 1
    assert not list((tmp_path / "b").glob("*.tmp"))


def test_get_backend_without_a_card():
    assert not torch.cuda.is_available()
    assert vq_tpu_torch.get_backend() == "CPU" == vq_tpu_torch.get_simd_backend()
    assert vq_tpu.get_backend() == "CPU"  # the JAX package on its CPU backend: the same string
    for name in ("get_backend", "get_simd_backend", "NativeLibraryError"):
        assert name in vq_tpu_torch.__all__
