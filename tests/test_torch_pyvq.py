"""``vq_tpu_torch.pyvq`` — the pyvq compatibility classes over the port —
against the ``pyvq`` shim, case by case as ``tests/test_pyvq_compat.py``
exercises it: the same dtype contracts, one-vector calls, defaults,
reprs and ``ValueError``s, each output equal to pyvq's on the same
inputs. Seeded PQ training draws from another generator in each package
(torch's, not threefry), so a trained quantizer's outputs are compared
with the JAX-trained codebooks swapped in, and its own training is held
to the reference example's error bound.
"""

import ast
import inspect
import pathlib

import numpy as np
import pytest

import pyvq
import vq_tpu_torch
from vq_tpu_torch import pyvq as tw
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with default_device("cpu"):
        yield


def _same(got, want):
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _with_codebooks_of(twin_pq, ref_pq):
    """The twin's quantizer with the reference's trained codebooks."""
    twin_pq._q = vq_tpu_torch.ProductQuantizer(codebooks=np.asarray(ref_pq._q.codebooks))
    return twin_pq


def test_module_surface():
    for name in pyvq.__all__:
        assert hasattr(tw, name)
    assert tw.__all__ == pyvq.__all__
    assert tw.get_simd_backend() == pyvq.get_simd_backend() == "CPU"


def test_bq_contract():
    x = np.array([0.1, 0.9, 0.5], dtype=np.float32)
    q, r = tw.BinaryQuantizer(0.5), pyvq.BinaryQuantizer(0.5)
    codes = q.quantize(x)
    _same(codes, r.quantize(x))
    np.testing.assert_array_equal(codes, [0, 1, 1])
    _same(q.dequantize(codes), r.dequantize(codes))
    assert (q.threshold, q.low, q.high) == (r.threshold, r.low, r.high) == (0.5, 0, 1)
    assert repr(q) == repr(r)
    with pytest.raises(ValueError):
        tw.BinaryQuantizer(0.5, low=5, high=5)


def test_sq_contract():
    q, r = tw.ScalarQuantizer(0.0, 1.0), pyvq.ScalarQuantizer(0.0, 1.0)
    assert q.levels == r.levels == 256
    assert q.step == pytest.approx(1.0 / 255) and q.step == r.step
    x = np.array([0.0, 0.5, 1.0], dtype=np.float32)
    codes = q.quantize(x)
    _same(codes, r.quantize(x))
    np.testing.assert_array_equal(codes, [0, 127, 255])
    _same(q.dequantize(codes), r.dequantize(codes))
    assert repr(q) == repr(r)
    with pytest.raises(ValueError):
        tw.ScalarQuantizer(1.0, 0.0)


def test_pq_contract(rng):
    data = rng.random((200, 16), dtype=np.float32)
    r = pyvq.ProductQuantizer(data, 4, 8)
    q = tw.ProductQuantizer(data, 4, 8)  # defaults: iters=10, seed=42
    assert (q.num_subspaces, q.sub_dim, q.dim) == (r.num_subspaces, r.sub_dim, r.dim) == (4, 4, 16)
    assert repr(q) == repr(r)
    _with_codebooks_of(q, r)
    v = data[0]
    f16 = q.quantize(v)
    _same(f16, r.quantize(v))
    assert f16.shape == (16,)
    _same(q.dequantize(f16), r.dequantize(f16))
    with pytest.raises(ValueError):
        tw.ProductQuantizer(data, 5, 8)  # 16 % 5 != 0
    with pytest.raises(ValueError):
        q.quantize(np.zeros(12, dtype=np.float32))


def test_tsvq_contract(rng):
    data = rng.random((100, 8), dtype=np.float32)
    q, r = tw.TSVQ(data, max_depth=3), pyvq.TSVQ(data, max_depth=3)
    assert q.dim == r.dim == 8
    assert repr(q) == repr(r)
    f16 = q.quantize(data[0])
    _same(f16, r.quantize(data[0]))  # the host build is the JAX package's tree, bit for bit
    _same(q.dequantize(f16), r.dequantize(f16))


def test_distance_contract():
    a = np.array([1.0, 2.0], dtype=np.float32)
    b = np.array([3.0, 4.0], dtype=np.float32)
    d = tw.Distance.euclidean()
    assert d.compute(a, b) == pytest.approx(2.8284271)
    assert d.compute(a, b) == pyvq.Distance.euclidean().compute(a, b)
    for name in ("squared_euclidean", "manhattan", "cosine"):
        assert tw.Distance(name).compute(a, b) == pyvq.Distance(name).compute(a, b)
    assert tw.Distance("manhattan").compute(a, b) == pytest.approx(4.0)
    with pytest.raises(ValueError):
        tw.Distance("nonsense")
    with pytest.raises(ValueError):
        d.compute(a, np.zeros(3, dtype=np.float32))


def test_reference_doc_example(rng):
    training = rng.random((1000, 128)).astype(np.float32)
    pq = tw.ProductQuantizer(training, num_subspaces=8, num_centroids=256)
    vec = training[0]
    restored = pq.dequantize(pq.quantize(vec))
    assert float(np.sqrt(np.mean((vec - restored) ** 2))) < 0.3
    ref = pyvq.ProductQuantizer(training, num_subspaces=8, num_centroids=256)
    _with_codebooks_of(pq, ref)
    _same(pq.dequantize(pq.quantize(vec)), ref.dequantize(ref.quantize(vec)))


def test_empty_vectors_pass_through():
    empty = np.array([], dtype=np.float32)
    for cls, args in ((tw.BinaryQuantizer, (0.0,)), (tw.ScalarQuantizer, (0.0, 1.0))):
        got = cls(*args).quantize(empty)
        assert len(got) == 0
        _same(got, getattr(pyvq, cls.__name__)(*args).quantize(empty))


def test_empty_training_rejected():
    empty = np.zeros((0, 4), dtype=np.float32)
    with pytest.raises(ValueError):
        tw.ProductQuantizer(empty, 2, 4)
    with pytest.raises(ValueError):
        tw.TSVQ(empty, max_depth=3)


def test_extreme_values():
    x = np.array([1e10, -1e10, 1e-10, -1e-10], np.float32)
    out = tw.BinaryQuantizer(0.0).quantize(x)
    assert set(np.unique(out)).issubset({0, 1})
    _same(out, pyvq.BinaryQuantizer(0.0).quantize(x))
    y = np.array([1e10, -1e10, 1.5, -1.5], np.float32)
    out = tw.ScalarQuantizer(-1.0, 1.0).quantize(y)
    np.testing.assert_array_equal(out, [255, 0, 255, 0])
    _same(out, pyvq.ScalarQuantizer(-1.0, 1.0).quantize(y))


def test_float64_input_accepted():
    x = np.array([0.5, -0.3, 0.8], dtype=np.float64)
    out = tw.BinaryQuantizer(0.0).quantize(x)
    np.testing.assert_array_equal(out, [1, 0, 1])
    _same(out, pyvq.BinaryQuantizer(0.0).quantize(x))


def test_stub_matches_runtime_surface():
    """pyvq's stub (``pyvq/__init__.pyi``) describes the twin too: every
    stubbed class, function, method and property exists, plain methods
    take the stub's parameters, and every public name is stubbed."""
    tree = ast.parse(pathlib.Path(pyvq.__file__).with_suffix(".pyi").read_text())
    stub_names = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            stub_names.add(node.name)
            cls = getattr(tw, node.name, None)
            assert cls is not None, f"stubbed class {node.name} missing"
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and not item.name.startswith("__"):
                    assert hasattr(cls, item.name), f"{node.name}.{item.name} missing"
                    decorators = {d.id for d in item.decorator_list if isinstance(d, ast.Name)}
                    runtime = inspect.getattr_static(cls, item.name)
                    if not decorators and inspect.isfunction(runtime):
                        assert [a.arg for a in item.args.args] == list(
                            inspect.signature(runtime).parameters), f"{node.name}.{item.name}"
        elif isinstance(node, ast.FunctionDef):
            stub_names.add(node.name)
            assert hasattr(tw, node.name)
    for name in tw.__all__:
        assert name in stub_names, f"public name {name!r} not in stub"


def test_tensor_input_accepted():
    import torch

    x = torch.tensor([0.1, 0.9, 0.5])
    _same(tw.BinaryQuantizer(0.5).quantize(x), pyvq.BinaryQuantizer(0.5).quantize(x.numpy()))
