"""The benchmark twins' kernels B1 (``vq_tpu_torch.benchmarks.mpacked_encode``)
and B2-B4 (``vq_tpu_torch.benchmarks.adc_vmem_bench``) against the TPU
kernels of ``benchmarks/mpacked_encode.py`` and
``benchmarks/adc_vmem_bench.py``.

The JAX functions are loaded from the script files (nothing under
``benchmarks/`` is a package) and run in Pallas interpret mode on the CPU;
the port's wrappers run their plain versions on CPU tensors, the
arithmetic the CUDA kernels are held to on the card
(``test_torch_cuda.py``). Both get the same seeded numpy inputs.

Tolerances: B2, B3 and B4 bit for bit. B1 codes equal except at near
ties: the two candidates' scores, recomputed in float64 on the operands
the precision rounds, within 1e-5 of max(|score|, 1) (JAX's CPU dot sums
in another order than the ascending one of the port). B3 is held to JAX
on in-range codes only: for a code >= k the interpret path gives NaN
(numpy's fill mode), the port 0.0 (K8's rule).
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu_torch.benchmarks import adc_vmem_bench as tav
from vq_tpu_torch.benchmarks import mpacked_encode as tmp
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck

_SCRIPTS = Path(__file__).resolve().parent.parent / "benchmarks"


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}", _SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmp():
    return _load("mpacked_encode")


@pytest.fixture(scope="module")
def jav():
    return _load("adc_vmem_bench")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def enc(jmp):
    """n = 300 rows (ragged against the 128-row block), d = 32, m = 4,
    k = 256, with the script's ``build_w`` operands."""
    rng = np.random.default_rng(60)
    x = rng.random((300, 32), dtype=np.float32)
    cb = rng.random((4, 256, 8), dtype=np.float32)
    w, cc = jmp.build_w(cb)
    return x, cb, w, cc


def _assert_codes(got, want, x, w, cc, precision):
    flips, gap, ties = tmp.near_ties(_t(x), _t(w), _t(cc), _t(got), _t(want), precision)
    assert ties, (flips, gap)


def test_build_w_matches_script(jmp, enc):
    _, cb, w, cc = enc
    tw, tcc = tmp.build_w(_t(cb))
    np.testing.assert_array_equal(tw.numpy(), w)
    np.testing.assert_allclose(tcc.numpy(), cc, rtol=1e-6)  # fp32 summation order of ||c||^2


@pytest.mark.parametrize("operand", ["build_w", "dense"])
def test_mpacked_highest_matches_jax(jmp, enc, operand):
    """Any W, not only build_w's block-diagonal one: a dense Gaussian W
    shows the twin assumes nothing about its structure."""
    x, _, w, cc = enc
    if operand == "dense":
        w = np.random.default_rng(61).standard_normal(w.shape).astype(np.float32)
    want = np.asarray(jmp.mpacked_encode(x, w, cc, 128, "highest", interpret=True))
    got = tmp.mpacked_encode(_t(x), _t(w), _t(cc), "highest")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    _assert_codes(got.numpy(), want, x, w, cc, "highest")


def test_mpacked_highest_equals_k4_plain(enc):
    """On build_w operands B1's scores are K4's exactly: x*(-2c) is
    -2*(x*c), the zero blocks add nothing, and (-2 dot) + cc is cc - 2 dot
    (both ||c||^2 from the port's build_w, as K4 takes it)."""
    x, cb, _, _ = enc
    w, cc = tmp.build_w(_t(cb))
    got = tmp.mpacked_encode(_t(x), w, cc, "highest")
    assert torch.equal(got, ck.pq_encode_plain(_t(x), _t(cb), "highest"))


@pytest.mark.parametrize("dtype", ["bf16_valued_f32", "bf16"])
def test_mpacked_default_matches_jax(jmp, enc, dtype):
    """On the CPU JAX's DEFAULT dot of f32 is f32, so both packages get
    bf16-valued operands: f32 arrays already rounded to bf16, or true bf16
    arrays (the bf16-resident variant)."""
    x, _, w, cc = enc
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    if dtype == "bf16":
        want = np.asarray(jmp.mpacked_encode(xb, wb, cc, 128, "default", interpret=True))
        tx, tw = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    else:
        xv, wv = np.asarray(xb.astype(jnp.float32)), np.asarray(wb.astype(jnp.float32))
        want = np.asarray(jmp.mpacked_encode(xv, wv, cc, 128, "default", interpret=True))
        tx, tw = _t(xv), _t(wv)
    got = tmp.mpacked_encode(tx, tw, _t(cc), "default")
    _assert_codes(got.numpy(), want, tx.float().numpy(), tw.float().numpy(), cc, "default")


def _adc_inputs(k, q=5, m=4, n=1000):
    """Q = 5 (not a multiple of 8), n = 1000 (not a multiple of the
    256-row block), codes in [0, k)."""
    rng = np.random.default_rng(62 + k)
    tables = rng.random((q, m, k), dtype=np.float32)
    codes_t = rng.integers(0, k, (m, n)).astype(np.uint8)
    return tables, codes_t


_VARIANTS = {"kt": ({}, "adc_kt"), "gather": ({}, "adc_gather"),
             "gather1": ({"only": 1}, "adc_gather"), "floor": ({}, "adc_floor")}


@pytest.mark.parametrize("k", [256, 128], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_adc_variant_matches_jax(jav, variant, k):
    """k = 128 takes B3's single-gather branch on the TPU side."""
    kw, name = _VARIANTS[variant]
    tables, codes_t = _adc_inputs(k)
    want = np.asarray(getattr(jav, name)(tables, codes_t, 256, interpret=True, **kw))
    got = getattr(tav, name)(_t(tables), _t(codes_t), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [256, 128], ids=lambda k: f"k{k}")
def test_kt_and_gather_equal_k8_plain(k):
    tables, codes_t = _adc_inputs(k)
    want = ck.adc_lookup_plain(_t(tables), _t(codes_t).T)
    assert torch.equal(tav.adc_kt(_t(tables), _t(codes_t)), want)
    assert torch.equal(tav.adc_gather(_t(tables), _t(codes_t)), want)


def test_kt_code_out_of_range_adds_zero(jav):
    """B2's contract, the TPU's too: a code >= k matches no one-hot row."""
    tables, codes_t = _adc_inputs(100)
    codes_t[1, ::7] = 200
    want = np.asarray(jav.adc_kt(tables, codes_t, 256, interpret=True))
    got = tav.adc_kt(_t(tables), _t(codes_t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ck.adc_lookup_plain(_t(tables), _t(codes_t).T))


def test_gather_code_out_of_range_adds_zero():
    """A code >= k adds 0.0 in B3, K8's rule. Held to the port's own
    plain versions only: the JAX function in interpret mode gives NaN
    there and TPU hardware is undefined."""
    tables, codes_t = _adc_inputs(100)
    codes_t[2, ::5] = 255
    k = tables.shape[2]
    want = np.zeros((tables.shape[0], codes_t.shape[1]), np.float32)
    for i, c in enumerate(codes_t.astype(np.int64)):  # f32 adds in subspace order
        want = want + np.where(c < k, tables[:, i, np.minimum(c, k - 1)], np.float32(0))
    got = tav.adc_gather(_t(tables), _t(codes_t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ck.adc_lookup_plain(_t(tables), _t(codes_t).T))


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("twin", ["mpacked_encode", "adc_vmem_bench"])
def test_twin_main_prints_parity(capsys, twin):
    mod = {"mpacked_encode": tmp, "adc_vmem_bench": tav}[twin]
    assert mod.main(["--device", "cpu", "--n", "2000"] + (["--q", "5"] if twin == "adc_vmem_bench" else [])) == 0
    lines = _json_lines(capsys.readouterr().out)
    if twin == "mpacked_encode":
        ops = [line["op"] for line in lines]
        assert ops == ["mpacked_parity_highest", "mpacked_parity_default", "encode_shipped_fused",
                       "encode_mpacked_highest", "encode_mpacked_default", "encode_mpacked_bf16resident"]
        assert lines[0]["code_match"] == 1.0 and lines[0]["n"] == 2000
    else:
        assert [line["variant"] for line in lines] == ["xla", "old", "kt", "gather", "floor", "gather1"]
    assert all(line["parity"] for line in lines if "parity" in line)
    assert sum("parity" in line for line in lines) >= 3
    assert all(line["ms"] is None and line["device"] == "cpu" for line in lines if "ms" in line)


def test_twin_only_keeps_xla(capsys):
    tav.main(["--device", "cpu", "--n", "64", "--q", "3", "--only", "floor"])
    assert [line["variant"] for line in _json_lines(capsys.readouterr().out)] == ["xla", "floor"]


_BAD = {
    "precision": lambda: tmp.mpacked_encode(torch.zeros(4, 8), torch.zeros(8, 256), torch.zeros(256), "high"),
    "w_columns": lambda: tmp.mpacked_encode(torch.zeros(4, 8), torch.zeros(8, 200), torch.zeros(200)),
    "codes_dtype": lambda: tav.adc_gather(torch.zeros(2, 3, 4), torch.zeros(3, 9, dtype=torch.int32)),
    "only": lambda: tav.adc_gather(torch.zeros(2, 3, 4), torch.zeros(3, 9, dtype=torch.uint8), only=4),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_inputs_raise(case):
    with pytest.raises(InvalidParameter):
        _BAD[case]()


def test_cpu_tensors_never_launch(enc):
    x, cb, w, cc = enc
    fns = (tmp.mpacked_encode, tav.adc_kt, tav.adc_gather, tav.adc_floor)
    before = [f.launches for f in fns]
    tmp.mpacked_encode(_t(x), _t(w), _t(cc), "default")
    tables, codes_t = _adc_inputs(16)
    for f in fns[1:]:
        f(_t(tables), _t(codes_t))
    assert [f.launches for f in fns] == before
