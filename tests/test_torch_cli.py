"""``vq_tpu_torch.cli`` (the eval harnesses), ``vq_tpu_torch.utils.datasets``
and ``vq_tpu_torch.utils.metrics`` against the JAX package, and the order
of ``models.pq._smallest``, through which the harnesses' recall ranks.

Each harness runs in both packages on one tiny ``.fvecs`` file (500 x 16,
``--cold --recall``): the rows carry the same fields. Tolerances: BQ, SQ
and TSVQ ``mse`` within rtol 1e-5 (each package sums the squared errors
in f32 in its own order); PQ's within 10%: its seeded training cannot
replay JAX's threefry draws, so the two packages train different
codebooks from the same data (both near 1e-6 here). ``recall_at_k``
within 1e-6 for BQ, SQ and TSVQ (the JAX package ranks by ``lax.top_k``,
the port by its stable sort; they agree except on a negative NaN or a
-0.0 tie, R8, which this data has not) and within 0.01 for PQ.
"""

import contextlib
import importlib
import io
import json
import struct

import numpy as np
import pytest
import torch

import vq_tpu.errors as jerr
import vq_tpu_torch.errors as terr
from vq_tpu.cli import common as jcommon
from vq_tpu.utils import datasets as jdatasets
from vq_tpu_torch.cli import common as tcommon
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.models.pq import _smallest
from vq_tpu_torch.utils import datasets as tdatasets
from vq_tpu_torch.utils.metrics import MetricsLogger, trace
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

NEG_NAN = struct.unpack("<f", struct.pack("<I", 0xFFC00000))[0]


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def tiny_fvecs(tmp_path_factory):
    rows = np.random.default_rng(3).random((500, 16), dtype=np.float32)
    path = tmp_path_factory.mktemp("data") / "tiny.fvecs"
    np.hstack([np.full((500, 1), 16, np.int32).view(np.float32), rows]).tofile(path)
    return str(path)


def _rows(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name", ["bq", "sq", "pq", "tsvq"])
def test_harness_rows_match_jax(name, tiny_fvecs):
    argv = ["--cold", "--data", tiny_fvecs, "--sizes", "500", "--dim", "16", "--recall"]
    (want,) = _rows(importlib.import_module(f"vq_tpu.cli.eval_{name}"), argv)
    (got,) = _rows(importlib.import_module(f"vq_tpu_torch.cli.eval_{name}"), argv)
    assert set(got) == set(want)
    timing = {"train_ms", "encode_ms", "pack_ms", "mse", "recall_at_k", "git"}
    assert {k: got[k] for k in got if k not in timing} == {
        k: want[k] for k in want if k not in timing}
    assert got["data"] == "tiny.fvecs" and got["num_samples"] == 500
    if name == "pq":
        assert got["mse"] == pytest.approx(want["mse"], rel=0.1)
        assert got["recall_at_k"] == pytest.approx(want["recall_at_k"], abs=0.01)
    else:
        assert got["mse"] == pytest.approx(want["mse"], rel=1e-5)
        assert got["recall_at_k"] == pytest.approx(want["recall_at_k"], abs=1e-6)


def test_output_file_and_append(tmp_path, tiny_fvecs):
    from vq_tpu_torch.cli import eval_sq

    out = tmp_path / "rows.jsonl"
    argv = ["--cold", "--data", tiny_fvecs, "--sizes", "100", "300", "--levels", "16"]
    rows = eval_sq.main(argv + ["--output", str(out)])
    eval_sq.main(argv + ["--output-append", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["num_samples"] for r in lines] == [100, 300, 100, 300]
    assert [r.num_samples for r in rows] == [100, 300] and lines[0]["levels"] == 16


@pytest.mark.parametrize("corpus", ["synthetic", "clustered"])
def test_generated_corpora(corpus):
    from vq_tpu_torch.cli import eval_bq

    (row,) = eval_bq.main(["--cold", "--corpus", corpus, "--sizes", "300", "--dim", "8"])
    assert row.extra["data"] == corpus and np.isfinite(row.mse)
    np.testing.assert_array_equal(tcommon.generate_synthetic_data(50, 8, 66, device=False),
                                  jcommon.generate_synthetic_data(50, 8, 66, device=False))
    a = tcommon.generate_clustered_data(300, 8, 5, modes=4)
    assert a.shape == (300, 8) and torch.equal(a, tcommon.generate_clustered_data(300, 8, 5, modes=4))


def test_windowed_recall_forms_agree():
    rng = np.random.default_rng(9)
    data = rng.random((700, 6), dtype=np.float32)
    recon = data + rng.normal(0, 0.05, data.shape).astype(np.float32)
    host = tcommon.windowed_recall_at_k(data, recon, max_queries=80, window=300, seed=4)
    assert host == jcommon.windowed_recall_at_k(data, recon, max_queries=80, window=300, seed=4)
    dev = tcommon.windowed_recall_at_k(torch.from_numpy(data), torch.from_numpy(recon),
                                       max_queries=80, window=300, seed=4)
    assert dev == pytest.approx(host, abs=1e-12)
    assert tcommon.reconstruction_mse(torch.from_numpy(data), recon) == pytest.approx(
        tcommon.reconstruction_mse(data, recon), rel=1e-5)


def _stable_order(row):
    """The order ``_smallest`` promises: ascending, every NaN last whatever
    its sign, -0.0 equal to +0.0, exact ties by position."""
    return sorted(range(len(row)), key=lambda i: (np.isnan(row[i]), 0.0 if np.isnan(row[i])
                                                  else float(row[i]), i))


SMALLEST_ROWS = {
    "signed-zeros": [0.0, -0.0, 1.0, -0.0, 0.0, -1.0],
    "nans": [1.0, float("nan"), NEG_NAN, 2.0, 0.5, float("nan"), -np.inf, np.inf],
    "ties": [3.0, 1.0, 3.0, 1.0, 1.0, 3.0, 2.0, 1.0],
}


@pytest.mark.parametrize("case", sorted(SMALLEST_ROWS))
def test_smallest_order(case):
    row = np.asarray(SMALLEST_ROWS[case], np.float32)
    vals, pos = _smallest(torch.from_numpy(row)[None], len(row))
    assert pos[0].tolist() == _stable_order(row)
    assert torch.equal(vals[0].nan_to_num(9.0), torch.from_numpy(row)[pos[0]].nan_to_num(9.0))


def test_smallest_order_random_heavy_ties():
    rng = np.random.default_rng(11)
    pool = np.array([0.0, -0.0, 1.0, -1.0, np.nan, NEG_NAN, np.inf, -np.inf, 0.5], np.float32)
    d = pool[rng.integers(0, pool.size, (40, 64))]
    _, pos = _smallest(torch.from_numpy(d), 10)
    assert pos.tolist() == [_stable_order(r)[:10] for r in d]


@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32), (".bvecs", np.uint8),
                                       (".ivecs", np.int32)])
def test_datasets_match_jax(tmp_path, ext, dtype):
    rng = np.random.default_rng(2)
    vals = (rng.random((30, 7)) * 200).astype(dtype)
    path = str(tmp_path / f"x{ext}")
    with open(path, "wb") as f:
        for row in vals:
            f.write(np.int32(7).tobytes() + row.tobytes())
    for max_rows in (None, 11):
        np.testing.assert_array_equal(tdatasets.load_dataset(path, max_rows),
                                      jdatasets.load_dataset(path, max_rows))
    with open(path, "ab") as f:
        f.write(b"\x00")
    with pytest.raises(jerr.InvalidData) as want:
        jdatasets.load_dataset(path)
    with pytest.raises(terr.InvalidData) as got:
        tdatasets.load_dataset(path)
    assert str(got.value) == str(want.value)


def test_metrics_logger_and_trace(tmp_path):
    path = tmp_path / "events.jsonl"
    with MetricsLogger(str(path)) as log, trace("encode"):
        log.log("step", inertia=1.5)
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert rec["event"] == "step" and rec["inertia"] == 1.5 and rec["t_wall"] >= 0
