"""The harness end to end on the CPU at the cells' tiny sizes: the last
line has the contract's shape, no JAX module is loaded, and each fault a
cell can have, planted under the timed path, turns ``correct`` false.
The control's failing needs the card (TF32 products)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
A, B, C = "sift1m-ivfpq.np64-b128", "sift1m-ivfpq.np8-b10k", "sift1m-ivfpq.build-1m"


def run(cell, *extra, seed=3_000_000_019, seconds=1, device="cpu", trace=0, root=ROOT):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace), "--device", device, "--tiny",
           *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    p = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("cell,trace", [(A, 0), (A, 1), (B, 0), (B, 1), (C, 0), (C, 1)])
def test_last_line_has_the_contracts_shape(cell, trace):
    out, err = run(cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    else:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    last = err.strip().splitlines()[-len(out["checks"]):]
    assert [ln.split(":")[0] for ln in last] == [f"check {n}" for n in out["checks"]]
    assert "jax" not in err.lower() or "loaded" not in err


@pytest.mark.parametrize("cell,fault", [
    (A, "answer_altered"), (A, "state_unchanged"), (A, "code_altered"),
    (B, "answer_altered"), (C, "code_altered"), (C, "state_unchanged")])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    out, _ = run(cell, "--fault", fault)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", [A, C])
def test_another_data_seed_builds_another_index_and_stays_correct(cell):
    """``--data-seed`` draws the data and the starts anew (the runs that
    read a limit's lower end on other indexes)."""
    base, _ = run(cell)
    other, _ = run(cell, "--data-seed", "77")
    assert other["correct"] is True
    assert other["checks"]["recon_gap"] != base["checks"]["recon_gap"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", A, "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and not p.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the harness fails."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", A, "--seed", "1",
                        "--seconds", "1", "--device", "cpu", "--tiny"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [A, B, C])
def test_the_control_is_not_correct(cell):
    """The reference at TF32 in the program's place reads ``correct:
    false`` through the harness's own comparison (on the card, at the
    tiny sizes)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 products run only on the card")
    out, err = run(cell, "--control", "1", device="cuda")
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
