"""The benchmark's files parse, and each is found by its name."""

import json

import pytest

from portbench import spec


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_names_are_unique(bench):
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names))


def test_benchmark_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def test_every_config_file_parses(bench):
    for c in bench["configs"]:
        cfg = spec.load_json("configs", c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_every_cell_is_found(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        wl, cfg = spec.load_cell(w["name"])
        assert wl["config"] == w["config"] and w["config"] in configs
        assert wl["chips"] == w["chips"] and cfg["name"] == w["config"]
        assert callable(spec.load_driver(wl["driver"]).run)


def test_every_per_layer_metric_has_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(spec.load_metric(m["name"]).read)
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {x["name"] for x in spec.cell_metrics(bench, cell, "end_to_end")}


@pytest.mark.parametrize("cell", ["sift1m-ivfpq.np64-b128", "sift1m-ivfpq.np8-b10k",
                                  "sift1m-ivfpq.build-1m"])
def test_each_cell_reports_setup_and_one_more(bench, cell):
    names = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
    assert "setup_s" in names and len(names) >= 2
    assert spec.cell_metrics(bench, cell, "per_layer", names)


def test_a_new_cell_is_new_files_only(tmp_path):
    """A later cell is a workload file (and a configuration file) that the
    harness finds by name, with no edit to any file that is here."""
    cfg = spec.load_json("configs", "sift1m-ivf1024-pq8")
    cfg["name"] = "sift1m-other"
    (tmp_path / "sift1m-other.json").write_text(json.dumps(cfg))
    wl = {"name": "sift1m-ivfpq.np16-b32", "config": "sift1m-other", "chips": 1,
          "driver": "search_closed_loop",
          "traffic": {"batch": 32, "k": 10, "nprobe": 16, "distinct_batches": 4,
                      "warmup_calls": 1, "check_calls": 2},
          "limits": {}, "tiny": {"batch": 8}}
    (tmp_path / "sift1m-ivfpq.np16-b32.json").write_text(json.dumps(wl))
    got, got_cfg = spec.load_cell("sift1m-ivfpq.np16-b32", dirs=[tmp_path], tiny=True)
    assert got["traffic"]["batch"] == 8 and got["traffic"]["nprobe"] == 16
    assert got_cfg["name"] == "sift1m-other"
    (tmp_path / "host_ms_per_batch.other.py").write_text("def read(t):\n    return None\n")
    assert spec.load_metric("host_ms_per_batch.other", dirs=[tmp_path]).read(None) is None
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no-such-cell")
