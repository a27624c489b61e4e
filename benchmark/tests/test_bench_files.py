"""The benchmark's files: every cell, configuration, traffic mix, limit and
metric loads by its name, the names and units keep the character rules,
and a new cell, configuration, traffic mix or metric is new files and
entries only."""

import json
import re
import shutil

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    assert c.chips == 1
    assert harness.driver_class(c).units in ("views", "steps")
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and all(m["moves"] in names for m in c.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        # each cell that reports it reports the metric it moves
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_config_files_state_their_sizes():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["encoder"]["embed_dim"] // cfg["encoder"]["num_heads"] == 64
        assert cfg["decoder"]["embed_dim"] // cfg["decoder"]["num_heads"] == 64


def test_a_new_cell_is_files_and_entries(tmp_path, monkeypatch):
    """A cell with a new configuration, traffic mix, limits and metric,
    added as files beside a copy of the benchmark and entries in its
    BENCHMARK.json, loads without any file of the copy changed."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    src = root / "benchmark"
    cfg = harness.load_json(src / "configs" / "must3r_512.json")
    cfg["name"] = "must3r_512_wide"
    (src / "configs" / "must3r_512_wide.json").write_text(json.dumps(cfg))
    mix = harness.load_json(src / "traffic" / "bulk8x10.json")
    mix["n_scenes"] = 4
    (src / "traffic" / "bulk4x10.json").write_text(json.dumps(mix))
    (src / "limits" / "new_cell.json").write_text(json.dumps({"pts3d": 1}))
    (src / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({**bench["configs"][0], "name": "must3r_512_wide",
                             "file": "benchmark/configs/must3r_512_wide.json"})
    bench["workloads"].append({"name": "new_cell", "config": "must3r_512_wide",
                               "traffic": "bulk4x10", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "views_per_s",
                               "workloads": ["new_cell"]})
    bench["end_to_end"][0]["workloads"].append("new_cell")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH_DIR", src)
    cell = harness.load_cell("new_cell", bench)
    assert cell.traffic["n_scenes"] == 4
    assert cell.config["name"] == "must3r_512_wide"
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert harness.read_metrics(cell.per_layer[-1:], None, object()) == {
        "new_metric": {"value": 42.0, "unit": "%"}}
