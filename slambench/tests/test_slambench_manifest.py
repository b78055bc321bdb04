"""BENCHMARK.json against the benchmark's contract: names, units and lengths,
the files each entry names, and which cells report each metric."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slambench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_run_seconds_fits_the_check_with_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("slambench/") and (ROOT / cfg["file"]).is_file()
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data and key in data["reduced"]
    assert set(data["reduced"]) == set(cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in M["workloads"])
    assert set(data["limits"]) == {"untracked", "ate_cm", "orb_bad_pct", "reproj_px_p50"}


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert NAME.match(cell["traffic"]) and (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert cell["config"] in {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in M["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, cell) for m in M["per_layer"])


def test_end_to_end_metrics():
    assert 1 <= len(M["end_to_end"]) <= 16
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = next(m for m in M["end_to_end"] if m["name"] == metric["moves"])
    for cell in [c for c in CELLS if _reports(metric, c)]:
        assert _reports(moved, cell), f"{metric['name']} moves {moved['name']}, not in {cell}"
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in M["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, f"PERF.md's list of layers lacks {layer!r}"


def test_command_names_nothing_outside_paths():
    assert M["command"][:3] == ["python3", "-m", "slambench.run"]
    for word in M["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
