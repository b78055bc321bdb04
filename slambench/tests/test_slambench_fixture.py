"""A later PR adds a configuration, a cell and a per-layer metric as files
only: the harness finds each by the name that BENCHMARK.json gives it, and
no harness file names a configuration, traffic or cell."""

import json
import shutil
from pathlib import Path

from slambench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slambench"


def _tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "slambench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    return bench


def test_a_new_configuration_cell_and_metric_are_files_only(tmp_path):
    bench = _tree(tmp_path)
    cfg = json.loads((bench / "configs" / "fr1_xyz.json").read_text())
    cfg["name"] = "fr2_dummy"
    cfg["recording_frames"] = 12
    (bench / "configs" / "fr2_dummy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "burst4.json").write_text(json.dumps({"mode": "offline", "chunk": 4}))
    (bench / "metrics" / "frames_seen.py").write_text(
        "def read(trace):\n    return trace.window.frames or None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "fr2_dummy", "source": "https://example.org/fr2",
                         "file": "slambench/configs/fr2_dummy.json", "reduced": [], "why": "x"})
    m["workloads"].append({"name": "fr2_dummy.burst4", "config": "fr2_dummy",
                           "traffic": "burst4", "chips": 1, "why": "x"})
    m["end_to_end"][2]["workloads"].append("fr2_dummy.burst4")
    m["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "entry",
                           "moves": "frames_per_s", "workloads": ["fr2_dummy.burst4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    manifest = run.load_manifest(tmp_path)
    cell = run.cell_spec(manifest, "fr2_dummy.burst4")
    assert [e["name"] for e in cell["end_to_end"]] == ["frames_per_s", "setup_s"]
    assert [p["name"] for p in cell["per_layer"]] == ["frames_seen"]
    assert run.read_json("configs", cell["config"], bench)["recording_frames"] == 12
    assert run.read_json("traffic", cell["traffic"], bench)["chunk"] == 4
    reader = run.load_reader("frames_seen", bench)

    class W:
        frames = 12

    assert reader(run.TraceData(W, None, None)) == 12
    # the cells already there are untouched
    assert [p["name"] for p in run.cell_spec(manifest, "fr1_xyz.offline")["per_layer"]] == [
        p["name"] for p in run.cell_spec(run.load_manifest(), "fr1_xyz.offline")["per_layer"]]


def test_every_metric_file_reads_nothing_from_an_empty_trace():
    class W:
        frames, host_track_ms, track_ms, background_ms, device_ms = 0, [], [], [], 0.0

    for f in sorted((BENCH / "metrics").glob("*.py")):
        assert run.load_reader(f.stem)(run.TraceData(W, None, None)) is None, f.name


def test_no_harness_file_names_a_cell():
    m = run.load_manifest()
    names = ({c["name"] for c in m["configs"]} | {w["name"] for w in m["workloads"]}
             | {w["traffic"] for w in m["workloads"]})
    for f in ("run.py", "kernels.py", "readings.py", "reference.py", "scene.py"):
        text = (BENCH / f).read_text()
        for n in names:
            assert f'"{n}"' not in text and f"'{n}'" not in text, (f, n)
