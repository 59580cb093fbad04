"""BENCHMARK.json keeps to the contract, and every cell's files are found
by name; a cell made of new files alone is found the same way."""

import json
import os
import re
import shutil

import pytest

from hevc_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def manifest(root):
    return harness.Manifest(root)


def test_keys_and_names(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["hevc_bench"]
    assert 1 <= d["run_seconds"] <= 51
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("hevc_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_finds_its_files(manifest, trace):
    for name, cell in manifest.cells.items():
        conf = manifest.config(cell["config"])
        assert conf["name"] == cell["config"]
        traffic = manifest.traffic(cell["traffic"])
        assert traffic["name"] == cell["traffic"]
        metrics = manifest.metrics(name, bool(trace))
        assert metrics, name
        for m in metrics:
            assert callable(manifest.reader(m["name"]).read)
    for name in manifest.cells:
        e2e = {m["name"] for m in manifest.metrics(name, False)}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_a_cell_from_new_files_alone(root, tmp_path):
    new = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "hevc_bench"), new / "hevc_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    d = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    conf = json.loads((new / "hevc_bench/configs/ldp_1080p_fastest.json")
                      .read_text())
    conf["name"] = "ldp_720p_fastest"
    conf["encoder"].update(width=1280, height=720)
    (new / "hevc_bench/configs/ldp_720p_fastest.json").write_text(
        json.dumps(conf))
    traffic = json.loads((new / "hevc_bench/traffic/batch.json").read_text())
    traffic.update(name="long_segments", segment_frames=64, check_frames=64)
    (new / "hevc_bench/traffic/long_segments.json").write_text(
        json.dumps(traffic))
    (new / "hevc_bench/metrics/frames_per_call.py").write_text(
        "def read(run):\n    return run.window_frames / len(run.calls)\n")
    d["configs"].append(dict(name="ldp_720p_fastest", source="made up",
                             file="hevc_bench/configs/ldp_720p_fastest.json",
                             reduced=[], why="a test"))
    d["workloads"].append(dict(name="ldp_720p_fastest.long_segments",
                               config="ldp_720p_fastest",
                               traffic="long_segments", chips=1, why="a test"))
    d["per_layer"].append(dict(name="frames_per_call", unit="frames",
                               better="higher", source="program_counter",
                               layer="session", moves="fps"))
    (new / "BENCHMARK.json").write_text(json.dumps(d))
    m = harness.Manifest(str(new))
    cell = m.cell("ldp_720p_fastest.long_segments")
    assert m.config(cell["config"])["encoder"]["width"] == 1280
    assert m.traffic(cell["traffic"])["segment_frames"] == 64
    names = [x["name"] for x in m.metrics(cell["name"], True)]
    assert "frames_per_call" in names
    run = type("R", (), dict(window_frames=128, calls=[0, 0]))()
    assert m.reader("frames_per_call").read(run) == 64
