"""BENCHMARK.json against the benchmark's contract: every configuration,
cell and metric has its file, every file a cell names by name (scene,
texture, camera, entry point) is there and reads every key it is
given, and every name and unit keeps to the allowed characters."""

import json
import re

from conftest import BENCH, ROOT
from benchlib import drivers, harness, inputs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and 1 <= M["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in M["command"])
    assert (ROOT / M["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_files():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_cell_reports_what_its_metrics_move():
    cells = [w["name"] for w in M["workloads"]]
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = (ROOT / "PERF.md").read_text()
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        own = [m for m in M["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(own) >= 2
        assert any(cell in m["workloads"] for m in M["per_layer"])


def test_every_cell_finds_its_parts_by_name():
    """Each cell's configuration and traffic load through the harness
    (unknown keys and unsupported values are refused there), and the
    parts they name are files of their own."""
    for w in M["workloads"]:
        cell = harness.find_cell(ROOT, w["name"])
        cfg = cell.config
        inputs.validate(cfg)
        assert (BENCH / "scenes" / f"{cfg['scene']['generator']}.py").is_file()
        assert (BENCH / "cameras" / f"{cfg['camera']['kind']}.py").is_file()
        if "texture" in cfg:
            assert (BENCH / "textures"
                    / f"{cfg['texture']['generator']}.py").is_file()
        assert (BENCH / "entries" / f"{cell.traffic['entry']}.py").is_file()
        assert drivers.load(cell.traffic).KEYS >= (
            set(cell.traffic) - drivers.COMMON_KEYS)
