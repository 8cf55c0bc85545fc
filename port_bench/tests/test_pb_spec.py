"""BENCHMARK.json against the contract's form: names and units of the
allowed characters, each entry's keys, and the files a cell is found by."""

import importlib
import json
import re

from port_bench.spec import ROOT, load_json

REPO = ROOT.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(names) == len(set(names))


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == load_json(c["file"].split("/", 1)[1])["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"] == "setup_s" or m["workloads"]
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["workloads"]


def test_every_cell_finds_its_files():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        tr = load_json(f"traffic/{w['traffic']}.json")
        importlib.import_module(f"port_bench.drivers.{tr['driver']}")
        assert (ROOT / "limits" / f"{w['name']}.json").exists()
        reported = {n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in reported for m in layer)
    for m in SPEC["per_layer"]:
        reader = importlib.import_module(
            f"port_bench.metrics.{m['name'].split('.', 1)[0]}")
        assert callable(reader.read)
