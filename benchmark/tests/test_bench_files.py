"""BENCHMARK.json and the files it names: everything a cell, a
configuration, a traffic mix or a per-layer metric needs is found by its
name."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    w, cfg, mix, limits = harness.cell_files(cell, SPEC)
    assert w["chips"] == 1
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert (harness.BENCH / "generators" / f"{mix['generator']}.py").is_file()
    assert set(limits["checks"]) == {"pos_gap_p999_m", "vel_gap_p999_mps",
                                     "far_rows", "failed_chunks"}
    assert limits["checks"]["failed_chunks"] == 0
    assert limits["far_pos_m"] > 0
    reported = {e["name"] for e in harness.cell_metrics(cell, SPEC,
                                                          "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    layers = harness.cell_metrics(cell, SPEC, "per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_found_by_name(metric):
    reader = harness.load_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.LAYER == metric["layer"]
    assert reader.MOVES == metric["moves"]
    assert callable(reader.read)


def test_config_files_under_paths():
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
