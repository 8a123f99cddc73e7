"""BENCHMARK.json against the benchmark's shape rules, and every file a
cell needs found by name."""

import json
import re

from portbench import harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in MAN[kind]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    for text in [c["source"] for c in MAN["configs"]] + [
            x["why"] for x in MAN["configs"] + MAN["workloads"]] + [
            m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_per_layer_metric_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        cell = harness.CellSpec(w["name"])
        e2e = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics("per_layer")


def test_every_cells_files_are_found_by_name():
    for w in MAN["workloads"]:
        cell = harness.CellSpec(w["name"])
        assert cell.system_path.is_file()
        assert cell.reference_path.is_file()
        assert (harness.BASE / "traffic" / f"{w['traffic']}.json").is_file()
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert cell.metric_path(m["name"]).is_file()
        assert "limits" in cell.config


def test_config_files_match_their_entries():
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced_from"])


def test_command_and_paths():
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
