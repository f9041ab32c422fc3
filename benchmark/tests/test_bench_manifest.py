"""BENCHMARK.json against the benchmark's contract and its files: names and
units from their character sets, every cell's files, every metric's reader
and the cells it lists, each of which reports the metric it moves."""

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]] \
        + [w["name"] for w in manifest["workloads"]] \
        + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_configs_match_their_files(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["var"]["embed_dim"] == 64 * data["var"]["depth"]


def test_cells_have_their_files(manifest):
    used = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        cell = cells.workload(w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in manifest["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_cell_reports_setup_and_its_metric(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in manifest["workloads"]:
        metric = cells.driver(cells.workload(w["name"])["driver"]).METRIC
        assert w["name"] in e2e[metric].get("workloads", [w["name"]])


def test_every_per_layer_metric_has_its_reader(manifest):
    readers = {m.NAME: m for m in cells.metric_modules()}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        r = readers[m["name"]]
        assert (r.LAYER, r.UNIT, r.BETTER, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert _line(m["layer"])
        for w in m["workloads"]:
            cell = cells.workload(w)
            assert cell["driver"] in r.DRIVERS
            assert getattr(r, "KV", cell["traffic"].get("kv")) \
                == cell["traffic"].get("kv")
            assert cells.driver(cell["driver"]).METRIC == m["moves"]
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"].split()[0], set()).add(m["layer"])
    assert set(readers) == {m["name"] for m in manifest["per_layer"]}


def test_roofline_and_mfu_are_percent(manifest):
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
