"""BENCHMARK.json as the benchmark's contract states it: its keys, the
characters of every name and unit, each metric's reader, each cell's
configuration, traffic and limits files, and what every cell reports."""

import json
import os
import re

import pytest

from portbench import spec

ROOT = spec.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH_CHARS = re.compile(r"[A-Za-z0-9_./-]+")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    assert _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("portbench/")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] == []


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.fullmatch(entry[key])
    assert _line(entry["why"]) and entry["chips"] in (1, 4)
    cell = spec.load_cell(entry["name"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert set(cell.limits)                      # some number is compared
    for m in cell.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_metric(entry):
    assert NAME.fullmatch(entry["name"]) and UNIT.fullmatch(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    reader = spec.load_reader(entry["name"])
    assert callable(reader.read)
    if entry in BENCH["end_to_end"]:
        assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert _line(entry["layer"])
    if entry["name"].endswith("_roofline") or "_roofline." in entry["name"]:
        assert entry["unit"] == "%"


def test_names_are_unique_and_four_chip_cells_are_few():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_files_are_named_from_name_characters():
    for base, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH_CHARS.fullmatch(rel) and len(rel) <= 200, rel
