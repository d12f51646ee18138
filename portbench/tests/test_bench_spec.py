"""BENCHMARK.json and the files it names: every cell finds its
configuration, mix, metric readers and limits by name, and the entries
keep to the contract's characters, sizes and budget."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    # the check's budget holds with the most cells later PRs may add
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert cells <= 24


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_parts(cell):
    c = spec.find_cell(cell)
    assert c.mix["kind"] in ("serve",)
    assert c.config["name"] == c.config_name
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    with open(spec.HERE / "limits" / f"{cell}.json") as f:
        assert json.load(f)["limits"]


def test_names_units_and_sources():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    with open(spec.ROOT / conf["file"]) as f:
        data = json.load(f)
    assert conf["file"].startswith("portbench/")
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    widths = ("hidden_size", "intermediate_size", "head_size",
              "num_attention_heads", "num_key_value_heads")
    assert not set(conf["reduced"]) & set(widths)


def test_every_metric_reader_is_used():
    used = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (spec.HERE / "metrics").glob("*.py")}
    assert used <= files
