"""Finding a cell's parts by name: ``BENCHMARK.json``'s entries, the
configuration file, the traffic mix and the metric readers.

A configuration file holds the published ``config.json`` keys at its top
level (as they are run: a changed key is listed in ``reduced``) and, beside
them, ``architecture`` (its module under ``archs/``: shapes, parameter
layout, FLOPs, the program's configuration, the plain reference),
``serving`` (the session a deployment of it runs)
and notes. A mix file holds the traffic: its ``kind`` picks the driver
(``serve``: ``serving.py``), the rest are its parameters. A metric is
``metrics/<name>.py`` with one function, ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    config_name: str
    config: dict  # the configuration file
    mix_name: str
    mix: dict  # the mix file
    chips: int
    end_to_end: list  # the metric entries this cell reports, trace 0
    per_layer: list  # and with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf_entry = confs[w["config"]]
    with open(ROOT / conf_entry["file"]) as f:
        conf = json.load(f)
    return Cell(name=name, config_name=w["config"], config=conf,
                mix_name=w["traffic"], mix=load_mix(w["traffic"]),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_mix(name: str) -> dict:
    with open(HERE / "mixes" / f"{name}.json") as f:
        return json.load(f)


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py`` (a name may hold dots, so the
    file is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def serving_options(cell: Cell) -> dict:
    """The session a cell runs: the configuration's deployment, with the
    mix's ``serving`` keys over it."""
    opts = dict(cell.config.get("serving", {}))
    opts.update(cell.mix.get("serving", {}))
    return opts


def arch(conf: dict):
    """The module of the configuration's ``architecture``
    (``archs/<architecture>.py``); an unknown one raises."""
    from portbench import archs

    return archs.get(conf["architecture"])
