"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's entry names its file, the mix is
``traffic/<mix>.json``, a per-layer metric is ``metrics/<name>.py`` and a
work count ``counts/<name>.py``, all under this benchmark's directory. A
later cell, mix, metric or count is new files and entries, found with no
edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    workload: dict          # the BENCHMARK.json entry
    config: dict            # the configuration file, parsed
    traffic: dict           # traffic/<mix>.json, parsed
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]   # and with --trace 1


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, root: str, name: str,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration and mix
    loaded (``root`` is the checkout, which holds BENCHMARK.json;
    ``bench_dir`` the benchmark's directory)."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, w, config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """``<kind>/<name>.py`` under the benchmark, as a fresh module."""
    path = os.path.join(bench_dir, kind, name + ".py")
    mod_name = f"portbench_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_peaks() -> Dict[str, float]:
    """The published peaks the shares are taken of (``peaks.json``)."""
    with open(os.path.join(BENCH_DIR, "peaks.json")) as f:
        return json.load(f)
