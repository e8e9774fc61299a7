"""The benchmark's files: BENCHMARK.json against its format, every
configuration and mix loading into the program's ``SweepGrid``, and a
cell, a mix and a metric added as files alone being found."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return cells.load_spec(ROOT)


def test_benchmark_json_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"]
    names = ([c["name"] for c in s["configs"]]
             + [w["name"] for w in s["workloads"]]
             + [m["name"] for m in s["end_to_end"] + s["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert {m["name"] for m in s["end_to_end"]} >= {"setup_s", "sweep_s"}
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_every_cell_reports_the_metrics_it_must():
    """setup_s, another end-to-end metric, a per-layer metric; and each
    per-layer metric's cells report the end-to-end metric it moves."""
    s = spec()
    for w in s["workloads"]:
        cell = cells.find_cell(s, ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def _names(kind):
    return sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, kind))
                  if f.endswith(".json"))


@pytest.mark.parametrize("config", _names("configs"))
@pytest.mark.parametrize("mix", _names("traffic"))
def test_every_config_and_mix_loads_into_sweep_grid(config, mix):
    """Each configuration file under a mix: the program's ``SweepGrid``
    takes the grid as it stands, with no autotune and every packet."""
    from repro_torch.noc.sweep import SweepGrid
    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        conf = json.load(f)
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        traffic = json.load(f)
    grid = dict(traffic["grid"], models=[conf["model"]])
    g = SweepGrid(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in grid.items()}, device="cpu")
    assert g.tune_path is None and g.max_packets_per_layer is None
    assert conf["model"] in ("lenet", "darknet")
    assert len(conf["input_shape"]) == 3
    assert set(traffic["check"]["limits"]) == {
        "forward_rel_err", "row_mismatches", "shape_mismatches"}


def test_cell_added_as_files_alone_is_found(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    s = spec()
    s["configs"].append({"name": "lenet",
                         "source": "https://arxiv.org/pdf/2509.00500",
                         "file": "portbench/configs/lenet.json",
                         "reduced": [], "why": "LeNet-5, whole"})
    s["workloads"].append({"name": "lenet.o012_small", "config": "lenet",
                           "traffic": "o012_small", "chips": 1,
                           "why": "a cell added as data"})
    s["per_layer"].append({"name": "sweeps_n", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "sweep driver", "moves": "sweep_s",
                           "workloads": ["lenet.o012_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    for c in s["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(ROOT, c["file"]), dst)
    mix = json.loads((bench / "traffic" / "o3_grid.json").read_text())
    mix["grid"]["transforms"] = ["O0", "O1", "O2"]
    (bench / "traffic" / "o012_small.json").write_text(json.dumps(mix))
    (bench / "metrics" / "sweeps_n.py").write_text(
        "def read(ctx):\n    return len(ctx.sweeps)\n")
    cell = cells.find_cell(cells.load_spec(str(tmp_path)), str(tmp_path),
                           "lenet.o012_small", bench_dir=str(bench))
    assert cell.traffic["grid"]["transforms"] == ["O0", "O1", "O2"]
    assert "sweeps_n" in [m["name"] for m in cell.per_layer]
    mod = cells.load_module("metrics", "sweeps_n", bench_dir=str(bench))
    assert mod.read(type("C", (), {"sweeps": [1, 2]})) == 2


def test_no_jax_after_the_harness_pieces_run():
    """The harness, the reference, the readers and the program's sweep
    path load no module named jax, jaxlib, flax or repro (whole top-level
    names; repro_torch is allowed)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch\n"
        "from harness import bench, cells, images, trace\n"
        "from reference import drain, forward, ordering, packets, rows\n"
        "from repro_torch.models import trained_model\n"
        "from repro_torch.noc.sweep import SweepGrid, run_sweep\n"
        "for kind in ('metrics', 'counts'):\n"
        "    import os\n"
        "    for f in os.listdir(os.path.join(%r, kind)):\n"
        "        cells.load_module(kind, f[:-3])\n"
        "tm = trained_model('lenet', 'cpu')\n"
        "img = images.glyph_images(3, 1, 32, 1, torch.device('cpu'))[0]\n"
        "layers = tm.model.layer_traffic(img)\n"
        "g = dict(meshes=['4x4_mc2'], transforms=['O0', 'O1'],\n"
        "         tiebreaks=['pattern'], precisions=['fixed8'],\n"
        "         models=['lenet'], max_packets_per_layer=2, chunk=64)\n"
        "run_sweep(SweepGrid(**g, device='cpu'), lambda m: layers,\n"
        "          devices=None)\n"
        "rows.reference_rows(g, [(l.inputs, l.weights) for l in layers])\n"
        "print(bench.forbidden_modules())\n"
        % (os.path.join(ROOT, "src"), BENCH, BENCH))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            text = open(os.path.join(BENCH, "reference", f)).read()
            assert not re.search(r"^\s*(from|import)\s+(repro|jax|flax)",
                                 text, re.M), f


def test_run_without_a_card_or_the_program_exits_nonzero(tmp_path):
    """Run in a directory that holds only BENCHMARK.json and the
    benchmark's files: no result, a non-zero exit."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         spec()["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
